"""Explain tree: an indented push/pop log, surfaced by
``GeoDataset.explain`` and ``GeoDataset.explain_join``.

Copy of ``geomesa_tpu/planning/explain.py`` (the reference's
``Explainer``, geomesa-index-api/.../utils/Explainer.scala).
"""

from __future__ import annotations

from typing import List


class Explainer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lines: List[str] = []
        self._depth = 0

    def line(self, msg: str) -> "Explainer":
        if self.enabled:
            self._lines.append("  " * self._depth + str(msg))
        return self

    def push(self, msg: str) -> "Explainer":
        self.line(msg)
        self._depth += 1
        return self

    def pop(self) -> "Explainer":
        self._depth = max(0, self._depth - 1)
        return self

    def kv(self, key: str, value) -> "Explainer":
        """One `key: value` line."""
        return self.line(f"{key}: {value}")

    def __str__(self) -> str:
        return "\n".join(self._lines)
