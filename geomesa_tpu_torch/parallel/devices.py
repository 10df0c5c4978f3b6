"""The partitioned scan's merge order.

Copy of ``tree_merge`` and ``TreeReducer`` from
``geomesa_tpu/parallel/devices.py``: partials merge in one fixed balanced
association of their pruned-bin order, so float grids add up in the same
order as the JAX package's. The device fan-out of that module waits for
ROADMAP Queue 1's multi-GPU item.
"""

from __future__ import annotations

from typing import List


def tree_merge(parts, combine):
    """Fixed balanced pairwise reduction of ``parts`` (None = empty): with
    ``[p0, p1, p2, p3, p4]`` in pruned-bin order, round 1 combines adjacent
    pairs left to right, ``(p0+p1), (p2+p3), p4``, and rounds repeat until
    one remains: ``((p0+p1)+(p2+p3)) + p4``."""
    items = [p for p in parts if p is not None]
    if not items:
        return None
    while len(items) > 1:
        nxt = [combine(items[j], items[j + 1]) for j in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


class TreeReducer:
    """Streaming :func:`tree_merge`: push partials in pruned-bin order and
    :meth:`result` gives the same association while holding O(log n)
    partials. A pushed value combines with the stack top while both sit at
    the same level; the leftover stack folds lowest level first."""

    def __init__(self, combine):
        self.combine = combine
        self._stack: List = []  # (level, value), levels strictly decreasing

    def push(self, v) -> None:
        if v is None:
            return
        lvl = 0
        while self._stack and self._stack[-1][0] == lvl:
            _, u = self._stack.pop()
            v = self.combine(u, v)
            lvl += 1
        self._stack.append((lvl, v))

    def result(self):
        if not self._stack:
            return None
        vals = [v for _, v in self._stack]
        v = vals[-1]
        for u in reversed(vals[:-1]):
            v = self.combine(u, v)
        return v
