"""Cell-heat table: per-(schema, SFC cell) access heat.

Copy of ``geomesa_tpu/heat.py``'s table (its fleet merge is not ported).
The aggregate cache's cell loop
(``cache/service.py``) records a hit or a miss for every cell lookup, and
a miss carries the scan's wall-clock milliseconds. The table holds at most
``geomesa.heat.cells`` rows (the coldest by touches evict first, counted
in ``heat.evicted``), and a snapshot returns the ``geomesa.heat.top``
hottest rows per schema.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from geomesa_tpu_torch import config, metrics

#: (schema, "z<level>:<prefix>") -> [hits, misses, device_ms, touches]
_Key = Tuple[str, str]


class HeatTable:
    def __init__(self, max_cells: Optional[int] = None):
        self._rows: Dict[_Key, List[float]] = {}
        self._lock = threading.Lock()
        self._max = max_cells

    def _cap(self) -> int:
        if self._max is not None:
            return self._max
        v = config.HEAT_CELLS_MAX.to_int()
        return 4096 if v is None else int(v)

    def record(self, schema: str, level: int, prefix,
               hit: int = 0, miss: int = 0,
               device_ms: float = 0.0) -> None:
        cap = self._cap()
        if cap <= 0:
            return
        key = (schema, f"z{int(level)}:{prefix}")
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                if len(self._rows) >= cap:
                    # evict the coldest row by touches: one scan, only on
                    # an insert past the bound
                    coldest = min(self._rows, key=lambda k: self._rows[k][3])
                    del self._rows[coldest]
                    metrics.inc(metrics.HEAT_EVICTED)
                row = self._rows[key] = [0, 0, 0.0, 0]
            row[0] += hit
            row[1] += miss
            row[2] += device_ms
            row[3] += 1
            metrics.registry().gauge(metrics.HEAT_CELLS).set(len(self._rows))

    def snapshot(self, top: Optional[int] = None) -> Dict[str, List[dict]]:
        """Per-schema hottest rows, by touches (hits + misses) descending;
        ``device_ms`` carries the cost weight."""
        if top is None:
            t = config.HEAT_TOP.to_int()
            top = 256 if t is None else int(t)
        with self._lock:
            items = [(k, list(v)) for k, v in self._rows.items()]
        out: Dict[str, List[dict]] = {}
        for (schema, cell), (hits, misses, dev_ms, touches) in items:
            out.setdefault(schema, []).append({
                "cell": cell, "hits": int(hits), "misses": int(misses),
                "device_ms": round(float(dev_ms), 3),
                "touches": int(touches),
            })
        for schema in out:
            out[schema].sort(key=lambda r: (-r["touches"], r["cell"]))
            if top > 0:
                del out[schema][top:]
        return out

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


_TABLE = HeatTable()


def record(schema: str, level: int, prefix, hit: int = 0,
           miss: int = 0, device_ms: float = 0.0) -> None:
    _TABLE.record(schema, level, prefix, hit=hit, miss=miss,
                  device_ms=device_ms)


def snapshot(top: Optional[int] = None) -> Dict[str, Any]:
    return _TABLE.snapshot(top)


def reset() -> None:
    _TABLE.reset()
