"""Size-aware LRU store of cached aggregate results.

Copy of ``geomesa_tpu/cache/store.py``. One object holds every feature
store's entries, partitioned by the store's process-unique ``uid``, so
budgets and invalidation are per schema (the LRU budget applies to each
uid). Entries live under a dataset epoch (the FeatureStore ``version``,
bumped by every mutation path): an access with another epoch drops all of
that store's entries at once, so a cached cell never survives a write it
cannot see.

Values are host objects (ints, floats, stat JSON strings, numpy arrays,
tuples of these), never device tensors, so the byte budget counts what
they hold. Thread-safe; the counts go to the process registry
(``metrics.py``: ``cache.*``).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from geomesa_tpu_torch import config, metrics

#: every live CacheStore: the process-wide cache.bytes / cache.entries
#: gauges sum over them
_STORES: "weakref.WeakSet[CacheStore]" = weakref.WeakSet()


def _gauge_total(attr: str) -> float:
    return float(sum(getattr(s, attr) for s in list(_STORES)))


def value_nbytes(value: Any) -> int:
    """Approximate resident size of a cached value."""
    import numpy as np

    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (bytes, str)):
        return len(value)
    if isinstance(value, tuple):
        return sum(value_nbytes(v) for v in value)
    return 32  # ints / floats / small scalars


class CacheStore:
    """Per-dataset, epoch-keyed, size-aware LRU."""

    def __init__(self, budget_bytes: Optional[int] = None):
        #: uid -> OrderedDict[key, (value, nbytes)] in LRU order
        self._data: Dict[int, "OrderedDict[Tuple, Tuple[Any, int]]"] = {}
        self._bytes: Dict[int, int] = {}
        self._epoch: Dict[int, int] = {}
        self._budget = budget_bytes
        self._lock = threading.Lock()
        _STORES.add(self)
        # the gauges sum over _STORES, never one captured store; each init
        # builds a fresh lambda, so the swap is explicit (replace=True)
        reg = metrics.registry()
        reg.gauge(metrics.CACHE_BYTES,
                  lambda: _gauge_total("total_bytes"), replace=True)
        reg.gauge(metrics.CACHE_ENTRIES,
                  lambda: _gauge_total("total_entries"), replace=True)

    # -- budgets -----------------------------------------------------------
    def budget(self) -> int:
        if self._budget is not None:
            return self._budget
        b = config.CACHE_BUDGET_BYTES.to_int()
        return b if b is not None else int(config.CACHE_BUDGET_BYTES.default)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._bytes.values())

    @property
    def total_entries(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._data.values())

    # -- epoch invalidation ------------------------------------------------
    def _sync_epoch(self, uid: int, epoch: int) -> None:
        """Drop every entry of ``uid`` when its epoch moved (the caller
        holds the lock): any mismatch, not only growth, is stale."""
        cur = self._epoch.get(uid)
        if cur is None:
            self._epoch[uid] = epoch
            return
        if cur != epoch:
            dropped = len(self._data.get(uid, ()))
            self._data.pop(uid, None)
            self._bytes.pop(uid, None)
            self._epoch[uid] = epoch
            if dropped:
                metrics.inc(metrics.CACHE_INVALIDATE, dropped)

    # -- access ------------------------------------------------------------
    def get(self, uid: int, epoch: int, key: Tuple) -> Optional[Any]:
        with self._lock:
            self._sync_epoch(uid, epoch)
            d = self._data.get(uid)
            if d is None:
                return None
            hit = d.get(key)
            if hit is None:
                return None
            d.move_to_end(key)
            return hit[0]

    def put(self, uid: int, epoch: int, key: Tuple, value: Any) -> bool:
        nbytes = value_nbytes(value)
        budget = self.budget()
        if nbytes > budget:
            return False  # a single over-budget entry would evict everything
        with self._lock:
            self._sync_epoch(uid, epoch)
            d = self._data.setdefault(uid, OrderedDict())
            old = d.pop(key, None)
            if old is not None:
                self._bytes[uid] = self._bytes.get(uid, 0) - old[1]
            d[key] = (value, nbytes)
            self._bytes[uid] = self._bytes.get(uid, 0) + nbytes
            metrics.inc(metrics.CACHE_PUT)
            while self._bytes.get(uid, 0) > budget and d:
                _, (_, sz) = d.popitem(last=False)
                self._bytes[uid] -= sz
                metrics.inc(metrics.CACHE_EVICT)
            return True

    # -- persistence (lake/persist.py) ---------------------------------------
    def export_uid(self, uid: int,
                   limit: Optional[int] = None) -> Tuple[Optional[int], list]:
        """Snapshot one store's entries for persistence: ``(epoch,
        [(key, value), ...])`` in LRU order (coldest first, so a
        budget-capped restore keeps the hottest). ``limit`` keeps only the
        hottest ``limit`` entries. Values are shared references: callers
        treat them as read-only."""
        with self._lock:
            d = self._data.get(uid)
            epoch = self._epoch.get(uid)
            if not d:
                return epoch, []
            items = [(k, v[0]) for k, v in d.items()]
        if limit is not None and len(items) > limit:
            items = items[-limit:]  # LRU order: the tail is the hottest
        return epoch, items

    def import_entries(self, uid: int, epoch: int, items) -> int:
        """Restore persisted entries under ``(uid, epoch)``, the live
        store's current epoch, so invalidation keeps guarding later
        mutations. The budget applies as for fresh puts. Returns the
        number of entries admitted."""
        n = 0
        for key, value in items:
            if self.put(uid, epoch, key, value):
                n += 1
        if n:
            metrics.inc(metrics.CACHE_PERSIST_RESTORED, n)
        return n

    def invalidate(self, uid: Optional[int] = None) -> None:
        """Explicit drop — all datasets, or one."""
        with self._lock:
            if uid is None:
                dropped = sum(len(d) for d in self._data.values())
                self._data.clear()
                self._bytes.clear()
                self._epoch.clear()
            else:
                dropped = len(self._data.get(uid, ()))
                self._data.pop(uid, None)
                self._bytes.pop(uid, None)
                self._epoch.pop(uid, None)
            if dropped:
                metrics.inc(metrics.CACHE_INVALIDATE, dropped)

    def export_wire(self, uid: int,
                    limit: Optional[int] = None) -> Tuple[Optional[int],
                                                          list]:
        """:meth:`export_uid` in the JSON-safe wire shape of the reference's
        fleet handoff: ``(epoch, [[key_repr, encoded_value], ...])``,
        hottest last. Entries whose key does not survive the repr round
        trip, or whose value has no wire encoding, are skipped one by one
        (the persistence rule)."""
        import ast

        epoch, items = self.export_uid(uid, limit=limit)
        out = []
        for key, value in items:
            kr = repr(key)
            try:
                if ast.literal_eval(kr) != key:
                    continue
            except (ValueError, SyntaxError):
                continue
            enc = encode_wire_value(value)
            if enc is not None:
                out.append([kr, enc])
        return epoch, out

    def import_wire(self, uid: int, epoch: int, entries) -> int:
        """Admit :meth:`export_wire` entries under ``(uid, epoch)``, the
        receiving store's current epoch, as :meth:`import_entries` does."""
        items = []
        import ast

        for key_repr, enc in entries:
            try:
                items.append((ast.literal_eval(key_repr),
                              decode_wire_value(enc)))
            except (ValueError, SyntaxError, KeyError, TypeError):
                continue  # one bad entry must not fail the handoff
        return self.import_entries(uid, epoch, items)

    def snapshot(self) -> Dict[str, Any]:
        """Operator-facing stats: budget, per-store entries / bytes /
        epoch, and the ``cache.*`` counters."""
        reg = metrics.registry().report()
        with self._lock:
            per_ds = {
                str(uid): {"entries": len(d), "bytes": self._bytes.get(uid, 0),
                           "epoch": self._epoch.get(uid)}
                for uid, d in self._data.items()
            }
        return {
            "enabled": bool(config.CACHE_ENABLED.to_bool()),
            "budget_bytes": self.budget(),
            "datasets": per_ds,
            "counters": {
                k: v for k, v in reg.items() if k.startswith("cache.")
            },
        }


# -- wire value codec ----------------------------------------------------
# The JSON-embeddable sibling of lake/persist.py's container codec: cache
# values are ints / floats / strs (stat JSON) / ndarrays / tuples of them;
# arrays ride base64 with their dtype and shape.

def encode_wire_value(v: Any):
    import base64

    import numpy as np

    if isinstance(v, bool):
        return {"t": "bool", "v": bool(v)}
    if isinstance(v, (int, np.integer)):
        return {"t": "int", "v": int(v)}
    if isinstance(v, (float, np.floating)):
        return {"t": "float", "v": float(v)}
    if isinstance(v, str):
        return {"t": "str", "v": v}
    if isinstance(v, np.ndarray):
        raw = np.ascontiguousarray(v)
        return {"t": "arr", "dtype": str(raw.dtype),
                "shape": list(raw.shape),
                "b64": base64.b64encode(raw.tobytes()).decode()}
    if isinstance(v, tuple):
        items = [encode_wire_value(i) for i in v]
        if any(i is None for i in items):
            return None
        return {"t": "tuple", "items": items}
    return None  # unencodable kind: the caller skips the entry


def decode_wire_value(d) -> Any:
    import base64

    import numpy as np

    t = d["t"]
    if t in ("bool", "int", "float", "str"):
        return d["v"]
    if t == "arr":
        a = np.frombuffer(base64.b64decode(d["b64"]),
                          dtype=np.dtype(d["dtype"]))
        return a.reshape(d["shape"]).copy()  # frombuffer is read-only
    if t == "tuple":
        return tuple(decode_wire_value(i) for i in d["items"])
    raise ValueError(f"unknown wire value type {t!r}")
