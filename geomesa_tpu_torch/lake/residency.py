"""Row-group residency across the chunks of one pushdown join.

Copy of ``geomesa_tpu/lake/residency.py``. The join's window-pushdown
count re-scans the right side once per chunk of left cells; adjacent
chunks' windows overlap by the join's reach, so row groups on a chunk
boundary survive pruning in both chunks. A :class:`GroupResidencyCache`
spans the chunk loop and serves a decoded chunk, keyed by (snapshot dir,
prefixed column, row group), from memory on its second use. A hit returns
the same bytes a decode would (a snapshot file is immutable while the
join holds its plans), so counts are identical with the cache on, off or
evicting. Cached arrays are read-only.

The budget is ``geomesa.join.pushdown.residency.mb`` of decoded bytes
(LRU; 0 disables). Hits and the encoded bytes they saved reach
``JoinStats.pushdown`` as ``residency_hits`` / ``bytes_saved_residency``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config

_Key = Tuple[str, str, int]


class GroupResidencyCache:
    """LRU over decoded per-group arrays, bounded by decoded bytes. The
    prefetch worker and the query thread may both fetch: a lock guards
    the map."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._rows: "OrderedDict[_Key, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.held_bytes = 0
        self.hits = 0
        #: encoded blob bytes not read again thanks to hits
        self.bytes_saved = 0
        self.evictions = 0

    @classmethod
    def from_config(cls) -> Optional["GroupResidencyCache"]:
        mb = config.JOIN_PUSHDOWN_RESIDENCY_MB.to_int()
        mb = 64 if mb is None else int(mb)
        return cls(mb << 20) if mb > 0 else None

    def fetch(self, dir_: str, name: str, gi: int, ref, file) -> np.ndarray:
        """The decoded array of blob ``ref`` of group ``gi``, from the
        cache or decoded by ``file.read_array`` (then kept, read-only)."""
        key = (dir_, name, int(gi))
        with self._lock:
            arr = self._rows.get(key)
            if arr is not None:
                self._rows.move_to_end(key)
                self.hits += 1
                self.bytes_saved += int(file.blob_nbytes(ref))
                return arr
        arr = file.read_array(ref)
        arr.setflags(write=False)
        with self._lock:
            if key not in self._rows:
                self._rows[key] = arr
                self.held_bytes += int(arr.nbytes)
                while self.held_bytes > self.budget and len(self._rows) > 1:
                    _, old = self._rows.popitem(last=False)
                    self.held_bytes -= int(old.nbytes)
                    self.evictions += 1
        return arr
