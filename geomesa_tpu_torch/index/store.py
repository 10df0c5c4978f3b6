"""Sharded, sorted columnar feature store on one device.

Port of ``geomesa_tpu/index/store.py`` cut to one Z3 index table. The table
is a sort permutation plus its sorted key columns over the store's master
columns; a shard is a contiguous slab of the sort order, padded to a common
length so the stacked [S, L] device columns have one static shape. Host
master columns keep f64 coordinates (the exact values the f32 band
correction needs); the device holds f32 coordinates and the int32 time
pair, never int64 epoch-ms.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.index.keyspace import MAX_SHARD_WINDOWS, KeyPlan, Z3KeySpace
from geomesa_tpu_torch.schema.columns import ColumnBatch, encode_batch
from geomesa_tpu_torch.schema.feature_type import FeatureType

#: padded shard length rounds up to a multiple of this (the reference's
#: geomesa.compact.shard.bucket), so small inserts keep one shape
SHARD_BUCKET = 8192

#: floor of the padded per-shard window count (geomesa.compact.bucket.floor)
WINDOW_BUCKET_FLOOR = 8


def bucket_count(n: int, floor: int = WINDOW_BUCKET_FLOOR) -> int:
    """Pad a per-shard window count to its shape bucket: the next power of
    two, floored at ``floor``."""
    n = 1 if n <= 1 else 1 << (n - 1).bit_length()
    return max(n, floor)


def device_view(a: np.ndarray) -> Optional[np.ndarray]:
    """Host column -> device-eligible array (int32 / float32 / bool), or
    None for host-only columns (64-bit keys)."""
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype in (np.int64, np.uint64):
        return None
    return a


class IndexTable:
    """One index: a sort permutation + sorted key columns over the store's
    master column set. Attribute columns are gathered through ``order`` once
    per device upload."""

    def __init__(self, keyspace: Z3KeySpace, n_shards: int,
                 device: torch.device):
        self.keyspace = keyspace
        self.n_shards = n_shards
        self.device = device
        #: sorted-row -> master-row permutation
        self.order = np.zeros(0, np.int64)
        #: this index's key columns, in sorted order (quantized when
        #: ``key_shifts`` is set)
        self.key_columns: Dict[str, np.ndarray] = {}
        self.key_shifts: Optional[Dict[str, int]] = None
        self._master: Dict[str, np.ndarray] = {}
        self.n = 0
        self.shard_bounds = np.zeros(n_shards + 1, np.int64)
        #: column name -> [S, L] tensor on ``device``
        self._device_cache: Dict[str, torch.Tensor] = {}

    def rebuild(self, columns: Dict[str, np.ndarray]) -> None:
        """Re-sort by the key and re-shard. ``columns`` is the master
        column dict (attributes + key columns)."""
        self.order, self.key_columns, self.key_shifts = self.keyspace.build(columns)
        self.set_state(columns, self.order, self.key_columns, self.key_shifts,
                       np.linspace(0, len(self.order), self.n_shards + 1).astype(np.int64))

    def append_rows(self, columns: Dict[str, np.ndarray],
                    fresh_cols: Dict[str, np.ndarray], n_fresh: int) -> None:
        """LSM append, as the reference's: sort the fresh rows alone, under
        the table's key shifts, and merge them into the existing order at
        their searchsorted insertion positions (O(old + fresh) instead of a
        full re-sort). ``columns`` is the master column dict with the fresh
        rows last; ``fresh_cols`` those rows' columns and keys. Falls back
        to :meth:`rebuild` for an empty table, or when the fresh keys do not
        fit the table's quantization."""
        ks = self.keyspace
        if self.n == 0:
            return self.rebuild(columns)
        if self.key_shifts is not None:
            fb = ks.fast_build(fresh_cols, force_shifts=self.key_shifts)
            if fb is None or fb[2] != self.key_shifts:
                return self.rebuild(columns)
            fresh_order, fresh_sorted, _ = fb
            fresh_order = fresh_order.astype(np.int64, copy=False)
        else:
            fresh_order = np.asarray(ks.sort_order(fresh_cols), np.int64)
            fresh_sorted = {k: fresh_cols[k][fresh_order] for k in self.key_columns}
        at = ks.insert_positions(self.key_columns, fresh_sorted) + np.arange(n_fresh)
        total = self.n + n_fresh
        is_fresh = np.zeros(total, bool)
        is_fresh[at] = True
        order = np.empty(total, np.int32 if total < 2**31 else np.int64)
        order[is_fresh] = self.n + fresh_order  # master rows are [old | fresh]
        order[~is_fresh] = self.order
        keys = {}
        for k, old in self.key_columns.items():
            merged = np.empty(total, old.dtype)
            merged[at] = fresh_sorted[k].astype(old.dtype, copy=False)
            merged[~is_fresh] = old
            keys[k] = merged
        self.set_state(columns, order, keys, self.key_shifts,
                       np.linspace(0, total, self.n_shards + 1).astype(np.int64))

    def set_state(self, master, order, key_columns, key_shifts,
                  shard_bounds) -> None:
        self._master = dict(master)
        self.order = order
        self.key_columns = dict(key_columns)
        self.key_shifts = key_shifts
        self.n = len(order)
        self.shard_bounds = np.asarray(shard_bounds, np.int64)
        if len(self.shard_bounds) != self.n_shards + 1:
            raise ValueError(
                f"{len(self.shard_bounds)} shard bounds for {self.n_shards} shards"
            )
        self._device_cache.clear()

    # -- column access -----------------------------------------------------
    def has_column(self, name: str) -> bool:
        return name in self.key_columns or name in self._master

    def col_sorted(self, name: str) -> np.ndarray:
        """Full host column in sort order (exact master values)."""
        col = self.key_columns.get(name)
        if col is not None:
            return col
        return self._master[name][self.order]

    @property
    def shard_len(self) -> int:
        """Padded per-shard length: the largest shard, rounded up to
        :data:`SHARD_BUCKET`."""
        if self.n == 0:
            return 0
        m = int(np.max(np.diff(self.shard_bounds)))
        return -(-m // SHARD_BUCKET) * SHARD_BUCKET

    def shard_slice(self, s: int) -> slice:
        return slice(int(self.shard_bounds[s]), int(self.shard_bounds[s + 1]))

    def device_columns(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Stacked, padded [S, L] tensors for ``names`` on the table's
        device (cached per column)."""
        L = self.shard_len
        out = {}
        for name in dict.fromkeys(names):
            t = self._device_cache.get(name)
            if t is None:
                view = device_view(self.col_sorted(name))
                if view is None:
                    raise TypeError(f"column {name!r} cannot ride the device")
                stacked = np.zeros((self.n_shards, L), dtype=view.dtype)
                for s in range(self.n_shards):
                    sl = self.shard_slice(s)
                    stacked[s, : sl.stop - sl.start] = view[sl]
                t = self._device_cache[name] = torch.from_numpy(stacked).to(self.device)
            out[name] = t
        return out

    # -- scan windows ------------------------------------------------------
    def windows(self, plan: KeyPlan,
                cap: int = MAX_SHARD_WINDOWS) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shard row windows, padded to a common (bucketed) window
        count: (starts [S, K], ends [S, K]) int32 in local shard rows."""
        per_shard = []
        for s in range(self.n_shards):
            sl = self.shard_slice(s)
            shard_cols = {k: v[sl] for k, v in self.key_columns.items()}
            if self.key_shifts is not None:
                shard_cols["__shifts__"] = self.key_shifts
            per_shard.append(plan.windows(shard_cols, sl.stop - sl.start, cap))
        K = bucket_count(max(len(s) for s, _ in per_shard))
        starts = np.zeros((self.n_shards, K), np.int32)
        ends = np.zeros((self.n_shards, K), np.int32)
        for i, (s, e) in enumerate(per_shard):
            starts[i, : len(s)] = s
            ends[i, : len(e)] = e
        return starts, ends


class FeatureStore:
    """The Z3 index table + write buffer for one schema on one device."""

    def __init__(self, ft: FeatureType, n_shards: int, device: torch.device):
        geom, dtg = ft.geom_field, ft.dtg_field
        if geom is None or dtg is None:
            raise NotImplementedError(
                "schemas without a point geometry and a date (z2 / id / attribute "
                "indices): ROADMAP Queue 1, index key spaces and predicates"
            )
        self.ft = ft
        self.n_shards = n_shards
        self.device = device
        self.keyspace = Z3KeySpace(geom, dtg, ft.time_period)
        self.table = IndexTable(self.keyspace, n_shards, device)
        self._buffer: List[ColumnBatch] = []
        self._all: Optional[ColumnBatch] = None
        #: z3 key columns of ``_all``'s rows, in master order (None: not
        #: computed, e.g. for a store carried across from arrays)
        self._key_cols: Optional[Dict[str, np.ndarray]] = None
        #: bumped on every data mutation; keys the executor's caches
        self.version = 0

    def append(self, data: Dict) -> int:
        """Buffer an ingest batch (encoded now, indexed at flush)."""
        batch = encode_batch(self.ft, data)
        self._buffer.append(batch)
        return batch.n

    def flush(self) -> None:
        """Merge the buffer into the table as the reference does: z3 keys
        for the fresh rows only (the old rows' keys are kept), then the LSM
        append of :meth:`IndexTable.append_rows`."""
        if not self._buffer:
            return
        fresh = ColumnBatch.concat(self._buffer)
        self._buffer = []
        fresh_keys = self.keyspace.index_keys(self.ft, fresh.columns)
        if self._all is None:
            merged, keys = fresh, fresh_keys
        else:
            merged = ColumnBatch.concat([self._all, fresh])
            if self._key_cols is None:
                keys = self.keyspace.index_keys(self.ft, merged.columns)
            else:
                keys = {k: np.concatenate([self._key_cols[k], v])
                        for k, v in fresh_keys.items()}
        self._all = merged
        self._key_cols = keys
        self.table.append_rows({**merged.columns, **keys},
                               {**fresh.columns, **fresh_keys}, fresh.n)
        self.version += 1

    def bounds(self) -> Optional[Tuple[float, float, float, float]]:
        """Geometry bounds of the stored rows (None when empty)."""
        if self.table.n == 0:
            return None
        g = self.ft.geom_field
        x, y = self.table._master[g + "__x"], self.table._master[g + "__y"]
        return (float(x.min()), float(y.min()), float(x.max()), float(y.max()))
