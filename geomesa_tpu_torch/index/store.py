"""Sharded, sorted columnar feature store on one device.

Port of ``geomesa_tpu/index/store.py``: one index table per key space (z3,
z2, xz3, xz2, id, attribute), a write buffer, the string dictionaries and the
write-time sketches. A table is a sort permutation plus its sorted key
columns over the store's master columns; a shard is a contiguous slab of
the sort order, padded to a common length so the stacked [S, L] device
columns have one static shape. Host master columns keep f64 coordinates
and int64 values (the exact values the f32 band correction and the
refinement read); the device holds f32 (int64 and f64 columns ride as
f32), int32 and bool columns, never strings, extent WKT or 64-bit keys.
Each table uploads the columns a query reads on its first query.
"""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.index.keyspace import (
    MAX_SHARD_WINDOWS, AttributeKeySpace, KeyPlan, KeySpace, keyspaces_for_schema,
)
from geomesa_tpu_torch.index.staging import Staged, Uploader
from geomesa_tpu_torch.kernels.registry import bucket_count
from geomesa_tpu_torch.schema.columns import (
    ColumnBatch, DictionaryEncoder, encode_batch, null_columns, schema_null_fills,
)
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stats import sketches as sk

#: column dtype kinds that never reach the device
_HOST_ONLY_KINDS = ("O", "U", "S")


def device_view(a: np.ndarray) -> Optional[np.ndarray]:
    """Host column -> device-eligible array (int32 / float32 / bool), or
    None for host-only columns (strings, uint64 keys). int64 and float64
    ride as float32."""
    if a.dtype.kind in _HOST_ONLY_KINDS or a.dtype == np.uint64:
        return None
    if a.dtype in (np.float64, np.int64):
        return a.astype(np.float32)
    return a


class IndexTable:
    """One index: a sort permutation + sorted key columns over the store's
    master column set. Attribute columns are gathered through ``order`` once
    per device upload."""

    def __init__(self, keyspace: KeySpace, n_shards: int, device: torch.device):
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
        #: value-sorted dictionary of a string attribute index
        self._rank_vocab: Optional[np.ndarray] = None
        #: column name -> [S, L] tensor on ``device``
        self._device_cache: Dict[str, torch.Tensor] = {}
        #: staged columns of the partition pipeline, consumed (and freed)
        #: by device_columns: stacked host arrays, or side-stream uploads
        self._host_stage: Dict[str, object] = {}
        #: the padded shard length rounds up to a multiple of this (a
        #: partition child's bucket); 1 reads geomesa.compact.shard.bucket
        #: under bucketing when the length is asked for
        self.shard_len_multiple = 1

    # -- build ------------------------------------------------------------
    def rebuild(self, columns: Dict[str, np.ndarray],
                dicts: Dict[str, DictionaryEncoder]) -> None:
        """Re-sort by the key and re-shard. ``columns`` is the master
        column dict (attributes + every index's key columns)."""
        cols = dict(columns)
        ks = self.keyspace
        if isinstance(ks, AttributeKeySpace) and ks.attr_type == "string":
            # dictionary codes are in first-seen order: a value-ordered
            # rank column lets searchsorted windows serve string ranges
            vocab = np.array(dicts[ks.attr].values, dtype=object)
            order = np.argsort(vocab)
            rank_of_code = np.empty(len(vocab), np.int64)
            rank_of_code[order] = np.arange(len(vocab))
            codes = columns[ks.attr]
            cols[ks.sort_col] = np.where(codes >= 0,
                                         rank_of_code[np.clip(codes, 0, None)], -1)
            self._rank_vocab = vocab[order]
        fb = ks.fast_build(cols)
        if fb is not None:
            order, keys, shifts = fb
        else:
            order = ks.sort_order(cols)
            order = np.asarray(order, np.int32 if len(order) < 2**31 else np.int64)
            key_names = set(ks.key_cols) | {getattr(ks, "sort_col", None)}
            keys = {k: cols[k][order] for k in key_names if k in cols}
            shifts = None
        self.set_state(cols, order, keys, shifts,
                       np.linspace(0, len(order), self.n_shards + 1).astype(np.int64))

    def append_rows(self, columns: Dict[str, np.ndarray],
                    dicts: Dict[str, DictionaryEncoder],
                    fresh_cols: Dict[str, np.ndarray], n_fresh: int) -> None:
        """LSM append, as the reference's: sort the fresh rows alone, under
        the table's key shifts, and merge them into the existing order at
        their searchsorted insertion positions (O(old + fresh) instead of a
        full re-sort). ``columns`` is the master column dict with the fresh
        rows last; ``fresh_cols`` those rows' columns and keys. Falls back
        to :meth:`rebuild` for an empty table, a key space that cannot
        insert, or fresh keys that do not fit the table's quantization."""
        ks = self.keyspace
        if self.n == 0 or not ks.can_insert:
            return self.rebuild(columns, dicts)
        key_names = list(self.key_columns)
        if any(k not in fresh_cols for k in key_names):
            return self.rebuild(columns, dicts)
        if self.key_shifts is not None:
            fb = ks.fast_build(fresh_cols, force_shifts=self.key_shifts)
            if fb is None or fb[2] != self.key_shifts:
                return self.rebuild(columns, dicts)
            fresh_order, fresh_sorted, _ = fb
            fresh_order = fresh_order.astype(np.int64, copy=False)
        else:
            fresh_order = np.asarray(ks.sort_order(fresh_cols), np.int64)
            fresh_sorted = {k: fresh_cols[k][fresh_order] for k in key_names}
        p = ks.insert_positions(self.key_columns, fresh_sorted)
        if p is None:
            return self.rebuild(columns, dicts)
        at = p + np.arange(n_fresh)
        total = self.n + n_fresh
        is_fresh = np.zeros(total, bool)
        is_fresh[at] = True
        order = np.empty(total, np.int32 if total < 2**31 else np.int64)
        order[is_fresh] = self.n + fresh_order  # master rows are [old | fresh]
        order[~is_fresh] = self.order
        keys = {}
        for k in key_names:
            old = self.key_columns[k]
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
        self.drop_device()

    def drop_device(self) -> None:
        """Forget the device columns and anything staged for them."""
        self._device_cache.clear()
        self._host_stage.clear()

    # -- column access -----------------------------------------------------
    def has_column(self, name: str) -> bool:
        return name in self.key_columns or name in self._master

    def dtype_of(self, name: str) -> Optional[np.dtype]:
        col = self.key_columns.get(name)
        if col is None:
            col = self._master.get(name)
        return None if col is None else col.dtype

    def is_host_only(self, name: str) -> bool:
        """Strings, fids and uint64 keys stay on the host."""
        dt = self.dtype_of(name)
        return dt is None or device_view(np.zeros(0, dt)) is None

    def column_names(self) -> List[str]:
        names = dict.fromkeys(self._master)
        names.update(dict.fromkeys(self.key_columns))
        return list(names)

    def col_sorted(self, name: str) -> np.ndarray:
        """Full host column in sort order (key columns are stored sorted;
        master columns gather through the permutation)."""
        col = self.key_columns.get(name)
        if col is not None:
            return col
        return self._master[name][self.order]

    def rows(self, names: Sequence[str], pos: np.ndarray) -> Dict[str, np.ndarray]:
        """Host rows at sorted-order positions ``pos``: exact master values
        (key columns only where no master column has the name)."""
        master_rows = self.order[pos]
        out = {}
        for k in names:
            if k in self._master:
                out[k] = self._master[k][master_rows]
            elif k in self.key_columns:
                out[k] = self.key_columns[k][pos]
        return out

    # -- feature gathers ------------------------------------------------------
    def gather_sorted(self, sel: np.ndarray,
                      names: Optional[Sequence[str]] = None) -> ColumnBatch:
        """Host rows at sorted-order positions ``sel`` as a ColumnBatch (the
        reference's ``_gather_sorted``; its ``host_gather`` and
        ``host_gather_positions`` map a padded mask or flat positions to
        these positions first, which the executor does here). ``names``
        projects: the feature id, each name, and every ``<name>__*``
        companion column (x / y, time bins) gather; None gathers every
        column. Master values win over key copies."""
        sel = np.asarray(sel, np.int64)
        rows = self.order[sel]
        cols = self.column_names() if names is None else [
            k for k in self.column_names()
            if k == "__fid__" or k in names
            or any(k.startswith(n + "__") for n in names)
        ]
        out = {}
        for k in cols:
            if k in self._master:
                out[k] = self._master[k][rows]
            else:
                out[k] = self.key_columns[k][sel]
        return ColumnBatch(out, len(sel))

    @property
    def shard_len(self) -> int:
        """Padded per-shard length: the largest shard, rounded up to
        :attr:`shard_len_multiple`, or, when that is 1 and
        ``geomesa.compact.bucketing`` is on, to
        ``geomesa.compact.shard.bucket``, so a small insert keeps one
        shape."""
        if self.n == 0:
            return 0
        m = int(np.max(np.diff(self.shard_bounds)))
        b = self.shard_len_multiple
        if b <= 1 and config.COMPACT_BUCKETING.to_bool():
            b = config.COMPACT_SHARD_BUCKET.to_int() or 1
        return m if b <= 1 else -(-m // b) * b

    def shard_slice(self, s: int) -> slice:
        return slice(int(self.shard_bounds[s]), int(self.shard_bounds[s + 1]))

    def _stack_host(self, name: str, out: Optional[np.ndarray] = None) -> np.ndarray:
        """One column's padded [S, L] host array (into ``out`` when given):
        the host half of a device upload."""
        view = device_view(self.col_sorted(name))
        if view is None:
            raise TypeError(f"column {name!r} cannot ride the device")
        if out is None:
            out = np.empty((self.n_shards, self.shard_len), dtype=view.dtype)
        for s in range(self.n_shards):
            sl = self.shard_slice(s)
            k = sl.stop - sl.start
            out[s, :k] = view[sl]
            out[s, k:] = 0
        return out

    def stage_host(self, names: Sequence[str], uploader: Optional[Uploader] = None) -> int:
        """Stage ``names`` for a later :meth:`device_columns`: the partition
        pipeline's prefetch thread runs this for the next partition while
        the current one executes. Without an ``uploader`` the stacked host
        arrays wait here; with one (a CUDA table) each column is stacked
        into pinned memory and its copy starts on the uploader's side
        stream. Columns already on the device or staged, absent or
        host-only are skipped, and so is a column whose host assembly fails
        (the consumer assembles it again); errors of CUDA calls propagate.
        Returns the bytes staged by this call."""
        L = self.shard_len
        staged = 0
        for name in sorted(set(names)):
            if name in self._device_cache or name in self._host_stage:
                continue
            try:
                if not self.has_column(name) or self.is_host_only(name):
                    continue
                dt = device_view(np.zeros(0, self.dtype_of(name))).dtype
                arr = None if uploader is not None else self._stack_host(name)
            except Exception:  # host work only: device_columns redoes it
                continue
            if arr is not None:
                self._host_stage[name] = arr
                staged += arr.nbytes
                continue
            up = uploader.upload((self.n_shards, L), dt,
                                 lambda out, name=name: self._stack_host(name, out))
            if up is not None:
                self._host_stage[name] = up
                staged += self.n_shards * L * dt.itemsize
        return staged

    def device_columns(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Stacked, padded [S, L] tensors for ``names`` on the table's
        device (cached per column): a staged upload after its copy, a staged
        host array copied now, or the column stacked and copied now.
        Host-only columns (fids, extent WKT, strings) are skipped. A change
        of the padded length (``geomesa.compact.shard.bucket`` or
        bucketing scoped otherwise) drops the cached and staged columns."""
        out = {}
        if self._device_cache:
            first = next(iter(self._device_cache.values()))
            if first.shape[1] != self.shard_len:
                self._device_cache.clear()
                self._host_stage.clear()
        for name in dict.fromkeys(names):
            t = self._device_cache.get(name)
            if t is None:
                if self.has_column(name) and self.is_host_only(name):
                    continue
                staged = self._host_stage.pop(name, None)
                if isinstance(staged, Staged):
                    t = staged.take()
                else:
                    host = self._stack_host(name) if staged is None else staged
                    t = torch.from_numpy(host).to(self.device)
                self._device_cache[name] = t
            out[name] = t
        return out

    def device_bytes(self) -> int:
        """Bytes of the device columns this table holds."""
        return sum(t.nbytes for t in self._device_cache.values())

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
            if self._rank_vocab is not None:
                shard_cols["__rank_lookup__"] = self._rank_lookup
            per_shard.append(plan.windows(shard_cols, sl.stop - sl.start, cap))
        K = bucket_count(max(len(s) for s, _ in per_shard))
        starts = np.zeros((self.n_shards, K), np.int32)
        ends = np.zeros((self.n_shards, K), np.int32)
        for i, (s, e) in enumerate(per_shard):
            starts[i, : len(s)] = s
            ends[i, : len(e)] = e
        return starts, ends

    def _rank_lookup(self, value, side: str) -> int:
        """Rank bound of a string value in the value-sorted dictionary."""
        if side == "lo":
            return int(np.searchsorted(self._rank_vocab, value, side="left"))
        return int(np.searchsorted(self._rank_vocab, value, side="right")) - 1


def _init_stats(ft: FeatureType) -> Dict[str, object]:
    """The write-time sketches the decider and ``bounds()`` read: row
    count, geometry bounds (of the points, or of extents' bounds centroids),
    time bounds, the z2 / z3 histograms of a point schema, and per indexed
    attribute an enumeration (strings) or min / max."""
    out: Dict[str, object] = {"count": sk.CountStat()}
    if ft.geom_field:
        out["bounds"] = sk.MinMax(ft.geom_field)
    if ft.dtg_field:
        out["time-bounds"] = sk.MinMax(ft.dtg_field)
    point = ft.geom_field is not None and ft.attr(ft.geom_field).is_point
    if point:
        out["z2-histogram"] = sk.Z2HistogramStat(ft.geom_field, 1024)
    if point and ft.dtg_field:
        out["z3-histogram"] = sk.Z3HistogramStat(ft.geom_field, ft.dtg_field,
                                                 ft.time_period, 1024)
    for a in ft.attributes:
        if a.indexed and not a.is_geom and a.type != "json":
            if a.type == "string":
                out[f"enum-{a.name}"] = sk.EnumerationStat(a.name)
            else:
                out[f"minmax-{a.name}"] = sk.MinMax(a.name)
    return out


class FeatureStore:
    """Every index table, the write buffer, the dictionaries and the
    sketches of one schema on one device."""

    _uids = itertools.count()

    def __init__(self, ft: FeatureType, n_shards: Optional[int], device: torch.device):
        #: process-unique id: the aggregate cache scopes its entries by
        #: ``(uid, version)``, and ``id()`` can be recycled after GC
        self.uid = next(FeatureStore._uids)
        self.ft = ft
        n_shards = n_shards or ft.shards or config.DEFAULT_SHARDS.to_int()
        self.n_shards = n_shards
        self.device = device
        self.dicts: Dict[str, DictionaryEncoder] = {}
        self.keyspaces = keyspaces_for_schema(ft)
        self.tables: Dict[str, IndexTable] = {
            ks.name: IndexTable(ks, n_shards, device) for ks in self.keyspaces
        }
        self.stats = _init_stats(ft)
        self._buffer: List[ColumnBatch] = []
        self._all: Optional[ColumnBatch] = None
        #: index key columns of ``_all``'s rows, in master order
        self._key_cols: Dict[str, np.ndarray] = {}
        #: bumped on every data mutation; keys the executor's caches
        self.version = 0
        #: changes whenever stored rows are rewritten (a delete, a column
        #: add) rather than appended: an incremental checkpoint appends one
        #: chunk only while it is unchanged. Every path that rewrites rows
        #: calls :meth:`_bump_epoch`.
        self.mutation_epoch = uuid.uuid4().hex
        #: host seconds of the last flush by stage ("keys", "sketches",
        #: then one entry per table: its sort and append)
        self.flush_seconds: Dict[str, float] = {}
        #: host seconds of the last flush's key encode, by index
        self.key_seconds: Dict[str, float] = {}
        #: the executor's caches of device artefacts made from this store
        #: (gathered slabs; a partition child's per-plan caches)
        self.device_state: Dict[str, Dict] = {}
        #: the row groups and bytes a pruned lake load read, on an
        #: ephemeral partition child (``PartitionedFeatureStore.scan_child``)
        self.lake_note: Optional[Dict[str, int]] = None

    def append(self, data: Dict, fids=None) -> int:
        """Buffer an ingest batch (encoded now, indexed at flush)."""
        batch = encode_batch(self.ft, data, self.dicts, fids)
        self._buffer.append(batch)
        return batch.n

    @property
    def count(self) -> int:
        return (self._all.n if self._all else 0) + sum(b.n for b in self._buffer)

    def flush(self) -> None:
        """Merge the buffer into every table as the reference does: index
        keys for the fresh rows only (the old rows' keys are kept), the
        sketches observe the fresh rows, then each table's LSM append."""
        if not self._buffer:
            return
        t0 = time.perf_counter()
        fills = schema_null_fills(self.ft)
        fresh = ColumnBatch.concat(self._buffer, fills)
        self._buffer = []
        fresh_keys: Dict[str, np.ndarray] = {}
        self.key_seconds = {}
        for ks in self.keyspaces:
            t1 = time.perf_counter()
            fresh_keys.update(ks.index_keys(self.ft, fresh.columns))
            self.key_seconds[ks.name] = time.perf_counter() - t1
        seconds = {"keys": time.perf_counter() - t0}
        t0 = time.perf_counter()
        # the period marker tells the z3 histogram the keys match its own
        stat_cols = {**fresh.columns, **fresh_keys}
        if "__z3" in fresh_keys:
            stat_cols["__z3_period"] = self.ft.time_period
        for st in self.stats.values():
            st.observe(stat_cols)
        seconds["sketches"] = time.perf_counter() - t0
        if self._all is None:
            merged = fresh
            key_cols = {**fresh.columns, **fresh_keys}
        else:
            merged = ColumnBatch.concat([self._all, fresh], fills)
            key_cols = dict(merged.columns)
            for k, fv in fresh_keys.items():
                key_cols[k] = np.concatenate([self._key_cols[k], fv])
        self._all = merged
        self._key_cols = {k: v for k, v in key_cols.items() if k not in merged.columns}
        fresh_all = {**fresh.columns, **fresh_keys}
        for ks in self.keyspaces:
            t0 = time.perf_counter()
            self.tables[ks.name].append_rows(key_cols, self.dicts, fresh_all, fresh.n)
            seconds[ks.name] = time.perf_counter() - t0
        self.flush_seconds = seconds
        self.version += 1

    def drop_device(self) -> None:
        """Free every device tensor made from this store: the tables'
        columns and staging, and the executor's caches."""
        for t in self.tables.values():
            t.drop_device()
        self.device_state.clear()

    # -- schema and index lifecycle ------------------------------------------------
    # Each call below changes what the device columns were made from, so
    # each drops them (the tables' [S, L] columns and the executor's
    # caches) and bumps the version.
    def add_columns(self, new_ft: FeatureType, added) -> None:
        """Append null-filled columns for the ``added`` attributes in
        place: no key changes, so every table keeps its permutation and
        only learns the new master columns."""
        self.flush()
        self.ft = new_ft
        n = self._all.n if self._all is not None else 0
        cols = null_columns(new_ft, added, n, self.dicts)
        self._bump_epoch()
        if n:
            self._all.columns.update(cols)
            for t in self.tables.values():
                t._master.update(cols)
        self.drop_device()
        self.version += 1

    def _bump_epoch(self) -> None:
        """Mark the stored rows as rewritten: the next incremental
        checkpoint rewrites every chunk instead of appending one."""
        self.mutation_epoch = uuid.uuid4().hex

    def _attr_stat_key(self, attr: str) -> str:
        return f"enum-{attr}" if self.ft.attr(attr).type == "string" else f"minmax-{attr}"

    def build_missing_table(self, t: IndexTable) -> None:
        """Build an empty table's permutation from the master rows: an
        index enabled on a live store, or a partition snapshot that
        predates the index. Only the key space's own input columns are
        read, so a lazily loaded child decodes one column."""
        if self._all is None or not self._all.n:
            return
        ks = t.keyspace
        fresh = ks.index_keys(self.ft, self._all.columns)
        self._key_cols.update(fresh)
        needed = dict(fresh)
        if isinstance(ks, AttributeKeySpace):
            needed[ks.attr] = self._all.columns[ks.attr]
        t.rebuild(needed, self.dicts)
        # attribute gathers read the master: share another table's
        # (possibly lazy) mapping
        other = next((ot for oname, ot in self.tables.items()
                      if oname != ks.name and ot.n), None)
        if other is not None:
            base = other._master
            for k, v in t._master.items():
                if k not in base:
                    base[k] = v
            t._master = base
        else:
            merged = {**self._all.columns, **self._key_cols}
            for k, v in t._master.items():
                merged.setdefault(k, v)
            t._master = merged

    def ensure_attr_sketch(self, attr: str) -> None:
        """Build the write-time sketch an attribute index's cost estimate
        reads, if it is missing."""
        skey = self._attr_stat_key(attr)
        if skey in self.stats:
            return
        stat = sk.EnumerationStat(attr) if self.ft.attr(attr).type == "string" \
            else sk.MinMax(attr)
        if self._all is not None and self._all.n:
            stat.observe(self._all.columns)
        self.stats[skey] = stat

    def add_attribute_index(self, attr: str) -> None:
        """Enable an attribute index on a live store: build only the new
        permutation over the master columns. The table pads its shards as
        the store's other tables do (a partition child's bucket)."""
        a = self.ft.attr(attr)
        if a.is_geom or a.type == "json":
            raise ValueError(f"cannot attribute-index {attr!r} ({a.type})")
        ks = AttributeKeySpace(attr, self.ft.geom_field, a.type)
        if ks.name in self.tables:
            return
        self.flush()
        self.keyspaces.append(ks)
        t = IndexTable(ks, self.n_shards, self.device)
        if self.tables:
            t.shard_len_multiple = next(iter(self.tables.values())).shard_len_multiple
        self.tables[ks.name] = t
        self.build_missing_table(t)
        self.ensure_attr_sketch(attr)
        self.drop_device()
        self.version += 1

    def remove_attribute_index(self, attr: str) -> None:
        """Drop an attribute index (permutation, key column and sketch);
        the master columns stay."""
        name = f"attr:{attr}"
        if name not in self.tables:
            raise KeyError(f"no attribute index on {attr!r}")
        self.drop_device()
        del self.tables[name]
        self.keyspaces = [k for k in self.keyspaces if k.name != name]
        self._key_cols.pop(f"__attr_{attr}", None)
        self.stats.pop(self._attr_stat_key(attr), None)
        self.version += 1

    def delete(self, mask_fn) -> int:
        """Remove the rows where ``mask_fn(master columns)`` (a host bool
        mask) is true and rebuild every table over the rest. The other
        sketches keep what they observed, as the reference's do. Returns
        the rows removed."""
        self.flush()
        if self._all is None or self._all.n == 0:
            return 0
        mask = np.asarray(mask_fn(self._all.columns), bool)
        removed = int(mask.sum())
        if removed == 0:
            return 0
        keep_mask = ~mask
        keep = self._all.select(keep_mask)
        self._all = keep
        self._bump_epoch()
        self.stats["count"] = sk.CountStat(keep.n)
        key_cols: Dict[str, np.ndarray] = dict(keep.columns)
        self._key_cols = {k: v[keep_mask] for k, v in self._key_cols.items()}
        key_cols.update(self._key_cols)
        for ks in self.keyspaces:
            if any(k not in key_cols for k in ks.key_cols):
                key_cols.update(ks.index_keys(self.ft, keep.columns))
                self._key_cols.update({k: v for k, v in key_cols.items()
                                       if k not in keep.columns})
            self.tables[ks.name].rebuild(key_cols, self.dicts)
        self.drop_device()
        self.version += 1
        return removed

    def bounds(self) -> Optional[Tuple[float, float, float, float]]:
        """Geometry bounds of the stored rows from the ``bounds`` sketch
        (None when empty)."""
        mm = self.stats.get("bounds")
        if mm is None or mm.is_empty:
            return None
        return (mm.lo[0], mm.lo[1], mm.hi[0], mm.hi[1])
