"""Time-partitioned, out-of-core feature store.

Port of ``geomesa_tpu/index/partitioned.py``: each time period of the
schema's date attribute owns a child :class:`FeatureStore`; at most
``max_resident`` children stay in host memory (with their device columns),
the others are spilled to an on-disk snapshot of their master columns and
each index's sort permutation and key columns, so a reload never re-sorts.
Queries stream the pruned partitions one at a time
(``planning/partitioned_exec.py``) and merge the partial results.

The partition key is the time bin of ``geomesa.partition.period`` (default:
the schema's z3 interval). Children share the parent's dictionaries, so
string codes and compiled predicates hold in every partition, and each
child table rounds its padded shard length up to
``geomesa.partition.shard.bucket``. The budget, the spill directory and
the bucket are read from ``config`` when the store is made.

Snapshots use the JAX package's npz layout (its ``geomesa.lake.enabled=
false`` branch): ``data.npz`` with ``c/<column>`` master columns,
``k/<column>`` index key columns, ``t/<index>/order``,
``t/<index>/key/<column>`` and ``t/<index>/vocab``, beside ``meta.json``
(row count, key shifts, the write-time sketches as JSON). A reloaded child
reads its master columns lazily (:class:`_LazyCols`). A partition leaves
memory only after its snapshot is on disk.

Not ported yet (ROADMAP Queue 1): the lake snapshot tier and its pruned
partial loads, spill retries and quarantine, checkpoints and attaching
snapshots, and schema or index changes and deletes on a partitioned store.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.binned_time import BinnedTime
from geomesa_tpu_torch.index.store import FeatureStore, _init_stats
from geomesa_tpu_torch.schema.columns import ColumnBatch
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stats import sketches as sk


def is_partitioned_schema(ft: FeatureType) -> bool:
    v = ft.user_data.get("geomesa.partition", "").lower()
    return v in ("time", "true")


class _LazyCols(dict):
    """Master-column mapping that reads a snapshot member on first access,
    so a reloaded partition pays disk reads only for the columns its
    queries touch."""

    def __init__(self, npz_path: str, zkeys: Dict[str, str]):
        super().__init__()
        self._path = npz_path
        self._zkeys = dict(zkeys)   # column name -> npz member
        self._zf = None

    def __missing__(self, k):
        zk = self._zkeys.get(k)
        if zk is None:
            raise KeyError(k)
        if self._zf is None:
            self._zf = np.load(self._path, allow_pickle=False)
        v = self._zf[zk]
        self[k] = v
        return v

    def __contains__(self, k):
        return super().__contains__(k) or k in self._zkeys

    def get(self, k, default=None):
        # dict.get bypasses __missing__; lazy members must still resolve
        try:
            return self[k]
        except KeyError:
            return default

    def __iter__(self):
        seen = dict.fromkeys(self._zkeys)
        seen.update(dict.fromkeys(super().keys()))
        return iter(seen)

    def keys(self):
        return list(iter(self))

    def items(self):  # materializes: snapshot writes and merges need all
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]

    def __len__(self):
        return len(set(self._zkeys) | set(super().keys()))


class PartitionedFeatureStore(FeatureStore):
    """FeatureStore facade over per-time-period child stores. The parent's
    own tables stay empty: queries fan out through
    :class:`geomesa_tpu_torch.planning.partitioned_exec.PartitionedExecutor`.
    ``spills`` and ``loads`` count snapshot writes and reloads."""

    def __init__(self, ft: FeatureType, n_shards: int, device: torch.device):
        super().__init__(ft, n_shards, device)
        if ft.dtg_field is None:
            raise ValueError(
                "time partitioning requires a date attribute "
                "(geomesa.partition=time on a schema with no dtg)"
            )
        self.partition_period = ft.user_data.get("geomesa.partition.period",
                                                 ft.time_period)
        self.binned = BinnedTime(self.partition_period)
        #: resident children, bin -> store (insertion order = LRU order)
        self.partitions: Dict[int, FeatureStore] = {}
        #: spilled children, bin -> snapshot dir
        self.spilled: Dict[int, str] = {}
        #: rows per partition, resident and spilled
        self.part_counts: Dict[int, int] = {}
        #: resident children with changes not on disk yet
        self._dirty: set = set()
        #: bin -> the snapshot dir a clean resident child was loaded from
        self._snapshot_paths: Dict[int, str] = {}
        self.max_resident = max(1, config.MAX_RESIDENT_PARTITIONS.to_int() or 4)
        #: None makes a temporary directory, removed with the store
        self._spill_dir: Optional[str] = config.SPILL_DIR.get()
        self._shard_bucket = config.SHARD_LEN_BUCKET.to_int() or 1
        self._owns_spill_dir = False
        #: guards the partition map: the query pipeline's prefetch thread
        #: loads partition i+1 while the query thread evicts after i
        #: (RLock: child() -> _load() -> evict() nests)
        self._part_lock = threading.RLock()
        self._merged_stats = None
        self._merged_stats_version = -1
        self.spills = 0
        self.loads = 0

    # -- partition bookkeeping --------------------------------------------
    @property
    def spill_dir(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="geomesa_spill_")
            self._owns_spill_dir = True
        return self._spill_dir

    def partition_bins(self) -> List[int]:
        with self._part_lock:
            return sorted(set(self.partitions) | set(self.spilled))

    def _new_child(self) -> FeatureStore:
        child = FeatureStore(self.ft, self.n_shards, self.device)
        child.dicts = self.dicts  # shared: codes hold across partitions
        for t in child.tables.values():
            t.shard_len_multiple = self._shard_bucket
        return child

    def _touch(self, b: int) -> None:
        """Move partition ``b`` to the most-recently-used position."""
        self.partitions[b] = self.partitions.pop(b)

    def child(self, b: int, create: bool = False) -> Optional[FeatureStore]:
        """Resident child for bin ``b``, loaded from disk if spilled."""
        with self._part_lock:
            st = self.partitions.get(b)
            if st is not None:
                self._touch(b)
                return st
            if b in self.spilled:
                return self._load(b)
            if not create:
                return None
            st = self._new_child()
            self.partitions[b] = st
            self._dirty.add(b)
            return st

    def evict(self, keep: Optional[int] = None) -> None:
        """Spill least-recently-used residents down to ``keep`` (default
        ``max_resident``)."""
        keep = self.max_resident if keep is None else keep
        with self._part_lock:
            while len(self.partitions) > max(keep, 1):
                self._spill(next(iter(self.partitions)))  # LRU head

    # -- spill format ------------------------------------------------------
    def _part_dir(self, b: int) -> str:
        return os.path.join(self.spill_dir, f"part_{b}")

    def _spill(self, b: int) -> None:
        """Write partition ``b``'s snapshot (unless it is clean since its
        last load and the snapshot is still there), then drop it and its
        device columns. The partition leaves memory only after the write."""
        st = self.partitions[b]
        st.flush()
        d = self._snapshot_paths.get(b, self._part_dir(b))
        if b in self._dirty or not os.path.isdir(d):
            d = self._part_dir(b)
            self._write_snapshot(st, d)
            self._snapshot_paths[b] = d
            self.spills += 1
        self.partitions.pop(b)  # only now: the snapshot is on disk
        self._dirty.discard(b)
        self.spilled[b] = d
        self.part_counts[b] = st.count
        st.drop_device()

    @staticmethod
    def _write_snapshot(st: FeatureStore, d: str) -> None:
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        arrs: Dict[str, np.ndarray] = {}
        if st._all is not None:
            for k, v in st._all.columns.items():
                # object columns (extent WKT) spill as unicode, so the
                # snapshot loads without pickle
                arrs["c/" + k] = v.astype("U") if v.dtype.kind == "O" else v
        for k, v in st._key_cols.items():
            arrs["k/" + k] = v
        shifts: Dict[str, Dict[str, int]] = {}
        for name, t in st.tables.items():
            arrs[f"t/{name}/order"] = t.order
            for k, v in t.key_columns.items():
                arrs[f"t/{name}/key/{k}"] = v
            if t._rank_vocab is not None:
                arrs[f"t/{name}/vocab"] = t._rank_vocab.astype("U")
            if t.key_shifts is not None:
                shifts[name] = dict(t.key_shifts)
        np.savez(os.path.join(tmp, "data.npz"), **arrs)
        meta = {
            "n": st._all.n if st._all is not None else 0,
            "shifts": shifts,
            "stats": {k: v.to_json() for k, v in st.stats.items()},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)

    def _load(self, b: int) -> FeatureStore:
        """Reload a spilled partition and make it the most recent resident
        (evicting over budget). The ``spilled`` entry goes only on success."""
        d = self.spilled[b]
        st = self._load_snapshot(d)
        self.spilled.pop(b, None)
        self.partitions[b] = st
        self.part_counts[b] = st.count
        self._snapshot_paths[b] = d
        self.loads += 1
        self.evict()
        return st

    def _load_snapshot(self, d: str) -> FeatureStore:
        """One snapshot dir -> a fresh child: sort permutations and key
        columns read now, master columns on first access."""
        st = self._new_child()
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        st.stats = {k: sk.Stat.from_json(v) for k, v in meta["stats"].items()}
        path = os.path.join(d, "data.npz")
        with np.load(path, allow_pickle=False) as z:
            files = list(z.files)
            master = _LazyCols(path, {k[2:]: k for k in files if k.startswith(("c/", "k/"))})
            cols = _LazyCols(path, {k[2:]: k for k in files if k.startswith("c/")})
            st._key_cols = {k[2:]: z[k] for k in files if k.startswith("k/")}
            master.update(st._key_cols)
            st._all = ColumnBatch(cols, int(meta["n"]))
            for name, t in st.tables.items():
                pre = f"t/{name}/"
                if pre + "order" not in files:
                    continue
                t.order = z[pre + "order"]
                t.key_columns = {k[len(pre) + 4:]: z[k]
                                 for k in files if k.startswith(pre + "key/")}
                if pre + "vocab" in files:
                    t._rank_vocab = z[pre + "vocab"].astype(object)
                sh = meta["shifts"].get(name)
                t.key_shifts = {k: int(v) for k, v in sh.items()} if sh else None
                t._master = master
                t.n = len(t.order)
                t.shard_bounds = np.linspace(0, t.n, t.n_shards + 1).astype(np.int64)
        return st

    def spill_all(self) -> List[int]:
        """Spill every resident partition (a fully cold store). Returns the
        bins spilled."""
        with self._part_lock:
            out = list(self.partitions)
            for b in out:
                self._spill(b)
            return out

    # -- write path --------------------------------------------------------
    def flush(self) -> None:
        """Route buffered rows to their time partitions: one stable i32
        argsort by bin, contiguous copies per partition, each child flushed
        and the store evicted to its budget after each."""
        if not self._buffer:
            return
        fresh = ColumnBatch.concat(self._buffer)
        self._buffer = []
        bins, _ = self.binned.to_bin_and_offset(
            np.asarray(fresh.columns[self.ft.dtg_field], np.int64))
        order = np.argsort(bins.astype(np.int32), kind="stable")
        sb = bins[order]
        sorted_cols = {k: v[order] for k, v in fresh.columns.items()}
        cuts = np.flatnonzero(np.concatenate(([True], sb[1:] != sb[:-1])))
        bounds = np.concatenate((cuts, [len(sb)]))
        for i, c in enumerate(cuts):
            b = int(sb[c])
            hi = bounds[i + 1]
            # copies, not views: a view would pin the whole sorted batch in
            # every child's master columns past its eviction
            sub = ColumnBatch({k: v[c:hi].copy() for k, v in sorted_cols.items()},
                              int(hi - c))
            child = self.child(b, create=True)
            child._buffer.append(sub)
            self._dirty.add(b)
            child.flush()
            self.part_counts[b] = child.count
            self.evict()
        self.version += 1

    # -- read-side surface -------------------------------------------------
    @property
    def count(self) -> int:
        resident = {b: st.count for b, st in self.partitions.items()}
        spilled = sum(c for b, c in self.part_counts.items()
                      if b not in resident and b in self.spilled)
        return sum(resident.values()) + spilled + sum(b.n for b in self._buffer)

    @property
    def stats(self) -> Dict[str, sk.Stat]:
        """The write-time sketches merged over every partition: residents
        directly, spilled partitions from their snapshot's JSON (no column
        is read). Cached per store version."""
        if self._merged_stats is not None and self._merged_stats_version == self.version:
            return self._merged_stats
        merged = _init_stats(self.ft)
        for st in self.partitions.values():
            for k, v in st.stats.items():
                if k in merged:
                    merged[k].merge(v)
                else:
                    merged[k] = sk.Stat.from_json(v.to_json())
        for d in self.spilled.values():
            with open(os.path.join(d, "meta.json")) as fh:
                meta = json.load(fh)
            for k, s in meta["stats"].items():
                v = sk.Stat.from_json(s)
                if k in merged:
                    merged[k].merge(v)
                else:
                    merged[k] = v
        self._merged_stats = merged
        self._merged_stats_version = self.version
        return merged

    @stats.setter
    def stats(self, value) -> None:
        """Absorbed: the merged sketches are always recomputed from the
        partitions (FeatureStore.__init__ assigns here)."""
        self._merged_stats = None

    def __del__(self):
        if getattr(self, "_owns_spill_dir", False):
            shutil.rmtree(self._spill_dir, ignore_errors=True)
