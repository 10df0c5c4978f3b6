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

Snapshots are lake files by default (``geomesa.lake.enabled``;
``lake/snapshot.py``): master rows in the primary index's order, cut into
row groups with bbox and time statistics. With the knob off a spill writes
the npz layout (``data.npz`` with ``c/<column>`` master columns,
``k/<column>`` key columns, ``t/<index>/order``, ``t/<index>/key/<column>``
and ``t/<index>/vocab``); either format loads. Both keep ``meta.json``
(row count, key shifts, the write-time sketches as JSON) beside the data.
A reloaded child reads its master columns lazily. A partition leaves
memory only after its snapshot is on disk.

An additive scan may ask :meth:`PartitionedFeatureStore.scan_child` for a
spilled lake partition pruned to the plan's box and interval: an ephemeral
child over the surviving row groups, never entered into the resident map.
A partition that cannot be served pruned loads whole, and the reason is
recorded on the scan's window.

Schema and index changes and deletes reach resident children at once;
spilled snapshots are upgraded when they load (null-filled new columns,
missing index tables built), and a delete loads, rewrites and marks dirty
every partition it touches.

A checkpoint (``GeoDataset.save``) writes or copies each partition's
snapshot under the checkpoint root (:meth:`PartitionedFeatureStore.checkpoint_into`,
incremental by a per-partition content sequence); a load registers them
cold (:meth:`PartitionedFeatureStore.attach_snapshots`).

Fault posture (the ``index.spill.store`` and ``index.spill.load`` fault
points): a snapshot write or load is retried in place on a transient
``OSError`` under a ``RetryPolicy`` seeded by the bin
(``geomesa.retry.*``), and a partition leaves memory only after its
snapshot is on disk, so a failed spill raises with the partition still
resident. Any other load failure, or a crc or decode failure of a column
read lazily after the load, marks the snapshot corrupt: the bin is
quarantined (:meth:`PartitionedFeatureStore.spill_quarantine`) and every
later load of it fails fast, with no read, until
:meth:`PartitionedFeatureStore.clear_spill_quarantine` re-admits it. The
query layer's degradation contract decides whether a failed load fails the
query or skips the partition.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config, metrics, resilience
from geomesa_tpu_torch.curves.binned_time import BinnedTime
from geomesa_tpu_torch.index.keyspace import AttributeKeySpace
from geomesa_tpu_torch.index.store import FeatureStore, IndexTable, _init_stats
from geomesa_tpu_torch.lake.format import LakeCorruptError
from geomesa_tpu_torch.lake.snapshot import SNAPSHOT_FILE, PartitionSnapshot, write_snapshot
from geomesa_tpu_torch.schema.columns import ColumnBatch, null_columns
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stats import sketches as sk


def is_partitioned_schema(ft: FeatureType) -> bool:
    v = ft.user_data.get("geomesa.partition", "").lower()
    return v in ("time", "true")


class _LazyCols(dict):
    """Master-column mapping that reads a snapshot member on first access
    (``read(member)``: an npz member, or a lake column over the loaded row
    groups), so a reloaded partition pays reads only for the columns its
    queries touch. ``on_corrupt(err)`` hears of a lake crc or decode
    failure of a lazy read, which surfaces mid-scan after the load was
    committed: the store quarantines the bin there."""

    def __init__(self, read, zkeys: Dict[str, str], on_corrupt=None):
        super().__init__()
        self._read = read
        self._zkeys = dict(zkeys)   # column name -> snapshot member
        self._on_corrupt = on_corrupt

    def __missing__(self, k):
        zk = self._zkeys.get(k)
        if zk is None:
            raise KeyError(k)
        try:
            v = self._read(zk)
        except LakeCorruptError as e:
            if self._on_corrupt is not None:
                self._on_corrupt(e)
            raise
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


def _fsync_tree(d: str) -> None:
    """fsync every file under ``d``, then ``d`` itself."""
    for dirpath, _, files in os.walk(d):
        for fn in files:
            fd = os.open(os.path.join(dirpath, fn), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    resilience.fsync_dir(d)


def _copy_dir(src: str, d: str) -> None:
    """Copy ``src`` to the new directory ``d`` through ``d.tmp`` and a
    rename, durable once it returns."""
    tmp = d + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        shutil.copytree(src, tmp)
        _fsync_tree(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    resilience.durable_replace(tmp, d)


def _npz_reader(path: str):
    """``read(member)`` over an npz file opened on the first read."""
    zf = []

    def read(member):
        if not zf:
            zf.append(np.load(path, allow_pickle=False))
        return zf[0][member]

    return read


class _LakeTable(IndexTable):
    """An index table of a fully loaded lake snapshot. Its permutation,
    sorted keys and string vocabulary decode together on the first read of
    any of them (under a lock: the prefetch thread may read first), so a
    query, or a delete that removes nothing, pays only for the tables it
    reads. ``n``, ``key_shifts`` and ``shard_bounds`` are set by the
    loader; a rebuild replaces the pending state. A corrupt blob goes to
    ``on_corrupt`` as a lazy column read's does (:class:`_LazyCols`)."""

    def __init__(self, t: IndexTable, snap: PartitionSnapshot, name: str, on_corrupt=None):
        super().__init__(t.keyspace, t.n_shards, t.device)
        self.shard_len_multiple = t.shard_len_multiple
        self._pending = (snap, name)
        self._on_corrupt = on_corrupt
        self._lock = threading.Lock()

    def _load(self) -> None:
        with self._lock:
            if self._pending is None:
                return
            snap, name = self._pending
            try:
                order = snap.table_order(name)
                keys = snap.table_keys(name)
                vocab = snap.table_vocab(name)
            except LakeCorruptError as e:
                if self._on_corrupt is not None:
                    self._on_corrupt(e)
                raise
            self._order = np.arange(self.n, dtype=np.int64) if order is None else order
            self._key_columns = keys
            if vocab is not None:
                self._rank_vocab_ = vocab.astype(object)
            self._pending = None  # only now: other threads wait on the lock

    def set_state(self, *a, **kw) -> None:
        self._pending = None
        super().set_state(*a, **kw)

    @property
    def order(self) -> np.ndarray:
        if self._pending is not None:
            self._load()
        return self._order

    @order.setter
    def order(self, v: np.ndarray) -> None:
        self._order = v

    @property
    def key_columns(self) -> Dict[str, np.ndarray]:
        if self._pending is not None:
            self._load()
        return self._key_columns

    @key_columns.setter
    def key_columns(self, v: Dict[str, np.ndarray]) -> None:
        self._key_columns = v

    @property
    def _rank_vocab(self):
        if self._pending is not None:
            self._load()
        return self._rank_vocab_

    @_rank_vocab.setter
    def _rank_vocab(self, v) -> None:
        self._rank_vocab_ = v


def _lake_cols(snap: PartitionSnapshot, prefixes, groups=None, cache=None,
               on_corrupt=None) -> _LazyCols:
    """Lazy columns of a lake snapshot: the members with ``prefixes``,
    decoded over ``groups`` (every row group when None)."""
    return _LazyCols(lambda zk: snap.read_column(zk, groups, cache=cache),
                     {c[2:]: c for c in snap.columns if c.startswith(prefixes)},
                     on_corrupt)


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
        #: bin -> content sequence, bumped whenever the partition's rows
        #: change (routing flush, delete)
        self._part_seq: Dict[int, int] = {}
        #: checkpoint dir -> bin -> (content sequence, snapshot dir) last
        #: written there
        self._ckpt_seqs: Dict[str, Dict[int, Tuple[int, str]]] = {}
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
        #: corrupt-snapshot quarantine: bin -> the first failure's repr.
        #: Transient OSErrors are retried in place and never quarantined
        self._spill_quarantine: Dict[int, str] = {}
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
        device columns. The write passes the ``index.spill.store`` fault
        point and is retried in place on a transient ``OSError`` (a
        ``RetryPolicy`` seeded by the bin); the partition leaves memory only
        after the write, so a spill whose retries run out raises with the
        partition still resident."""
        st = self.partitions[b]
        st.flush()
        d = self._snapshot_paths.get(b, self._part_dir(b))
        if b in self._dirty or not os.path.isdir(d):
            d = self._part_dir(b)

            def attempt():
                resilience.fault_point("index.spill.store", bin=int(b), path=d)
                self._write_snapshot(st, d)

            resilience.RetryPolicy.from_config(seed=int(b)).call(
                attempt, retryable=resilience.transient_os_error)
            self._snapshot_paths[b] = d
            self.spills += 1
        self.partitions.pop(b)  # only now: the snapshot is on disk
        self._dirty.discard(b)
        self.spilled[b] = d
        self.part_counts[b] = st.count
        st.drop_device()

    @staticmethod
    def _write_snapshot(st: FeatureStore, d: str, durable: bool = False) -> None:
        """Write ``st``'s snapshot into ``d`` through ``d.tmp`` and a rename:
        a lake file, or the npz layout with ``geomesa.lake.enabled`` off
        (``durable``: every file and the rename fsynced, for a checkpoint)."""
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        if config.LAKE_ENABLED.to_bool():
            try:
                write_snapshot(st, st.ft, tmp)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        else:
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
        if durable:
            _fsync_tree(tmp)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)

    def _load(self, b: int) -> FeatureStore:
        """Reload a spilled partition and make it the most recent resident
        (evicting over budget), through the ``index.spill.load`` fault
        point. A transient ``OSError`` is retried in place (a ``RetryPolicy``
        seeded by the bin) and never quarantined; any other failure
        quarantines the bin and raises ``ValueError``, and a quarantined
        bin raises at once. The ``spilled`` entry goes only on success, so
        a failed load can be retried."""
        self._check_quarantine(b)
        d = self.spilled[b]

        def attempt():
            resilience.fault_point("index.spill.load", bin=int(b), path=d)
            return self._load_snapshot(d, self._quarantiner(b))

        try:
            st = resilience.RetryPolicy.from_config(seed=int(b)).call(
                attempt, retryable=resilience.transient_os_error)
        except OSError:
            raise  # transient: never quarantined, the next read retries
        except Exception as e:
            raise self._quarantine(b, e) from e
        self.spilled.pop(b, None)
        self.partitions[b] = st
        self.part_counts[b] = st.count
        self._snapshot_paths[b] = d
        self.loads += 1
        self.evict()
        return st

    # -- corrupt-snapshot quarantine ---------------------------------------------
    def _check_quarantine(self, b: int) -> None:
        q = self._spill_quarantine.get(b)
        if q is not None:
            raise ValueError(f"partition {b} snapshot quarantined: {q} "
                             "(clear_spill_quarantine() re-admits after repair)")

    def _quarantine(self, b: int, e: BaseException) -> ValueError:
        """Quarantine bin ``b`` for the failure ``e``; the error to raise."""
        with self._part_lock:
            self._spill_quarantine[b] = repr(e)[:300]
        metrics.inc(metrics.SPILL_QUARANTINED)
        return ValueError(f"corrupt partition snapshot for bin {b}: {e!r}")

    def _quarantiner(self, b: int):
        """The ``on_corrupt`` hook of bin ``b``'s lazy reads: quarantine on
        the first failure (the reads themselves re-raise)."""

        def mark(e: BaseException) -> None:
            with self._part_lock:
                if b in self._spill_quarantine:
                    return
                self._spill_quarantine[b] = repr(e)[:300]
            metrics.inc(metrics.SPILL_QUARANTINED)

        return mark

    def spill_quarantine(self) -> Dict[int, str]:
        """The quarantined bins, each with its first failure."""
        with self._part_lock:
            return dict(self._spill_quarantine)

    def clear_spill_quarantine(self, b: Optional[int] = None) -> List[int]:
        """Re-admit bin ``b`` (every bin when None) after its snapshot was
        repaired; returns the bins cleared. A repeated failure quarantines
        again."""
        with self._part_lock:
            if b is not None:
                return [b] if self._spill_quarantine.pop(b, None) is not None else []
            cleared = list(self._spill_quarantine)
            self._spill_quarantine.clear()
            return cleared

    def _load_snapshot(self, d: str, on_corrupt=None) -> FeatureStore:
        """One snapshot dir (lake or npz) -> a fresh child: sort
        permutations and key columns read now (a lake table's on first
        use), master columns on first access; then upgraded to the current
        schema and indices. ``on_corrupt``: the lake reads' quarantine hook
        (:class:`_LazyCols`)."""
        if os.path.exists(os.path.join(d, SNAPSHOT_FILE)):
            return self._load_lake_snapshot(d, on_corrupt)
        st = self._new_child()
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        st.stats = {k: sk.Stat.from_json(v) for k, v in meta["stats"].items()}
        path = os.path.join(d, "data.npz")
        read = _npz_reader(path)
        with np.load(path, allow_pickle=False) as z:
            files = list(z.files)
            master = _LazyCols(read, {k[2:]: k for k in files if k.startswith(("c/", "k/"))})
            cols = _LazyCols(read, {k[2:]: k for k in files if k.startswith("c/")})
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
        self._upgrade_loaded(st, master)
        return st

    def _load_lake_snapshot(self, d: str, on_corrupt=None) -> FeatureStore:
        """Full (every row group) load of a lake snapshot: each table's
        permutation and sorted keys on the table's first use, master and
        cached key columns per column on first access."""
        snap = PartitionSnapshot(d)
        st = self._new_child()
        meta = snap.meta
        st.stats = {k: sk.Stat.from_json(v) for k, v in meta["stats"].items()}
        n = int(meta["n"])
        master = _lake_cols(snap, ("c/", "k/"), on_corrupt=on_corrupt)
        # key columns decode on first use too (a flush, a delete, a table
        # built on load), through ``master`` so each decodes once
        st._key_cols = _LazyCols(lambda zk: master[zk[2:]],
                                 {c[2:]: c for c in snap.columns if c.startswith("k/")})
        st._all = ColumnBatch(_lake_cols(snap, ("c/",), on_corrupt=on_corrupt), n)
        for name, t in list(st.tables.items()):
            if name not in snap.tables:
                continue  # the snapshot predates this index: built below
            t = st.tables[name] = _LakeTable(t, snap, name, on_corrupt)
            sh = meta["shifts"].get(name)
            t.key_shifts = {k: int(v) for k, v in sh.items()} if sh else None
            t._master = master
            t.n = int(snap.tables[name]["n"])
            t.shard_bounds = np.linspace(0, t.n, t.n_shards + 1).astype(np.int64)
        self._upgrade_loaded(st, master)
        return st

    def _upgrade_loaded(self, st: FeatureStore, master) -> None:
        """Bring a loaded child up to a schema or index change its snapshot
        predates: null-fill missing attribute columns, build missing index
        tables and their sketches. Only this child changes, in memory; the
        snapshot is rewritten the next time the partition is dirtied."""
        n = st._all.n if st._all is not None else 0
        missing = [a for a in self.ft.attributes if not a.is_geom and a.name not in master]
        if missing and n:
            cols = null_columns(self.ft, missing, n, self.dicts)
            master.update(cols)
            st._all.columns.update(cols)
        st.ft = self.ft
        for t in st.tables.values():
            if t.n == 0 and n:
                st.build_missing_table(t)
        for a in self.ft.attributes:
            if a.indexed and not a.is_geom and a.type != "json":
                st.ensure_attr_sketch(a.name)

    # -- statistics-pruned partial loads -----------------------------------------
    @staticmethod
    def _pushdown_fallback(b: int, window: Dict, reason: str) -> None:
        """Record on the scan's window a partition that loads whole although
        pushdown was asked for, so ``exec_path`` says so."""
        window.setdefault("fallbacks", []).append((int(b), reason))

    def scan_child(self, b: int, window: Optional[Dict] = None) -> Optional[FeatureStore]:
        """The child of one additive scan. Residents serve as they are. A
        spilled lake partition whose row groups prune against ``window``
        (``{"index": plan index, "boxes": [...] | None, "times": [...] |
        None}``, ``partitioned_exec._push_window``) loads as an ephemeral
        child of the surviving groups, never entered into the resident
        map. Otherwise the ordinary :meth:`child` load: without a window,
        when nothing prunes (a full load caches), or as a recorded
        fallback (``legacy-snapshot``, ``unknown-keyspace``,
        ``no-primary-order``, ``keyspace-not-buildable``). Quarantine and
        retries as :meth:`_load`: the footer read and the pruned load retry
        a transient ``OSError``, and any other failure quarantines the
        bin."""
        with self._part_lock:
            st = self.partitions.get(b)
            if st is not None:
                self._touch(b)
                return st
            if b not in self.spilled:
                return None
            self._check_quarantine(b)
            d = self.spilled[b]
        if window is None:
            return self.child(b)
        if not os.path.exists(os.path.join(d, SNAPSHOT_FILE)):
            self._pushdown_fallback(b, window, "legacy-snapshot")
            return self.child(b)
        requested = window.get("index")
        ks = next((k for k in self.keyspaces if k.name == requested), None)
        if ks is None:
            self._pushdown_fallback(b, window, "unknown-keyspace")
            return self.child(b)
        policy = resilience.RetryPolicy.from_config(seed=int(b))
        try:
            snap = policy.call(lambda: PartitionSnapshot(d),
                               retryable=resilience.transient_os_error)
            groups = snap.prune(window.get("boxes"), window.get("times"))
            have = set(snap.columns)
            buildable = requested == snap.primary or all(
                ("k/" + kc) in have or ("c/" + kc) in have for kc in ks.key_cols)
            if snap.primary is None or snap.primary not in snap.tables:
                self._pushdown_fallback(b, window, "no-primary-order")
                return self.child(b)
            if not buildable:
                self._pushdown_fallback(b, window, "keyspace-not-buildable")
                return self.child(b)
            if len(groups) == len(snap.groups):
                # nothing prunes: a full resident load is better (it caches);
                # deliberate, so not a fallback
                return self.child(b)

            def attempt():
                resilience.fault_point("index.spill.load", bin=int(b), path=d)
                return self._load_pruned(snap, groups, ks, cache=window.get("residency"),
                                         on_corrupt=self._quarantiner(b))

            return policy.call(attempt, retryable=resilience.transient_os_error)
        except OSError:
            raise  # transient: never quarantined, the next read retries
        except Exception as e:
            raise self._quarantine(b, e) from e

    def _load_pruned(self, snap: PartitionSnapshot, groups: List[int], ks,
                     cache=None, on_corrupt=None) -> FeatureStore:
        """The ephemeral child of the surviving row groups, holding only the
        plan's index table. On the snapshot's primary index the groups are
        contiguous stretches of its order: the identity permutation and
        the groups' key chunks, nothing re-sorts. Any other index rebuilds
        its permutation over the loaded rows' key columns (the compiled
        predicate still decides every match). ``lake_note`` carries the
        load's account and marks the child as ephemeral. ``on_corrupt``:
        the lazy reads' quarantine hook."""
        primary, requested = snap.primary, ks.name
        st = self._new_child()
        meta = snap.meta
        st.stats = {k: sk.Stat.from_json(v) for k, v in meta["stats"].items()}
        nsel = snap.group_rows(groups)
        master = _lake_cols(snap, ("c/", "k/"), groups, cache, on_corrupt)
        st._key_cols = {}
        st._all = ColumnBatch(_lake_cols(snap, ("c/",), groups, cache, on_corrupt), nsel)
        t = st.tables[requested]
        st.tables = {requested: t}
        st.keyspaces = [k for k in st.keyspaces if k.name == requested]
        if nsel == 0:
            # everything pruned: every consumer skips a zero-row child
            t.order = np.zeros(0, np.int64)
            t.n = 0
            t._master = master
            t.shard_bounds = np.zeros(t.n_shards + 1, np.int64)
        elif requested == primary:
            t.order = np.arange(nsel, dtype=np.int64)
            t.key_columns = snap.table_keys(primary, groups, cache=cache)
            vocab = snap.table_vocab(primary)
            if vocab is not None:
                t._rank_vocab = vocab.astype(object)
            sh = meta["shifts"].get(primary)
            t.key_shifts = {k: int(v) for k, v in sh.items()} if sh else None
            t._master = master
            t.n = nsel
            t.shard_bounds = np.linspace(0, nsel, t.n_shards + 1).astype(np.int64)
        else:
            needed = {kc: master[kc] for kc in ks.key_cols}
            if isinstance(ks, AttributeKeySpace):
                needed[ks.attr] = master[ks.attr]
            t.rebuild(needed, self.dicts)
            for k2, v2 in list(t._master.items()):
                if k2 not in master:
                    master[k2] = v2
            t._master = master
        # schema upgrade without index builds (the child serves one plan):
        # null-fill the attributes the snapshot predates
        missing = [a for a in self.ft.attributes if not a.is_geom and a.name not in master]
        if missing and nsel:
            cc = null_columns(self.ft, missing, nsel, self.dicts)
            master.update(cc)
            st._all.columns.update(cc)
        st.lake_note = snap.account(groups)
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
        and the store evicted to its budget after each. A spill that fails
        mid-route (``index.spill.store``) puts the rows not routed yet back
        into the buffer before it raises, so the next flush routes them:
        no row is lost."""
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
        done = 0
        try:
            for i, c in enumerate(cuts):
                b = int(sb[c])
                hi = bounds[i + 1]
                # copies, not views: a view would pin the whole sorted batch
                # in every child's master columns past its eviction
                sub = ColumnBatch({k: v[c:hi].copy() for k, v in sorted_cols.items()},
                                  int(hi - c))
                child = self.child(b, create=True)
                child._buffer.append(sub)
                # routed: the child's next flush commits it even if this
                # one fails, so it is not buffered again below
                done = i + 1
                self._dirty.add(b)
                self._part_seq[b] = self._part_seq.get(b, 0) + 1
                child.flush()
                self.part_counts[b] = child.count
                self.evict()
        except BaseException:
            rest = int(cuts[done]) if done < len(cuts) else len(sb)
            if rest < len(sb):
                self._buffer.append(ColumnBatch(
                    {k: v[rest:].copy() for k, v in sorted_cols.items()},
                    int(len(sb) - rest)))
            if done:
                self.version += 1  # some partitions took rows
            raise
        self.version += 1

    # -- schema and index lifecycle ------------------------------------------------
    def add_columns(self, new_ft: FeatureType, added) -> None:
        """Column append: resident children now, spilled snapshots when
        they load (:meth:`_upgrade_loaded`); no partition is rewritten."""
        self.flush()
        self.ft = new_ft
        null_columns(new_ft, added, 0, self.dicts)  # register encoders
        for child in self.partitions.values():
            child.add_columns(new_ft, added)
        self.version += 1
        self._merged_stats = None

    def add_attribute_index(self, attr: str) -> None:
        """Enable an attribute index: resident children build the new
        permutation now, spilled ones when they load. Snapshots are not
        dirtied."""
        a = self.ft.attr(attr)
        if a.is_geom or a.type == "json":
            raise ValueError(f"cannot attribute-index {attr!r} ({a.type})")
        ks = AttributeKeySpace(attr, self.ft.geom_field, a.type)
        if any(k.name == ks.name for k in self.keyspaces):
            return
        self.flush()
        self.keyspaces.append(ks)
        for child in self.partitions.values():
            child.add_attribute_index(attr)
        self.version += 1
        self._merged_stats = None

    def remove_attribute_index(self, attr: str) -> None:
        name = f"attr:{attr}"
        if not any(k.name == name for k in self.keyspaces):
            raise KeyError(f"no attribute index on {attr!r}")
        self.keyspaces = [k for k in self.keyspaces if k.name != name]
        for child in self.partitions.values():
            if name in child.tables:
                child.remove_attribute_index(attr)
        self.version += 1
        self._merged_stats = None

    def delete(self, mask_fn) -> int:
        """Delete partition at a time under the residency budget: each
        partition loads whole, and one that loses rows is marked dirty so
        its next eviction rewrites its snapshot."""
        self.flush()
        removed = 0
        for b in self.partition_bins():
            child = self.child(b)
            r = child.delete(mask_fn)
            if r:
                removed += r
                self._dirty.add(b)
                self._part_seq[b] = self._part_seq.get(b, 0) + 1
                self.part_counts[b] = child.count
            self.evict()
        if removed:
            self.version += 1
            self._merged_stats = None
        return removed

    # -- checkpoints -------------------------------------------------------
    def checkpoint_into(self, path: str) -> Dict[int, str]:
        """Write or refresh every partition's snapshot under ``path``
        without evicting residents and without aliasing live state: a
        clean snapshot is copied, a dirty resident written, so deleting
        the checkpoint never touches the live store. A partition whose
        content sequence was already written to ``path`` keeps that
        snapshot, and so does a clean one loaded from a snapshot under
        ``path``. Every other goes into a new directory ``part_<bin>-<uuid>``
        (through ``.tmp`` and a rename, fsynced): no snapshot that a
        published manifest references is ever overwritten, and the caller
        removes the superseded ones only once the manifest that replaces
        them is durable. Returns bin -> snapshot dir."""
        os.makedirs(path, exist_ok=True)
        here = os.path.abspath(path)
        out: Dict[int, str] = {}
        written = self._ckpt_seqs.setdefault(here, {})

        def fresh(b: int) -> str:
            return os.path.join(path, f"part_{b}-{uuid.uuid4().hex[:8]}")

        def kept(b: int, cur: int, src: str) -> Optional[str]:
            seq, d = written.get(b, (None, ""))
            if seq == cur and os.path.isdir(d):
                return d
            if b not in self._dirty and os.path.isdir(src) \
                    and os.path.dirname(os.path.abspath(src)) == here:
                return src  # loaded from this checkpoint and clean since
            return None

        with self._part_lock:
            for b, st in list(self.partitions.items()):
                st.flush()
                cur = self._part_seq.get(b, 0)
                src = self._snapshot_paths.get(b, "")
                d = kept(b, cur, src)
                if d is None:
                    d = fresh(b)
                    if b in self._dirty or not os.path.isdir(src):
                        self._write_snapshot(st, d, durable=True)
                    else:
                        _copy_dir(src, d)
                written[b] = (cur, d)
                out[b] = d
            for b, sd in list(self.spilled.items()):
                cur = self._part_seq.get(b, 0)
                d = kept(b, cur, sd)
                if d is None:
                    d = fresh(b)
                    _copy_dir(sd, d)
                written[b] = (cur, d)
                out[b] = d
        resilience.fsync_dir(path)
        return out

    def snapshot_dirs_in_use(self) -> set:
        """Absolute paths of the snapshot dirs the live store may still
        read: its spilled partitions' and its clean residents' sources."""
        live = set(self.spilled.values())
        live.update(d for b, d in self._snapshot_paths.items() if b not in self._dirty)
        return {os.path.abspath(d) for d in live}

    def attach_snapshots(self, mapping: Dict[int, str]) -> None:
        """Register on-disk partition snapshots (the load path): only each
        ``meta.json`` is read; the partitions stay cold until a query or a
        write touches them, and a snapshot older than the schema upgrades
        when it loads (:meth:`_upgrade_loaded`)."""
        with self._part_lock:
            for b, d in mapping.items():
                with open(os.path.join(d, "meta.json")) as fh:
                    meta = json.load(fh)
                self.spilled[int(b)] = d
                self.part_counts[int(b)] = int(meta["n"])
        self._merged_stats = None
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
