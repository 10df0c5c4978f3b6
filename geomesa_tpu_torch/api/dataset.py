"""User-facing entry point: schema catalog + per-schema stores + planner +
executor, on one CUDA device.

Port of the ``geomesa_tpu/api/dataset.py::GeoDataset`` surface the port
serves, with the JAX signatures: ``create_schema``, ``insert`` (with
feature ids), ``flush``, ``count`` (exact, or the planner's estimate),
``density``, ``bounds``, feature queries (``query``, ``query_batches``,
``sample``) with ``Query`` objects (projection, ``max_features``, sorting
with the device top-k, sampling, a forced index), ``stats`` and its
helpers (``unique``, ``min_max``, ``histogram``, ``frequency``,
``top_k``), ``knn``, polygon ``region=`` aggregates, and the joins
(``join`` by attribute or spatial predicate, ``join_spatial``,
``join_count``, ``explain_join``, ``spatial_join``), the block-aligned
``density_curve`` and the query-axis batches (``density_curve_batch``,
``density_curve_filter_batch``, ``count_batch``, ``density_batch``,
``stats_batch``: M distinct viewports of one query shape in one call,
each member equal to its serial call, or None when they cannot share
it), the schema and data lifecycle (``get_schema``, ``list_schemas``,
``describe``, ``delete_schema``, ``update_schema``,
``add_attribute_index``, ``remove_attribute_index``, ``delete_features``,
``age_off``, ``z3_histogram``), and durable datasets: ``save`` (an
incremental checkpoint: ``manifest.json`` version 2 with npz chunks per
flat schema and lake snapshots per partition), ``GeoDataset.load`` (on
the card unless ``device="cpu"``), ``refresh_schema`` (catch up with a
shared root), and the write-ahead mutation journal (``attach_journal``;
``load`` attaches it): every mutation call above journals a typed record
before it applies and returns once the record is on disk. Roots and
journals interchange with the JAX package's.

With ``geomesa.cache.enabled`` (off by default) ``count``, ``density``,
``density_curve`` and ``stats`` answer through the aggregate cache
(``cache/``: whole results, partial-cover cells, hierarchical assembly,
polygon regions, curve chunk families, epoch invalidation), and
``persist_cache`` / ``restore_cache`` carry its entries across a restart;
the batches, joins, sampled queries and feature queries bypass it.

A schema with ``geomesa.partition='time'`` gets a time-partitioned,
out-of-core store and serves the same calls partition at a time
(``index/partitioned.py``, ``planning/partitioned_exec.py``).
Extent-geometry columns take WKT strings or geometry objects on insert
and come back as WKT.

Every public query call opens one root span (``tracing.py``; off unless
``geomesa.trace.enabled``) and plans through the schema's interceptors and
the built-in guards
(``geomesa.scan.block-full-table``, ``geomesa.guard.temporal.max.days``),
which a cached plan checks again on every call. ``query``,
``query_batches``, the exact ``count``, ``density``, ``density_curve``,
``stats`` and the joins write one ``QueryEvent`` each to ``self.audit``
(``audit.py``), a query-axis batch one per member. ``explain`` prints the
planner's explain tree and the cache, hierarchy, warm-path,
observability and (``analyze=True``) selectivity and cost sections.

Every public call passes the serving scheduler's admission
(``self.serving``, ``serving/scheduler.py``): a call whose deadline scope
has already run out is shed with a typed ``DeadlineShedError`` before any
plan or device work, and ``count`` / ``density`` / ``stats`` with
``speculative_ok=True`` answer such a shed with a coarse host-only
estimate (``_speculative_*``) instead. ``self.serving.start()`` starts the
dispatch thread, which queues, sheds, orders by fair share and fuses
concurrent requests (``serving/fuse.py``). Standing queries (``subscribe``,
``subscription_poll``, ``unsubscribe``; ``subscribe/``) keep registered
viewports current as inserts, deletes and age-offs apply; their journal
records and manifest entries are the reference's, so roots with
subscriptions interchange both ways.

No counterpart here yet: the fleet (the journal's epoch marker and the
handoff of standing groups) and ``StreamingDataset``'s live windows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import time
import uuid
import zlib
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config, metrics, resilience, tracing, utilization
from geomesa_tpu_torch.audit import AuditWriter
from geomesa_tpu_torch.cache import AggregateCache
from geomesa_tpu_torch.fs import journal as _jr
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.index.partitioned import PartitionedFeatureStore, is_partitioned_schema
from geomesa_tpu_torch.index.store import FeatureStore
from geomesa_tpu_torch.kernels import registry as kreg
from geomesa_tpu_torch.planning import interceptors
from geomesa_tpu_torch.planning.batch import build_spec
from geomesa_tpu_torch.planning.executor import Executor, query_deadline
from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.planning.partitioned_exec import PartitionedExecutor
from geomesa_tpu_torch.planning.planner import QueryHints, QueryPlan, guard, plan_query
from geomesa_tpu_torch.schema.columns import (
    ColumnBatch, DictionaryEncoder, decode_batch, fid_strs, schema_null_fills,
)
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.serving import QueryScheduler
from geomesa_tpu_torch.stats import parse_stat
from geomesa_tpu_torch.stats import sketches as sk
from geomesa_tpu_torch.subscribe import StandingQueryEngine, StoreWindow, UnknownSubscription
from geomesa_tpu_torch.subscribe import spec as subspec
from geomesa_tpu_torch.subscribe.spec import StandingSpec
from geomesa_tpu_torch.utils import geometry as geo
from geomesa_tpu_torch.utils.geometry import EARTH_RADIUS_M, haversine_m

#: ROADMAP items the port refuses by name
_HOST_LAYERS = "ROADMAP Queue 1, host layers"

#: the reference's row-visibility column and dictionary: the port writes
#: every row as public (code 0, the empty expression) into checkpoints, so
#: either package loads the other's root, and refuses any other code
_VIS = "__vis__"


@dataclass
class Query:
    """A query: ECQL + hints (the GeoTools Query analog). ``auths`` and an
    ``srid`` other than 4326 belong to the host layers and raise."""

    ecql: str = "INCLUDE"
    max_features: Optional[int] = None
    properties: Optional[List[str]] = None
    sort_by: Optional[List[Tuple[str, bool]]] = None  # (attr, descending)
    sampling: Optional[int] = None
    #: per-key sampling attribute: 1-in-``sampling`` per distinct value
    sample_by: Optional[str] = None
    index: Optional[str] = None
    auths: Optional[List[str]] = None
    srid: Optional[int] = None

    def hints(self) -> QueryHints:
        return QueryHints(
            query_index=self.index,
            sampling=self.sampling,
            sample_by=self.sample_by,
            max_features=self.max_features,
            properties=self.properties,
            sort_by=self.sort_by,
        )


class FeatureCollection:
    """Query result: host columns + decode helpers."""

    #: CRS of the geometry columns (the port does not reproject)
    srid = 4326

    def __init__(self, ft: FeatureType, batch: ColumnBatch,
                 dicts: Dict[str, DictionaryEncoder]):
        self.ft = ft
        self.batch = batch
        self.dicts = dicts

    def __len__(self):
        return self.batch.n

    @property
    def columns(self):
        return self.batch.columns

    @property
    def fids(self) -> List[str]:
        """Feature ids as ``str``."""
        col = self.batch.columns.get("__fid__")
        return [] if col is None else fid_strs(col).tolist()

    def to_dict(self) -> Dict[str, Any]:
        if self.batch.n == 0:
            return {}
        return decode_batch(self.ft, self.batch, self.dicts)

    def to_pandas(self):
        """A DataFrame of :meth:`to_dict` (needs pandas), points split into
        ``<geom>_x`` / ``<geom>_y``."""
        import pandas as pd

        d = self.to_dict()
        if not d:
            return pd.DataFrame()
        geom = self.ft.geom_field
        if geom in d and d[geom]:
            xs, ys = zip(*d[geom])
            d[geom + "_x"], d[geom + "_y"] = list(xs), list(ys)
            del d[geom]
        return pd.DataFrame(d)


class SpatialJoinResult:
    """Result of a co-partitioned spatial join: the exact matched-pair
    total plus a streaming matched-pair view. ``count`` is exact over the
    completed tile ranges and polygon slices: the full answer unless
    ``stats.skipped`` lists the ones an ``allow_partial()`` join skipped
    (``degraded``). ``batches()`` streams matched pairs as ColumnBatches of
    at most ``geomesa.join.batch.rows`` rows: left columns verbatim, right
    columns prefixed ``right.`` (the attribute equi-join's convention)."""

    def __init__(self, lbatch: ColumnBatch, rbatch: ColumnBatch, pairs,
                 count: int, stats):
        self._lbatch, self._rbatch = lbatch, rbatch
        #: matched (left, right) row positions, int64 [K, 2], row-major
        self.pairs = pairs
        self.count = int(count)
        self.stats = stats

    @property
    def degraded(self) -> bool:
        return bool(self.stats.skipped)

    def batches(self, batch_rows: Optional[int] = None):
        """Yield matched-pair ColumnBatches (chunked: peak memory is one
        chunk's gathered columns, never the whole pair set)."""
        if self.pairs is None:
            raise ValueError("join_count result carries no pairs; use "
                             "join_spatial for the streaming form")
        if batch_rows is None:
            batch_rows = config.JOIN_BATCH_ROWS.to_int() or 65536
        batch_rows = max(int(batch_rows), 1)
        for lo in range(0, len(self.pairs), batch_rows):
            chunk = self.pairs[lo: lo + batch_rows]
            li, rj = chunk[:, 0], chunk[:, 1]
            cols = {k: v[li] for k, v in self._lbatch.columns.items()}
            for k, v in self._rbatch.columns.items():
                cols["right." + k] = v[rj]
            yield ColumnBatch(cols, len(chunk))

    def __iter__(self):
        return self.batches()

    def to_batch(self) -> ColumnBatch:
        """The whole pair set as one ColumnBatch (small joins / tests)."""
        out = list(self.batches(batch_rows=max(len(self.pairs), 1)))
        return out[0] if out else ColumnBatch({}, 0)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device that is not visible
    raises instead of running on the CPU. Pass ``"cpu"`` explicitly for the
    plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _traced(op: str, speculative: Optional[str] = None):
    """Open one ROOT span per public query operation (a child span when a
    trace is already open) and pass the call through serving admission:
    an op whose deadline has already run out is shed with a typed
    ``DeadlineShedError`` before any plan or device work, and the op is
    accounted to the admitted user (whom its audit events name).

    ``speculative``: the method answering a shed call whose caller passed
    ``speculative_ok=True``, with a coarse host-only result."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, name, *args, **kw):
            spec_ok = bool(kw.pop("speculative_ok", False))
            # the fallback runs inside the root span, so the speculative
            # audit event carries this trace id
            with tracing.start(op, schema=name):
                try:
                    with self.serving.admit(op):
                        return fn(self, name, *args, **kw)
                except resilience.DeadlineShedError:
                    # only admission raises it, so no device work ran
                    if not (spec_ok and speculative):
                        raise
                    return getattr(self, speculative)(name, *args, **kw)
                finally:
                    # the call's CUDA busy intervals, complete once its
                    # host copies returned, go to this trace's ledger
                    utilization.resolve_pending()

        return wrapper

    return deco


class GeoDataset:
    """Schema catalog + stores on one device.

    ``n_shards``: the shards of each store (None: the schema's
    ``geomesa.z.splits``, else ``geomesa.index.shards``).
    ``compact_min_rows`` / ``compact_fraction``: the compacted scan layout
    engages for tables of at least ``compact_min_rows`` rows whose windows
    admit less than ``compact_fraction`` of the table; None (the default)
    reads ``geomesa.compact.min.rows`` / ``geomesa.compact.fraction`` at
    each scan."""

    def __init__(self, n_shards: Optional[int] = None, device=None,
                 compact_min_rows: Optional[int] = None,
                 compact_fraction: Optional[float] = None):
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.compact_min_rows = compact_min_rows
        self.compact_fraction = compact_fraction
        self._stores: Dict[str, FeatureStore] = {}
        self._executors: Dict[str, Any] = {}
        self._plans: Dict[tuple, QueryPlan] = {}
        #: the query audit log: one QueryEvent per public query call
        self.audit = AuditWriter()
        #: the serving scheduler: every public call passes its inline
        #: admission; ``start()`` runs the dispatch thread
        self.serving = QueryScheduler()
        self.serving.set_residency_probe(self._residency_bytes)
        #: the standing-query engine, made by the first subscribe
        self.standing: Optional[StandingQueryEngine] = None
        #: the aggregate cache in front of count / density / density_curve /
        #: stats (``geomesa.cache.enabled``; off by default)
        self.cache = AggregateCache()
        #: the write-ahead mutation journal (``fs/journal.py``), attached by
        #: :meth:`load` or :meth:`attach_journal`; None keeps mutations in
        #: memory until the next :meth:`save`. Attached, every mutation
        #: appends a record before it applies and returns once it is on disk.
        self._journal: Optional[_jr.MutationJournal] = None
        #: mutations applied from the journal or a checkpoint do not journal
        #: themselves again
        self._replaying = False
        #: schema -> the last journal record applied here (a second dataset
        #: on the root catches up from it in :meth:`refresh_schema`)
        self._applied_seq: Dict[str, int] = {}
        #: schema -> fingerprint of the manifest entry it was attached from
        #: or saved as: the journal-only catch-up holds while it is unchanged
        self._ckpt_fp: Dict[str, int] = {}
        #: records applied by the last replay
        self._journal_replayed = 0
        #: host seconds of :meth:`load` by stage ("manifest", "chunks" read,
        #: "tables" rebuilt, "partitions" attached, journal "replay" and
        #: the index flush after it, "replay_flush")
        self.load_seconds: Dict[str, float] = {}

    # -- schemas ------------------------------------------------------------
    def create_schema(self, name_or_ft, spec: Optional[str] = None) -> FeatureType:
        ft = (name_or_ft if isinstance(name_or_ft, FeatureType)
              else FeatureType.from_spec(name_or_ft, spec))
        if ft.name in self._stores:
            raise ValueError(f"schema {ft.name!r} already exists")
        # the record carries the spec: a schema made after the last
        # checkpoint rebuilds from the journal alone
        self._journal_rec("schema-create", ft.name, spec=ft.spec(), n_shards=self.n_shards)
        store_cls = PartitionedFeatureStore if is_partitioned_schema(ft) else FeatureStore
        self._stores[ft.name] = store_cls(ft, self.n_shards, self.device)
        return ft

    def get_schema(self, name: str) -> FeatureType:
        return self._store(name).ft

    def list_schemas(self) -> List[str]:
        return sorted(self._stores)

    def delete_schema(self, name: str) -> None:
        st = self._store(name)  # raises if missing
        # the tombstone first: replay must not bring the schema back from
        # its checkpoint files
        self._journal_rec("delete-schema", name)
        if self.standing is not None:
            self.standing.drop_schema(name)
        # the schema's uid is never read again, so neither the epoch check
        # nor the per-uid LRU would reclaim its cached aggregates
        self.cache.store.invalidate(st.uid)
        del self._stores[name]
        self._forget(name)
        self._applied_seq.pop(name, None)
        self._ckpt_fp.pop(name, None)

    def describe(self, name: str) -> str:
        st = self._store(name)
        lines = [st.ft.describe(), f"  count: {st.count}"]
        lines.append(f"  indices: {[ks.name for ks in st.keyspaces]}")
        return "\n".join(lines)

    def _forget(self, name: str) -> None:
        """Drop the schema's executor (and its device caches) and its
        cached plans: a schema or data change makes both stale."""
        self._executors.pop(name, None)
        for k in [k for k in self._plans if k[0] == name]:
            del self._plans[k]

    # -- schema, index and data lifecycle ---------------------------------------
    def update_schema(self, name: str, add_spec: str) -> FeatureType:
        """Add attributes to a schema, keeping its data: the new columns
        are appended in place and null-filled (string null code, float NaN,
        int / long 0, bool False, date epoch 0); no key changes, so no
        table re-sorts. Spilled partitions upgrade when they load."""
        st = self._store(name)
        st.flush()
        old = st.ft
        attrs_part, sep, ud_part = old.spec().partition(";")
        new_ft = FeatureType.from_spec(name, attrs_part + "," + add_spec + sep + ud_part)
        added = [a for a in new_ft.attributes if not old.has(a.name)]
        for a in added:
            if a.is_geom:
                raise ValueError("cannot add geometry attributes to a schema")
        self._journal_rec("update-schema", name, add_spec=add_spec)
        st.add_columns(new_ft, added)
        self._forget(name)
        return new_ft

    def add_attribute_index(self, name: str, attr: str) -> None:
        """Enable an attribute index on a live schema: only the new
        permutation is built (per resident partition; spilled partitions
        build theirs when they load)."""
        st = self._store(name)
        a = st.ft.attr(attr)
        self._journal_rec("add-index", name, attr=attr)
        st.add_attribute_index(attr)
        a.options["index"] = "true"
        # an explicit geomesa.indices list overrides the options: it must
        # name the attr kind, or children made later would drop the index
        explicit = st.ft.user_data.get("geomesa.indices")
        if explicit is not None:
            kinds = [k.strip().lower() for k in explicit.split(",") if k.strip()]
            if "attr" not in kinds:
                st.ft.user_data["geomesa.indices"] = explicit + ",attr"
        self._forget(name)

    def remove_attribute_index(self, name: str, attr: str) -> None:
        """Drop an attribute index (permutation and sketch); data stays."""
        st = self._store(name)
        self._journal_rec("remove-index", name, attr=attr)
        st.remove_attribute_index(attr)
        st.ft.attr(attr).options.pop("index", None)
        self._forget(name)

    def age_off(self, name: str, older_than) -> int:
        """Delete the features older than a cutoff: epoch-ms int, numpy
        datetime64 or ISO string. Returns the rows removed."""
        st = self._store(name)
        dtg = st.ft.dtg_field
        if dtg is None:
            raise ValueError(f"schema {name!r} has no date attribute")
        if isinstance(older_than, str):
            cutoff = parse_iso_ms(older_than)
        elif isinstance(older_than, np.datetime64):
            cutoff = int(older_than.astype("datetime64[ms]").astype(np.int64))
        else:
            cutoff = int(older_than)
        # the resolved cutoff is journaled, so a replay deletes the same rows
        self._journal_rec("age-off", name, older_than_ms=cutoff)
        pred = lambda cols: cols[dtg] < cutoff  # noqa: E731
        bounds = self._standing_dirty_bounds(name, st, pred)
        n = st.delete(pred)
        self._forget(name)
        if n and self.standing is not None and self.standing.active(name):
            self.standing.on_dirty(name, bounds)
        return n

    def delete_features(self, name: str, ecql: str, auths=None) -> int:
        """Delete the features matching ``ecql``, through the exact host
        mask (extent geometries refine, never the envelope superset).
        Returns the rows removed. Authorizations belong to the host
        layers and raise."""
        if auths is not None:
            raise NotImplementedError(f"delete authorizations: {_HOST_LAYERS}")
        st = self._store(name)
        f = parse_ecql(ecql)
        self._journal_rec("delete-features", name, ecql=ecql, auths=None)
        cf = compile_filter(f, st.ft, st.dicts)
        pred = lambda cols: cf.exact_mask(cols, len(cols["__fid__"]))  # noqa: E731
        bounds = self._standing_dirty_bounds(name, st, pred)
        n = st.delete(pred)
        self._forget(name)
        if n and self.standing is not None and self.standing.active(name):
            # non-additive: the groups whose viewport meets the removed
            # rows' bounds re-scan, the others keep their results
            self.standing.on_dirty(name, bounds)
        return n

    def _standing_dirty_bounds(self, name: str, st, pred):
        """The bbox of the rows ``pred`` is about to remove: the extent a
        non-additive mutation's re-scans are scoped to. None with no
        standing group, or when the extent is unknown."""
        if self.standing is None or not self.standing.active(name):
            return None
        st.flush()
        if st._all is None or not st._all.n:
            return None
        g = st.ft.geom_field
        cols = st._all.columns
        if g is None or g + "__x" not in cols:
            return None
        try:
            m = np.asarray(pred(cols)).astype(bool)
        except Exception:
            return None
        xs, ys = cols[g + "__x"][m], cols[g + "__y"][m]
        ok = np.isfinite(xs) & np.isfinite(ys)
        if not ok.any():
            return None
        xs, ys = xs[ok], ys[ok]
        return (float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max()))

    # -- standing queries -------------------------------------------------------
    def _standing_engine(self) -> StandingQueryEngine:
        if self.standing is None:
            self.standing = StandingQueryEngine(lambda nm: StoreWindow(self, nm))
        return self.standing

    def subscribe(self, name: str, aggregate: str, bbox=None, region=None,
                  width: int = 256, height: int = 256, levels: Optional[int] = None,
                  stat_spec: Optional[str] = None, sub_id: Optional[str] = None) -> str:
        """Register a standing viewport (``count``, ``density``, ``pyramid``
        or ``stats`` over ``bbox`` and/or a ``region`` polygon): every
        applied insert then updates its result incrementally, and a delete
        or age-off re-scans the viewports it touches. Same-viewport
        subscribers share one group. Returns the subscription id (its
        prefix is the fleet ring's route key). The journal record carries
        the id, so a replay registers the same one. Partitioned schemas
        are refused, as in the reference."""
        sp = subspec.make_spec(name, aggregate, bbox=bbox, region=region, width=width,
                               height=height, levels=levels, stat_spec=stat_spec)
        self._store(name)  # an unknown schema raises before registering
        eng = self._standing_engine()
        if sub_id is None:
            sub_id = eng.make_sub_id(sp)
        self._journal_rec("subscribe", name, spec=sp.to_dict(), sub_id=sub_id)
        return eng.register(sp, sub_id=sub_id)

    def unsubscribe(self, sub_id: str) -> bool:
        if self.standing is None:
            return False
        schema = self.standing.schema_of(sub_id)
        if schema is not None:
            self._journal_rec("unsubscribe", schema, sub_id=sub_id)
        return self.standing.unregister(sub_id)

    def subscription_poll(self, sub_id: str, cursor: int = 0) -> Dict[str, Any]:
        """The standing result (in the cache's wire form, see
        ``subscribe/delta.py::decode_result``) and the update records past
        ``cursor``."""
        if self.standing is None:
            raise UnknownSubscription(sub_id)
        return self.standing.poll(sub_id, cursor)

    def z3_histogram(self, name: str) -> Optional[sk.Z3HistogramStat]:
        """The write-time spatio-temporal histogram the cost model reads
        (None when empty or the schema has none)."""
        st = self._store(name)
        st.flush()
        z = st.stats.get("z3-histogram")
        return z if isinstance(z, sk.Z3HistogramStat) and not z.is_empty else None

    def attach_store(self, store: FeatureStore) -> None:
        """Serve an already-built store (see ``convert.store_from_arrays``)
        under its schema name."""
        if store.device != self.device:
            raise ValueError(f"store on {store.device}, dataset on {self.device}")
        if store.ft.name in self._stores:
            raise ValueError(f"schema {store.ft.name!r} already exists")
        self._stores[store.ft.name] = store

    def _store(self, name: str) -> FeatureStore:
        st = self._stores.get(name)
        if st is None:
            raise KeyError(
                f"no schema {name!r} (have: {', '.join(sorted(self._stores)) or 'none'})"
            )
        return st

    def _executor(self, name: str):
        """The schema's Executor, or PartitionedExecutor for a partitioned
        store."""
        ex = self._executors.get(name)
        st = self._store(name)
        if ex is None or ex.store is not st:
            cls = PartitionedExecutor if isinstance(st, PartitionedFeatureStore) else Executor
            ex = self._executors[name] = cls(
                st, compact_min_rows=self.compact_min_rows,
                compact_fraction=self.compact_fraction,
            )
        return ex

    def _residency_bytes(self, schema: str, slot: int) -> int:
        """The schema's card-resident column bytes on serving slot
        ``slot``'s card now: the scheduler's placement probe. Metadata
        reads only (it runs under the scheduler lock). The port's one card
        is slot 0's; another slot holds nothing."""
        st = self._stores.get(schema)
        if st is None or slot != 0:
            return 0
        total = 0
        children = list(st.partitions.values()) if isinstance(st, PartitionedFeatureStore) else [st]
        for child in children:
            for t in list(child.tables.values()):
                for arr in list(t._device_cache.values()):
                    total += arr.numel() * arr.element_size()
        return total

    # -- the write-ahead mutation journal -----------------------------------------
    def attach_journal(self, path: str) -> Optional[_jr.MutationJournal]:
        """Attach (or create) the write-ahead mutation journal under
        ``path``: from here on every mutation appends a typed, crc-framed
        record and returns once it is group-committed to disk (ack =
        durable). :meth:`load` attaches it by default. Does nothing when
        ``geomesa.journal.enabled`` is false or a journal is attached;
        returns the journal (None when disabled)."""
        if not config.JOURNAL_ENABLED.to_bool():
            return None
        if self._journal is None:
            self._journal = _jr.MutationJournal(path)
            # a checkpoint may have deleted every segment: new records must
            # still sequence after the positions the manifest stamps, or a
            # reload would skip them as checkpointed (the reference's
            # journal restarts at 1 there and loses them)
            mpath = os.path.join(path, "manifest.json")
            if os.path.exists(mpath):
                with open(mpath) as fh:
                    schemas = json.load(fh).get("schemas", {})
                self._journal.adopt_seq(max(
                    (int(e.get("journal_seq", 0)) for e in schemas.values()), default=0))
        return self._journal

    @contextlib.contextmanager
    def _replay_scope(self):
        prev = self._replaying
        self._replaying = True
        try:
            yield
        finally:
            self._replaying = prev

    def _journal_rec(self, kind: str, name: Optional[str], blobs=None, **payload) -> None:
        """Append one typed mutation record before the mutation applies and
        block until it is durable; a journal failure raises, so the
        mutation is never acked without it. ``blobs``: the raw-bytes sink
        of the caller's ``enc_columns``."""
        j = self._journal
        if j is None or self._replaying:
            return
        rec = {"kind": kind, "schema": name}
        rec.update(payload)
        seq = j.append(rec, blobs=blobs)
        if name is not None:
            self._applied_seq[name] = seq

    def _apply_record(self, rec: Dict[str, Any]) -> bool:
        """Re-apply one journal record through the ordinary mutation calls
        (inside :meth:`_replay_scope`). False for a kind the port does not
        know."""
        kind, name = rec.get("kind"), rec.get("schema")
        if kind == "schema-create":
            prev = self.n_shards
            # the reference records None for its default shard count
            self.n_shards = rec.get("n_shards") or prev
            try:
                self.create_schema(FeatureType.from_spec(name, rec["spec"]))
            finally:
                self.n_shards = prev
        elif kind == "delete-schema":
            if name in self._stores:
                self.delete_schema(name)
        elif kind == "insert":
            self.insert(name, _jr.dec_columns(rec["data"]), _jr.dec_value(rec.get("fids")),
                        _jr.dec_value(rec.get("vis")))
        elif kind == "delete-features":
            self.delete_features(name, rec["ecql"], _jr.dec_value(rec.get("auths")))
        elif kind == "update-schema":
            self.update_schema(name, rec["add_spec"])
        elif kind == "age-off":
            self.age_off(name, int(rec["older_than_ms"]))
        elif kind == "add-index":
            self.add_attribute_index(name, rec["attr"])
        elif kind == "remove-index":
            self.remove_attribute_index(name, rec["attr"])
        elif kind == "subscribe":
            self._standing_engine().register(StandingSpec.from_dict(rec["spec"]),
                                             sub_id=rec["sub_id"])
        elif kind == "unsubscribe":
            if self.standing is not None:
                self.standing.unregister(rec["sub_id"])
        else:
            return False
        return True

    def _journal_replay(self, ckpt_seq: Dict[str, int], schema: Optional[str] = None,
                        truncate: bool = False) -> int:
        """Re-apply the journal's records past each schema's checkpointed
        position (``ckpt_seq``) and past what this dataset applied, in
        sequence order. A record that fails to apply is skipped and kept in
        ``resilience.skipped()``: one poisoned record does not fail the
        root. Returns the records applied."""
        j = self._journal
        if j is None:
            return 0
        applied = 0
        with self._replay_scope():
            for rec in j.records(schema=schema, truncate=truncate):
                name = rec.get("schema")
                seq = int(rec.get("seq", 0))
                if seq <= ckpt_seq.get(name, 0) or seq <= self._applied_seq.get(name, 0):
                    continue
                try:
                    if not self._apply_record(rec):
                        continue
                except Exception as e:
                    resilience.record_skip("journal.replay", f"{name}@{seq}", e, phase="apply")
                    continue
                if name is not None:
                    self._applied_seq[name] = seq
                applied += 1
        if applied:
            metrics.registry().counter(metrics.JOURNAL_REPLAYED).inc(applied)
        self._journal_replayed = applied
        return applied

    # -- checkpoints: save / load / refresh_schema ----------------------------------
    @staticmethod
    def _manifest_dicts(st) -> Dict[str, List[str]]:
        """The store's dictionaries in manifest form, with the reference's
        visibility dictionary (every row public) once the store has rows,
        so each package reads the other's manifest as its own."""
        out = {k: d.to_list() for k, d in st.dicts.items()}
        if st._all is not None or getattr(st, "part_counts", None):
            out.setdefault(_VIS, [""])
        return out

    def _save_flat_chunks(self, path: str, name: str, st, prev_entry: Optional[dict]) -> dict:
        """Incremental flat-store checkpoint: the master rows are append
        only while ``mutation_epoch`` holds, so a save after appends writes
        ONE new chunk of the fresh rows and leaves every chunk file
        untouched; a delete or a column add changes the epoch and forces a
        full rewrite. Chunks are ``savez_compressed`` with object columns
        as unicode and the reference's all-public visibility codes."""
        n = st._all.n if st._all is not None else 0
        prev = prev_entry.get("chunks") if prev_entry else None
        incremental = (
            prev is not None
            and prev_entry.get("epoch") == st.mutation_epoch
            and prev_entry.get("rows", -1) <= n
            and all(os.path.exists(os.path.join(path, f)) for f in prev)
        )
        chunks, lo = (list(prev), int(prev_entry["rows"])) if incremental else ([], 0)
        cdir_rel = f"{name}_chunks"
        os.makedirs(os.path.join(path, cdir_rel), exist_ok=True)
        if n > lo:
            # a uuid-suffixed name: a full rewrite never overwrites a chunk
            # the previous (still live) manifest references; save() sweeps
            # the unreferenced files once the new manifest is durable
            fname = f"{cdir_rel}/chunk-{len(chunks):05d}-{lo}-{n}-{uuid.uuid4().hex[:8]}.npz"
            resilience.fault_point("fs.save.chunk", schema=name, file=fname)
            cols = {k: (v[lo:n].astype("U") if v.dtype.kind == "O" else v[lo:n])
                    for k, v in st._all.columns.items()}
            cols.setdefault(_VIS, np.zeros(n - lo, np.int32))
            with open(os.path.join(path, fname), "wb") as fh:
                np.savez_compressed(fh, **cols)
                fh.flush()
                os.fsync(fh.fileno())
            resilience.fsync_dir(os.path.join(path, cdir_rel))
            chunks.append(fname)
        return {"chunks": chunks, "rows": n, "epoch": st.mutation_epoch}

    def save(self, path: str, names: Optional[Sequence[str]] = None) -> None:
        """Checkpoint to ``path``: ``manifest.json`` (version 2: per schema
        its spec, shard count, dictionaries, sketches as JSON, and either
        ``{name}_chunks/`` npz chunks or ``{name}_parts/part_<bin>-<uuid>/``
        snapshots; the reference's ``part_<bin>`` dirs load the same way).
        ``names`` restricts the save to those schemas; the others' entries
        carry over from the existing manifest, and a named schema that no
        longer exists leaves it.

        Incremental: a flat store appends one chunk of its new rows, a
        partitioned store rewrites only the partitions that changed. No
        file the previous manifest names is overwritten: new chunks and
        snapshot dirs get new names, and the superseded ones are swept
        only once the new manifest is durable. With
        the journal attached at ``path``, each saved entry is stamped with
        the journal position it captures, the manifest is published
        durably, then the journal segments every schema has checkpointed
        past are deleted. Saving elsewhere neither stamps nor truncates
        the journal, and never attaches one."""
        os.makedirs(path, exist_ok=True)
        mpath = os.path.join(path, "manifest.json")
        prev_manifest: Dict[str, Any] = {}
        if os.path.exists(mpath):
            with open(mpath) as fh:
                prev_manifest = json.load(fh).get("schemas", {})
        j = self._journal
        if j is not None and os.path.abspath(j.root) != os.path.abspath(path):
            j = None
        jpos = j.last_seq() if j is not None else None
        manifest: Dict[str, Any] = {"version": 2, "schemas": {}}
        if names is not None:
            keep = set(names)
            manifest["schemas"] = {k: v for k, v in prev_manifest.items() if k not in keep}
        for name, st in self._stores.items():
            if names is not None and name not in names:
                continue
            st.flush()
            entry: Dict[str, Any] = {
                "spec": st.ft.spec(),
                "n_shards": st.n_shards,
                "dicts": self._manifest_dicts(st),
                "stats": {k: v.to_json() for k, v in st.stats.items()},
            }
            if jpos is not None:
                entry["journal_seq"] = jpos
            if self.standing is not None:
                # the save truncates the subscribe records, so the entry
                # carries the subscriptions for load to register again
                standing = self.standing.subscriptions(name)
                if standing:
                    entry["standing"] = standing
            if isinstance(st, PartitionedFeatureStore):
                parts = st.checkpoint_into(os.path.join(path, f"{name}_parts"))
                entry["partitions"] = {str(b): os.path.relpath(d, path)
                                       for b, d in parts.items()}
            else:
                entry.update(self._save_flat_chunks(path, name, st, prev_manifest.get(name)))
            manifest["schemas"][name] = entry
            # our own checkpoint moved the entry: refresh_schema stays
            # incremental against it
            self._ckpt_fp[name] = self._entry_fp(entry)
        resilience.fault_point("fs.save.manifest", path=mpath)
        resilience.durable_write_json(mpath, manifest, indent=2)
        self._sweep_orphan_chunks(path, manifest["schemas"], names)
        if j is not None:
            # a carried-over entry without a stamp pins the whole journal
            resilience.fault_point("journal.checkpoint", root=path)
            upto = min((int(e.get("journal_seq", 0)) for e in manifest["schemas"].values()),
                       default=jpos)
            j.checkpoint(min(upto, jpos))
            for name in list(self._applied_seq):
                if names is None or name in set(names):
                    self._applied_seq[name] = max(self._applied_seq.get(name, 0), jpos)

    def _sweep_orphan_chunks(self, path: str, schemas: Dict[str, Any],
                             names: Optional[Sequence[str]]) -> None:
        """Remove what the just-published manifest no longer references,
        for the schemas this save touched: chunk dirs and chunk files, and
        partition snapshot dirs under ``{name}_parts`` (the old files
        outlive the save until the new manifest is durable). A snapshot
        dir the live store still reads stays."""
        ref = set()
        for entry in schemas.values():
            ref.update(entry.get("chunks") or [])
            ref.update(os.path.dirname(rel) for rel in entry.get("chunks") or [])
            ref.update(os.path.normpath(rel) for rel in (entry.get("partitions") or {}).values())
        swept = set(self._stores) if names is None else set(names)
        try:
            listing = os.listdir(path)
        except OSError:
            return
        for name in swept:
            st = self._stores.get(name)
            live = st.snapshot_dirs_in_use() if isinstance(st, PartitionedFeatureStore) else set()
            for fn in listing:
                full = os.path.join(path, fn)
                if not os.path.isdir(full):
                    continue
                if fn.startswith(f"{name}_chunks"):
                    if fn not in ref:
                        shutil.rmtree(full, ignore_errors=True)
                        continue
                    for cf in os.listdir(full):
                        if f"{fn}/{cf}" not in ref:
                            try:
                                os.remove(os.path.join(full, cf))
                            except OSError:
                                pass
                elif fn == f"{name}_parts":
                    for pd in os.listdir(full):
                        d = os.path.join(full, pd)
                        if os.path.join(fn, pd) not in ref and os.path.abspath(d) not in live:
                            shutil.rmtree(d, ignore_errors=True)

    # -- aggregate-cache persistence ------------------------------------------
    def persist_cache(self, path: str) -> Dict[str, Any]:
        """Write the aggregate cache's warm entries (cells, hierarchy
        nodes, curve chunks, whole results) to one lake file, so a
        restarted process can :meth:`restore_cache` them and answer warm
        zoom-outs with no device launch. Only entries whose epoch matches
        their store are written; returns entries per schema."""
        from geomesa_tpu_torch.lake import persist as lake_persist

        return lake_persist.save_cache(self, path)

    def restore_cache(self, path: str) -> Dict[str, Any]:
        """Re-admit persisted cache entries for every schema whose data
        still matches the persisted guard (row count and spec), typically
        right after :meth:`load` of the checkpoint the cache was warmed
        on. Imports take the LRU budget and the store's current epoch, so
        later mutations invalidate as usual."""
        from geomesa_tpu_torch.lake import persist as lake_persist

        return lake_persist.restore_cache(self, path)

    @staticmethod
    def load(path: str, device=None, **options) -> "GeoDataset":
        """A dataset of the checkpoint at ``path`` (on the CUDA device
        unless ``device="cpu"``; ``options``: the constructor's other
        arguments). Flat stores rebuild their tables from the chunks,
        partitioned stores attach their snapshots cold. With
        ``geomesa.journal.enabled`` (the default) the root's journal is
        attached, and the records past each schema's checkpoint replay in
        sequence order (torn tails truncated). A root with neither a
        manifest nor a journal raises ``FileNotFoundError``."""
        t0 = time.perf_counter()
        mpath = os.path.join(path, "manifest.json")
        has_journal = bool(config.JOURNAL_ENABLED.to_bool()) and _jr.journal_exists(path)
        manifest: Dict[str, Any] = {"schemas": {}}
        if os.path.exists(mpath) or not has_journal:
            with open(mpath) as fh:
                manifest = json.load(fh)
        ds = GeoDataset(device=device, **options)
        ds.load_seconds["manifest"] = time.perf_counter() - t0
        ckpt: Dict[str, int] = {}
        for name, meta in manifest["schemas"].items():
            ds._attach_schema_entry(path, name, meta)
            ckpt[name] = ds._applied_seq[name] = int(meta.get("journal_seq", 0))
        if config.JOURNAL_ENABLED.to_bool():
            ds.attach_journal(path)
            t0 = time.perf_counter()
            replayed = has_journal and ds._journal_replay(ckpt, truncate=True)
            ds.load_seconds["replay"] = time.perf_counter() - t0
            if replayed:
                t0 = time.perf_counter()
                ds.flush()
                ds.load_seconds["replay_flush"] = time.perf_counter() - t0
        return ds

    @staticmethod
    def _entry_fp(meta: Dict) -> int:
        """Fingerprint of a manifest schema entry, stable across the JSON
        round trip: what :meth:`refresh_schema` compares to see whether the
        root's checkpoint moved under the journal."""
        return zlib.crc32(json.dumps(meta, sort_keys=True, separators=(",", ":"),
                                     default=str).encode()) & 0xFFFFFFFF

    def _attach_schema_entry(self, path: str, name: str, meta: Dict) -> None:
        """Create and fill one schema's store from its manifest entry, then
        re-scan the standing groups a replaced store held and register the
        entry's subscriptions under their ids. A subscription that no longer
        validates is skipped into the degradation trail, not raised."""
        self._attach_schema_data(path, name, meta)
        if self.standing is not None and self.standing.active(name):
            self.standing.reattach(name)
        for rec in meta.get("standing") or []:
            try:
                self._standing_engine().register(StandingSpec.from_dict(rec["spec"]),
                                                 sub_id=rec["sub_id"])
            except Exception as e:
                resilience.record_skip("standing.restore", f"{name}:{rec.get('sub_id')}", e,
                                       phase="load")

    def _attach_schema_data(self, path: str, name: str, meta: Dict) -> None:
        """Create and fill one schema's store from its manifest entry."""
        self._ckpt_fp[name] = self._entry_fp(meta)
        ft = FeatureType.from_spec(name, meta["spec"])
        prev = self.n_shards
        self.n_shards = meta.get("n_shards") or prev
        try:
            with self._replay_scope():  # not a new mutation: no record
                self.create_schema(ft)
        finally:
            self.n_shards = prev
        st = self._store(name)
        st.dicts = {k: DictionaryEncoder(v) for k, v in meta["dicts"].items() if k != _VIS}
        st.stats = {k: sk.Stat.from_json(v) for k, v in meta["stats"].items()}
        secs = self.load_seconds
        if "partitions" in meta:
            t0 = time.perf_counter()
            st.attach_snapshots({int(b): os.path.join(path, rel)
                                 for b, rel in meta["partitions"].items()})
            secs["partitions"] = secs.get("partitions", 0.0) + time.perf_counter() - t0
            return
        chunk_files = meta.get("chunks")
        if chunk_files is None:
            raise ValueError(f"{path}: schema {name!r} has neither chunks nor partitions "
                             "(the version-1 single-npz layout is not supported)")
        t0 = time.perf_counter()
        parts = []
        for rel in chunk_files:
            with np.load(os.path.join(path, rel), allow_pickle=False) as z:
                cols = {k: (z[k].astype(object) if z[k].dtype.kind == "U" else z[k])
                        for k in z.files}
            vis = cols.pop(_VIS, None)
            if vis is not None and np.any(vis):
                raise NotImplementedError(
                    f"{rel}: row visibilities: ROADMAP Queue 1, host layers")
            if cols:
                parts.append(ColumnBatch(cols, len(next(iter(cols.values())))))
        secs["chunks"] = secs.get("chunks", 0.0) + time.perf_counter() - t0
        if not parts:
            return
        t0 = time.perf_counter()
        # schema-derived fills: chunks saved before a column existed
        # null-fill by the layout's convention, not by a dtype guess
        st._all = ColumnBatch.concat(parts, fills=schema_null_fills(ft))
        if "epoch" in meta:
            st.mutation_epoch = meta["epoch"]
        key_cols = dict(st._all.columns)
        for ks in st.keyspaces:
            key_cols.update(ks.index_keys(ft, st._all.columns))
            st.tables[ks.name].rebuild(key_cols, st.dicts)
        # the key cache is seeded, so the next flush appends incrementally
        st._key_cols = {k: v for k, v in key_cols.items() if k not in st._all.columns}
        st.version += 1
        secs["tables"] = secs.get("tables", 0.0) + time.perf_counter() - t0

    def refresh_schema(self, name: str, path: str) -> bool:
        """Bring schema ``name`` up to what the root at ``path`` holds (a
        second dataset on a shared root catching up with a writer). With
        this dataset's journal on that root and the schema's manifest
        entry unchanged since it was attached, only the journal's records
        past the last one applied here replay. Otherwise: a schema only in
        the journal rebuilds from its records, one gone from the manifest
        is dropped, and a moved entry re-attaches in full and replays the
        records past it. Returns True when anything changed."""
        mpath = os.path.join(path, "manifest.json")
        schemas: Dict[str, Any] = {}
        if os.path.exists(mpath):
            with open(mpath) as fh:
                schemas = json.load(fh).get("schemas", {})
        meta = schemas.get(name)
        old = self._stores.get(name)
        j = self._journal
        use_journal = j is not None and os.path.abspath(j.root) == os.path.abspath(path)
        ckpt = int(meta.get("journal_seq", 0)) if meta is not None else 0
        if use_journal:
            have = self._applied_seq.get(name)
            unmoved = meta is None or self._ckpt_fp.get(name) == self._entry_fp(meta)
            if old is not None and have is not None and have >= ckpt and unmoved:
                applied = self._journal_replay({name: have}, schema=name)
                if applied and name in self._stores:
                    self.flush(name)
                return applied > 0
            if meta is None:
                # not checkpointed yet: the schema lives in the journal alone
                if old is not None:
                    with self._replay_scope():
                        self.delete_schema(name)
                applied = self._journal_replay({name: 0}, schema=name)
                if applied and name in self._stores:
                    self.flush(name)
                return applied > 0 or old is not None
        if meta is None:
            if old is None:
                return False
            with self._replay_scope():
                self.delete_schema(name)
            return True
        if old is not None:
            self.cache.store.invalidate(old.uid)
            del self._stores[name]
            self._forget(name)
        self._attach_schema_entry(path, name, meta)
        self._applied_seq[name] = ckpt
        if use_journal and self._journal_replay({name: ckpt}, schema=name) \
                and name in self._stores:
            self.flush(name)
        return True

    # -- writes -------------------------------------------------------------
    def insert(self, name: str, data: Dict[str, Any], fids=None,
               visibilities=None) -> int:
        """Append a batch of features; flush() (or a query) indexes them.
        ``fids``: one feature id per row (random 128-bit hex when None).
        Row visibilities are refused: nothing stores them yet."""
        if visibilities is not None:
            raise NotImplementedError(
                "row visibilities: ROADMAP Queue 1, host layers"
            )
        st = self._store(name)
        if self._journal is not None and not self._replaying:
            sink: list = []
            self._journal_rec(
                "insert", name, blobs=sink, data=_jr.enc_columns(data, sink),
                fids=None if fids is None else _jr.enc_value(fids, sink), vis=None)
        # the standing delta hook sees the encoded batch, the columns a
        # re-scan reads; it fires on journal replay too
        obs = None
        if self.standing is not None and self.standing.active(name):
            obs = lambda b: self.standing.on_batch(name, b.columns, b.n)  # noqa: E731
        return st.append(data, fids, observer=obs)

    def flush(self, name: Optional[str] = None) -> None:
        for st in ([self._store(name)] if name else self._stores.values()):
            st.flush()

    # -- queries ------------------------------------------------------------
    @staticmethod
    def _as_query(query) -> Query:
        q = Query(ecql=query) if isinstance(query, str) else query
        if not isinstance(q, Query):
            raise TypeError(f"query must be ECQL text or a Query, got {type(query)}")
        if q.auths is not None:
            raise NotImplementedError(f"query authorizations: {_HOST_LAYERS}")
        if q.srid is not None and q.srid != 4326:
            raise NotImplementedError(
                f"reprojecting results to EPSG:{q.srid}: {_HOST_LAYERS}")
        return q

    def _plan(self, name: str, query, explain: Optional[Explainer] = None) -> QueryPlan:
        """The plan of ECQL text or a ``Query`` under a ``plan`` span, cached
        per (query, store version, interceptor registry); its ``exec_path``
        describes the last call that ran it. A cached plan checks the
        guards again (a guard knob may have flipped since). A plan built
        for ``explain`` records its explain lines and is not cached."""
        # the per-query build window of the kernel registry's alert
        kreg.begin_query_window()
        with tracing.span("plan"):
            return self._plan_inner(name, query, explain)

    def _plan_inner(self, name: str, query, explain: Optional[Explainer]) -> QueryPlan:
        q = self._as_query(query)
        st = self._store(name)
        st.flush()
        key = None
        if explain is None:
            # the knobs planning reads key the cache too, so a scoped change
            # never serves a plan compiled under another setting
            key = (name, repr(q), id(st), st.version, config.LOOSE_BBOX.get(),
                   config.SCAN_RANGES_TARGET.get(), config.STRATEGY_DECIDER.get(),
                   interceptors.version())
            plan = self._plans.get(key)
            if plan is not None:
                guard(st, plan.key_plan, plan.filter)
                interceptors.apply_guards(st.ft, plan)
                return plan
        t0 = time.perf_counter()
        with metrics.registry().timer("query.plan").time():
            plan = plan_query(st, q.ecql, q.hints(), explain)
        if isinstance(q.ecql, str):
            # a plan of ECQL text can be reproduced from it: the
            # reference's ``cache_token`` (text, auths, effective filter:
            # an interceptor may rewrite the filter of the same text),
            # which keys the kernel registry and which a query-axis batch
            # requires of every member
            plan.__dict__["cache_token"] = (q.ecql, None, hash(repr(plan.filter)))
        plan.__dict__["plan_time_ms"] = (time.perf_counter() - t0) * 1e3
        if key is not None:
            if len(self._plans) >= 256:
                self._plans.clear()
            self._plans[key] = plan
        return plan

    def _fresh_plan(self, name: str, query) -> QueryPlan:
        """:meth:`_plan` with its per-call state cleared for a new call: the
        ``exec_path``, the device coarse mask's ms, the lake account and the
        ``degraded`` list of skipped partitions (a cached plan never reports
        an earlier call's skips). The audit after the call pops the last
        two."""
        plan = self._plan(name, query)
        plan.__dict__["exec_path"] = {}
        for k in ("device_coarse_ms", "lake_acct", "degraded"):
            plan.__dict__.pop(k, None)
        return plan

    # -- audit ----------------------------------------------------------------
    def _current_user(self) -> str:
        """The admitted user of the call on this thread (``geomesa.user``,
        else ``"anonymous"``; a dispatched ticket's user), "" outside one."""
        return self.serving.current_user() or ""

    @staticmethod
    def _plan_audit_extras(plan: QueryPlan) -> Dict[str, Any]:
        """Execution-path hints shared by every audit writer: the exec
        path, the device coarse mask's ms, the lake account and the
        degraded-partition account. Pops ``lake_acct`` and ``degraded``:
        a cached plan runs again, and each execution's accounts are
        reported once."""
        extras: Dict[str, Any] = {}
        path = plan.__dict__.get("exec_path")
        if path:
            extras["exec_path"] = {k: v for k, v in path.items() if v is not None}
        if "device_coarse_ms" in plan.__dict__:
            extras["device_coarse_ms"] = round(plan.__dict__["device_coarse_ms"], 3)
        acct = plan.__dict__.pop("lake_acct", None)
        if acct:
            extras["lake"] = dict(acct)
        degraded = plan.__dict__.pop("degraded", None)
        if degraded:
            extras["degraded"] = [
                {"part": d.part, "error": d.error, "phase": d.phase}
                for d in degraded
            ]
        return extras

    def _audit(self, name: str, q: Query, plan: QueryPlan, t_scan0: float,
               hits: int, op: str = "query") -> None:
        """One ``QueryEvent`` for a finished call, carrying the call's
        trace id when it is traced."""
        hints = {"op": op, "index": plan.index_name,
                 "max_features": q.max_features, "sampling": q.sampling}
        tid = tracing.current_trace_id()
        if tid is not None:
            hints["trace_id"] = tid
        hints.update(self._plan_audit_extras(plan))
        self.audit.record(
            name, plan.ecql, hints,
            plan.__dict__.get("plan_time_ms", 0.0),
            (time.perf_counter() - t_scan0) * 1e3, hits,
            user=self._current_user(),
            scanned=plan.__dict__.get("scanned_rows", 0),
            table_rows=plan.__dict__.get("table_rows", 0),
        )

    def _batch_audit(self, name: str, op: str, plans, hits, t0: float,
                     members, extra_hints=None, distinct: bool = True) -> None:
        """One ``QueryEvent`` per member of a query-axis batch: the shared
        scan cost and execution-path extras ride member 0, so sums over
        events never count twice. ``plans`` is per member, or of length 1
        when every member shares one plan (the curve crops); ``members``:
        optional per-member ``trace_id`` / ``user``; ``distinct`` marks
        distinct-literal batches."""
        scan_ms = (time.perf_counter() - t0) * 1e3
        extras = self._plan_audit_extras(plans[0])
        shared_plan = len(plans) != len(hits)
        for i in range(len(hits)):
            plan = plans[0] if shared_plan else plans[i]
            hints: Dict[str, Any] = {
                "op": op, "index": plan.index_name, "fused": True,
                "fused_batch": len(hits), "fused_member": i,
            }
            if distinct:
                hints["distinct"] = True
            if extra_hints:
                hints.update(extra_hints)
            m = members[i] if members is not None else {}
            tid = m.get("trace_id") or tracing.current_trace_id()
            if tid is not None:
                hints["trace_id"] = tid
            if m.get("user"):
                hints["user"] = m["user"]
            if i == 0:
                hints.update(extras)
            self.audit.record(
                name, plan.ecql, hints,
                plan.__dict__.get("plan_time_ms", 0.0) if i == 0 else 0.0,
                scan_ms if i == 0 else 0.0,
                int(hits[i]),
                user=m.get("user") or self._current_user(),
                scanned=plan.__dict__.get("scanned_rows", 0) if i == 0 else 0,
                table_rows=plan.__dict__.get("table_rows", 0),
            )

    # -- explain ------------------------------------------------------------
    @_traced("explain")
    def explain(self, name: str, query, analyze: bool = False, region=None) -> str:
        """The planner's explain tree, then the query's posture: the
        aggregate cache's decomposition, the hierarchy's resident cells,
        the warm path, tracing, and the call's cost ledger.
        ``analyze=True`` also runs a count and reports selectivity (window
        candidates against matches) and the execution path. ``region``:
        optional polygon, folded in as the aggregates fold it."""
        from geomesa_tpu_torch.cache import decompose, decompose_region
        from geomesa_tpu_torch.cache import hierarchy as _hier

        exp = Explainer(enabled=True)
        st = self._store(name)
        q0 = self._as_query(self._with_region(name, query, region))
        plan = self._plan(name, q0, exp)
        # the cache's participation: served from / populating the
        # aggregate cache, and in what shape
        exp.push("Aggregate cache")
        exp.kv("enabled", bool(config.CACHE_ENABLED.to_bool()))
        d = decompose(plan.filter, st.ft)
        if d is not None:
            exp.kv("partial-cover", f"level {d.level}, "
                   f"{len(d.cells)} interior cells, "
                   f"{len(d.strips)} boundary strips")
            exp.kv("residual filter", d.residual_key)
        else:
            dr = decompose_region(plan.filter, st.ft)
            if dr is not None:
                exp.kv("polygon cover", f"level {dr.level}, "
                       f"{len(dr.cells)} interior cells, "
                       f"{len(dr.boundary)} boundary cells")
                exp.kv("residual filter", dr.residual_key)
            else:
                exp.line("partial-cover: not decomposable "
                         "(whole-result caching only)")
        exp.pop()
        # hierarchical pre-aggregation: would the query's cells come from
        # the quadtree, and from which levels
        exp.push("Hierarchy")
        exp.kv("enabled", _hier.enabled())
        exp.kv("depth", _hier.depth())
        probe = self.cache.probe_cover(self, st, q0, plan) if _hier.enabled() else None
        if probe is not None:
            served = sum(probe["levels"].values())
            exp.kv(
                "cells resident/assemblable",
                f"{served}/{probe['cells']}"
                + (f" ({probe['boundary']} boundary cells scan exactly)"
                   if probe["kind"] == "polygon" else ""),
            )
            if probe["levels"]:
                exp.kv("levels hit", ", ".join(
                    f"L{lvl}={n}" for lvl, n in sorted(probe["levels"].items())))
            exp.kv("residual fraction", probe["residual_fraction"])
        else:
            exp.line("no cell cover for this query (whole-result only)")
        exp.pop()
        # the warm path: shape buckets, the shared registry of scan
        # callables (its builds are the reference's traces) and the alert
        exp.push("Warm path")
        floor = config.COMPACT_BUCKET_FLOOR.to_int()
        exp.kv("shape bucketing",
               f"on (K floor {8 if floor is None else floor})"
               if config.COMPACT_BUCKETING.to_bool() else "off")
        reg = self._executor(name).kernel_registry()
        tr = reg.traces()
        exp.kv("kernel registry",
               f"{len(reg)} compiled kernels, {sum(tr.values())} traces to date")
        if tr:
            exp.kv("traces by site", ", ".join(
                f"{site}={n}" for site, n in sorted(tr.items(), key=lambda kv: -kv[1])[:8]))
        thr = kreg.alert_threshold()
        over = {s: n for s, n in kreg.query_recompiles().items() if n > thr}
        exp.kv("recompile alert",
               f"TRIPPED ({', '.join(f'{s}={n}' for s, n in sorted(over.items()))})"
               if over else f"clear (threshold {thr}/query)")
        exp.kv("prefetch pipeline", bool(config.PIPELINE_PREFETCH.to_bool()))
        exp.kv("persistent compile cache", config.COMPILE_CACHE_DIR.get() or "off")
        exp.pop()
        # tracing: the trace id is this explain call's own (explain writes
        # no audit event)
        exp.push("Observability")
        exp.kv("tracing", "on" if tracing.enabled() else "off")
        tid = tracing.current_trace_id()
        if tid is not None:
            exp.kv("trace_id (this explain call)", tid)
        slow = config.TRACE_SLOW_MS.get()
        exp.kv("slow-query threshold", f"{slow} ms" if slow else "off")
        exp.pop()
        if analyze:
            plan.__dict__["exec_path"] = {}
            matched = self._executor(name).count(plan)
            scanned = plan.__dict__.get("scanned_rows", 0)
            total = plan.__dict__.get("table_rows", 0)
            exp.push("Selectivity (analyze)")
            exp.line(f"Table rows: {total}")
            exp.line(f"Window candidates (scanned): {scanned}")
            exp.line(f"Matched: {matched}")
            if scanned:
                exp.line(f"Match ratio: {matched / scanned:.4f}")
            if "device_coarse_ms" in plan.__dict__:
                exp.line(
                    "Device coarse kernel: "
                    f"{plan.__dict__['device_coarse_ms']:.3f} ms "
                    "(host refined candidates only)"
                )
            path = plan.__dict__.get("exec_path")
            if path:
                exp.push("Execution path")
                for k, v in path.items():
                    if v is not None:
                        exp.line(f"{k}: {v}")
                # achieved scan bandwidth of the device coarse mask, when
                # one ran
                ms = plan.__dict__.get("device_coarse_ms")
                if ms and scanned:
                    n_cols = len(plan.compiled.columns) or 1
                    gbs = scanned * n_cols * 4 / (ms * 1e-3) / 1e9
                    exp.line(f"achieved scan bandwidth: {gbs:.1f} GB/s "
                             f"({scanned} rows x {n_cols} f32 cols)")
                exp.pop()
            exp.pop()
        # this explain call's cost ledger (filled by analyze's count)
        exp.push("Cost")
        cost = tracing.current_cost()
        if cost:
            for k, v in sorted(cost.items()):
                exp.kv(k, round(v, 3))
        else:
            exp.line("(none recorded — enable geomesa.trace.enabled and "
                     "analyze=True for device/partition attribution)")
        exp.pop()
        return str(exp)

    @staticmethod
    def _timeout_s() -> Optional[float]:
        """``geomesa.query.timeout`` in seconds (None: unlimited)."""
        ms = config.QUERY_TIMEOUT.to_duration_ms()
        return ms / 1000.0 if ms is not None else None

    def _cache_args(self, name: str, query):
        """(store, Query, fresh plan): what the aggregate cache is handed.
        Its exec-path notes land on the plan :meth:`_plan` returns."""
        q = self._as_query(query)
        return self._store(name), q, self._fresh_plan(name, q)

    def _with_region(self, name: str, query, region):
        """Fold a polygon ``region`` (WKT text or a geometry object) into
        the query as one INTERSECTS conjunct on the schema's geometry.
        Composed as ECQL text when the query is textual, so the plan cache
        sees the polygon."""
        if region is None:
            return query
        geom = self._store(name).ft.geom_field
        if geom is None:
            raise ValueError(f"schema {name!r} has no geometry field")
        wkt = region if isinstance(region, str) else region.wkt()
        geo.parse_wkt(wkt)  # validate before it reaches the planner
        conjunct = f"INTERSECTS({geom}, {wkt})"
        q = query if isinstance(query, Query) else Query(ecql=query)
        if not isinstance(q.ecql, str):
            combined = ir.And((q.ecql, parse_ecql(conjunct)))
        elif q.ecql.strip().upper() == "INCLUDE":
            combined = conjunct
        else:
            combined = f"({q.ecql}) AND {conjunct}"
        q = dataclasses.replace(q, ecql=combined)
        return q if isinstance(query, Query) or not isinstance(combined, str) \
            else combined

    @_traced("count", speculative="_speculative_count")
    def count(self, name: str, query="INCLUDE", exact: bool = True,
              region=None) -> int:
        """Feature count of ``query``: exact, or (``exact=False``) the
        planner's estimate from the write-time sketches, with no scan.
        ``region``: optional polygon (WKT or geometry) clipping the count
        (see :meth:`_with_region`). ``speculative_ok=True`` (keyword): a
        count that admission sheds returns the planner's estimate, with an
        audit event marked ``speculative``, instead of raising."""
        st, q, plan = self._cache_args(name, self._with_region(name, query, region))
        if not exact:
            return int(plan.est_count)
        t0 = time.perf_counter()
        with query_deadline(self._timeout_s()):
            n = self.cache.count(self, st, q, plan)
        self._audit(name, q, plan, t0, n, op="count")
        return n

    @_traced("density", speculative="_speculative_density")
    def density(self, name: str, query="INCLUDE", bbox=None, width: int = 256,
                height: int = 256, weight: Optional[str] = None,
                region=None) -> np.ndarray:
        """(height, width) f32 heatmap of ``query`` over ``bbox`` (default:
        the data's bounds), optionally summing the ``weight`` attribute.
        ``region``: optional polygon clipping the aggregate.
        ``speculative_ok=True``: a shed density returns the coarse grid of
        :meth:`_speculative_density`."""
        st, q, plan = self._cache_args(name, self._with_region(name, query, region))
        if bbox is None:
            bbox = self.bounds(name) or (-180, -90, 180, 90)
        t0 = time.perf_counter()
        with metrics.registry().timer("query.density").time(), \
                query_deadline(self._timeout_s()):
            grid = self.cache.density(self, st, q, plan, tuple(bbox), width, height, weight)
        self._audit(name, q, plan, t0, int(np.count_nonzero(grid)), op="density")
        return grid

    # -- speculative answers to a shed call: host reads only ---------------------
    def _speculative_audit(self, name: str, plan: QueryPlan, op: str, hits: int,
                           extra: Optional[Dict[str, Any]] = None) -> None:
        """The audit marker of every speculative answer (``speculative`` and
        ``shed``), so each coarse answer served under load stands apart."""
        metrics.inc(metrics.SERVING_SPECULATIVE)
        hints: Dict[str, Any] = {"op": op, "index": plan.index_name,
                                 "speculative": True, "shed": True}
        if extra:
            hints.update(extra)
        tid = tracing.current_trace_id()
        if tid is not None:
            hints["trace_id"] = tid
        self.audit.record(name, plan.ecql, hints, plan.__dict__.get("plan_time_ms", 0.0),
                          0.0, hits, user=self._current_user())

    def _speculative_count(self, name: str, query="INCLUDE", exact: bool = True,
                           region=None) -> int:
        """The planner's estimate of a shed :meth:`count`: no device work."""
        _, _, plan = self._cache_args(name, self._with_region(name, query, region))
        est = int(plan.est_count)
        self._speculative_audit(name, plan, "count", est)
        return est

    def _speculative_density(self, name: str, query="INCLUDE", bbox=None, width: int = 256,
                             height: int = 256, weight: Optional[str] = None,
                             region=None) -> np.ndarray:
        """A coarse grid for a shed :meth:`density`, from host reads only:
        resident cache / hierarchy count cells splat their exact counts
        evenly over their footprint, the uncovered cells share the rest of
        the planner's estimate, and a query with no cell cover splats the
        whole estimate over the bbox. A weighted density has no such form
        (the cells hold counts), so it stays shed."""
        if weight is not None:
            raise resilience.DeadlineShedError(
                "[GM-SHED] weighted density has no speculative form "
                "(resident cells hold counts, not weight sums)")
        st, q, plan = self._cache_args(name, self._with_region(name, query, region))
        if bbox is None:
            bbox = self.bounds(name) or (-180, -90, 180, 90)
        bbox = tuple(float(v) for v in bbox)
        grid = np.zeros((height, width), np.float32)
        est = float(plan.est_count)
        got = self.cache.speculative_cells(self, st, q, plan)

        def splat(box, value):
            # value spread evenly over box ∩ bbox, in whole pixels
            x0, y0, x1, y1 = box
            sx = width / max(bbox[2] - bbox[0], 1e-12)
            sy = height / max(bbox[3] - bbox[1], 1e-12)
            c0 = int(np.clip(np.floor((x0 - bbox[0]) * sx), 0, width))
            c1 = int(np.clip(np.ceil((x1 - bbox[0]) * sx), 0, width))
            r0 = int(np.clip(np.floor((y0 - bbox[1]) * sy), 0, height))
            r1 = int(np.clip(np.ceil((y1 - bbox[1]) * sy), 0, height))
            if c1 > c0 and r1 > r0 and value > 0:
                grid[r0:r1, c0:c1] += np.float32(value / ((r1 - r0) * (c1 - c0)))

        resident_cells = 0
        if got is not None:
            from geomesa_tpu_torch.cache.cells import cell_box

            decomp, resident, missing = got
            resident_cells = len(resident)
            served = 0
            for cell, n in resident:
                splat(cell_box(decomp.level, *cell), float(n))
                served += n
            remainder = max(est - served, 0.0)
            uncovered = len(missing) + decomp.residual_count()
            if uncovered and remainder > 0:
                for cell in missing:
                    splat(cell_box(decomp.level, *cell), remainder / uncovered)
        else:
            splat(bbox, est)
        self._speculative_audit(name, plan, "density", int(np.count_nonzero(grid)),
                                {"resident_cells": resident_cells})
        return grid

    # -- curve-aligned density ------------------------------------------------
    @_traced("density_curve")
    def density_curve(self, name: str, query="INCLUDE", level: int = 9, bbox=None,
                      weight: Optional[str] = None, region=None):
        """Exact density over the Morton-block grid at ``level`` (a global
        2^level x 2^level partition of lon / lat, which the EPSG:4326 tile
        pyramid aligns with): ``(grid, snapped_bbox)``, the grid covering
        the blocks that intersect ``bbox`` (default: the data's bounds),
        row 0 at the south edge. Per-block counts are prefix-sum
        differences over the z2-sorted scan (the z2 index is forced), with
        no scatter. ``region``: optional polygon clipping the aggregate."""
        if not 0 < level <= 15:
            raise ValueError("level must be in 1..15 (grid = 4^level blocks)")
        q = dataclasses.replace(
            self._as_query(self._with_region(name, query, region)), index="z2")
        st, q, plan = self._cache_args(name, q)
        if bbox is None:
            bbox = self.bounds(name) or (-180.0, -90.0, 180.0, 90.0)
        window, snapped = self._snap_blocks(bbox, level)
        t0 = time.perf_counter()
        with metrics.registry().timer("query.density").time(), \
                query_deadline(self._timeout_s()):
            grid = self.cache.density_curve(self, st, q, plan, level, window, weight)
        self._audit(name, q, plan, t0, int(np.count_nonzero(grid)), op="density_curve")
        return grid, snapped

    @staticmethod
    def _snap_blocks(bbox, level: int):
        """Snap a bbox outward to the level-``level`` block grid:
        ``((ix0, iy0, ix1, iy1), snapped_bbox)``. Floor on both edges: an
        edge exactly on a block boundary includes the block containing it,
        as the inclusive BBOX filter does."""
        n_blocks = 1 << level
        fx = lambda v: (v + 180.0) / 360.0 * n_blocks  # noqa: E731
        fy = lambda v: (v + 90.0) / 180.0 * n_blocks  # noqa: E731
        ix0 = int(np.clip(np.floor(fx(bbox[0])), 0, n_blocks - 1))
        ix1 = int(np.clip(np.floor(fx(bbox[2])), ix0, n_blocks - 1))
        iy0 = int(np.clip(np.floor(fy(bbox[1])), 0, n_blocks - 1))
        iy1 = int(np.clip(np.floor(fy(bbox[3])), iy0, n_blocks - 1))
        snapped = (
            ix0 * 360.0 / n_blocks - 180.0,
            iy0 * 180.0 / n_blocks - 90.0,
            (ix1 + 1) * 360.0 / n_blocks - 180.0,
            (iy1 + 1) * 180.0 / n_blocks - 90.0,
        )
        return (ix0, iy0, ix1, iy1), snapped

    def _curve_windows(self, name: str, bboxes, level: int):
        """(block windows, snapped bboxes) of ``bboxes``; a None bbox takes
        the data's bounds."""
        default = None
        windows, snaps = [], []
        for bb in bboxes:
            if bb is None:
                if default is None:
                    default = self.bounds(name) or (-180.0, -90.0, 180.0, 90.0)
                bb = default
            w, snapped = self._snap_blocks(bb, level)
            windows.append(w)
            snaps.append(snapped)
        return windows, snaps

    @staticmethod
    def _check_members(members, n: int, what: str = "queries") -> None:
        """``members`` (per-member metadata of the reference's audit, which
        the port does not keep) must align with the batch."""
        if members is not None and len(members) != n:
            raise ValueError(f"members must align with {what}")

    def density_curve_batch(self, name: str, query="INCLUDE", level: int = 9,
                            bboxes=(), weight: Optional[str] = None,
                            members: Optional[List[Dict[str, Any]]] = None):
        """N block-aligned crops of ONE filter in one scan: the mask and the
        prefix sum are shared, each crop costs its gathers, and each equals
        :meth:`density_curve` of its bbox. ``[(grid, snapped_bbox), ...]``
        in ``bboxes`` order (a None bbox takes the data's bounds)."""
        if not 0 < level <= 15:
            raise ValueError("level must be in 1..15 (grid = 4^level blocks)")
        bboxes = list(bboxes)
        self._check_members(members, len(bboxes), "bboxes")
        with tracing.start("density_curve_batch", schema=name, batch=len(bboxes)), \
                self.serving.admit("density_curve"):
            plan = self._fresh_plan(name, dataclasses.replace(self._as_query(query), index="z2"))
            windows, snaps = self._curve_windows(name, bboxes, level)
            t0 = time.perf_counter()
            with metrics.registry().timer("query.density").time(), \
                    query_deadline(self._timeout_s()):
                grids = self._executor(name).density_curve_batch(plan, level, windows, weight)
            # one event per member; every member shares the one plan
            self._batch_audit(name, "density_curve", [plan],
                              [int(np.count_nonzero(g)) for g in grids], t0, members,
                              extra_hints={"level": level}, distinct=False)
            return list(zip(grids, snaps))

    def density_curve_filter_batch(self, name: str, queries, level: int = 9, bboxes=None,
                                   weight: Optional[str] = None,
                                   members: Optional[List[Dict[str, Any]]] = None):
        """M block-aligned crops with DISTINCT filters (each member its own
        viewport literals and crop window) in one batched call, or None
        when the members do not share a batchable structural template.
        ``[(grid, snapped_bbox), ...]`` in member order, each grid equal to
        its serial :meth:`density_curve`."""
        if not 0 < level <= 15:
            raise ValueError("level must be in 1..15 (grid = 4^level blocks)")
        if not queries:
            return []
        self._check_members(members, len(queries))
        bboxes = list(bboxes) if bboxes is not None else [None] * len(queries)
        if len(bboxes) != len(queries):
            raise ValueError("bboxes must align with queries")
        qs = [dataclasses.replace(self._as_query(q), index="z2") for q in queries]
        with tracing.start("density_curve_filter_batch", schema=name, batch=len(qs)), \
                self.serving.admit("density_curve"):
            plans, spec = self._batch_plans(name, qs)
            if spec is None:
                return None
            windows, snaps = self._curve_windows(name, bboxes, level)
            t0 = time.perf_counter()
            with metrics.registry().timer("query.density").time(), \
                    query_deadline(self._timeout_s()):
                grids = self._executor(name).density_curve_filter_batch(
                    plans, spec, level, windows, weight)
            if grids is None:
                return None
            self._batch_audit(name, "density_curve", plans,
                              [int(np.count_nonzero(g)) for g in grids], t0, members,
                              extra_hints={"level": level})
            return list(zip(grids, snaps))

    # -- query-axis batches: M distinct viewports of one structural query
    # shape in one batched call. Each returns None when the members cannot
    # share it (the caller runs them one at a time), so batching changes
    # latency, never results. -------------------------------------------------
    def _batch_plans(self, name: str, queries):
        """Every member's plan and the batch spec (None when the members do
        not share a batchable structural template). Members near an index
        cost boundary may plan onto different tables; the minority is
        re-planned onto the majority's index (any candidate index gives the
        same answers), and a member that index cannot serve leaves the spec
        None."""
        qs = [self._as_query(q) for q in queries]
        plans = [self._fresh_plan(name, q) for q in qs]
        names = [p.index_name for p in plans]
        if len(set(names)) > 1:
            maj = Counter(names).most_common(1)[0][0]
            for i, (q, p) in enumerate(zip(qs, plans)):
                if p.index_name != maj:
                    try:
                        plans[i] = self._fresh_plan(name, dataclasses.replace(q, index=maj))
                    except ValueError:
                        return plans, None
        return plans, build_spec(self._store(name), plans)

    def count_batch(self, name: str, queries, exact: bool = True,
                    members: Optional[List[Dict[str, Any]]] = None):
        """M distinct exact counts in one batched call, or None when the
        members do not share a structural template (and for
        ``exact=False``: estimates never scan). Each member's value equals
        its serial :meth:`count`."""
        if not queries:
            return []
        if not exact:
            return None
        self._check_members(members, len(queries))
        with tracing.start("count_batch", schema=name, batch=len(queries)), \
                self.serving.admit("count"):
            plans, spec = self._batch_plans(name, queries)
            if spec is None:
                return None
            t0 = time.perf_counter()
            with query_deadline(self._timeout_s()):
                res = self._executor(name).count_batch(plans, spec)
            if res is None:
                return None
            metrics.inc(metrics.SERVING_FUSED_DISTINCT, len(res))
            self._batch_audit(name, "count", plans, res, t0, members)
            return res

    def density_batch(self, name: str, queries, bboxes=None, width: int = 256,
                      height: int = 256, weight: Optional[str] = None,
                      members: Optional[List[Dict[str, Any]]] = None):
        """M distinct heatmaps, each over its own query and grid bbox, in one
        batched call, or None when ineligible. ``bboxes`` aligns with
        ``queries`` (a None entry takes the data's bounds, as
        :meth:`density`)."""
        if not queries:
            return []
        self._check_members(members, len(queries))
        bboxes = list(bboxes) if bboxes is not None else [None] * len(queries)
        if len(bboxes) != len(queries):
            raise ValueError("bboxes must align with queries")
        with tracing.start("density_batch", schema=name, batch=len(queries)), \
                self.serving.admit("density"):
            plans, spec = self._batch_plans(name, queries)
            if spec is None:
                return None
            default = None
            boxes = []
            for bb in bboxes:
                if bb is None:
                    if default is None:
                        default = self.bounds(name) or (-180, -90, 180, 90)
                    bb = default
                boxes.append(tuple(bb))
            t0 = time.perf_counter()
            with metrics.registry().timer("query.density").time(), \
                    query_deadline(self._timeout_s()):
                grids = self._executor(name).density_batch(plans, spec, boxes, width,
                                                           height, weight)
            if grids is None:
                return None
            metrics.inc(metrics.SERVING_FUSED_DISTINCT, len(grids))
            self._batch_audit(name, "density", plans,
                              [int(np.count_nonzero(g)) for g in grids], t0, members)
            return grids

    def stats_batch(self, name: str, stat_spec: str, queries,
                    members: Optional[List[Dict[str, Any]]] = None):
        """M distinct stats scans of one spec in one batched call, or None
        when ineligible (descriptive leaves, a leaf without a device
        reduction, surviving f32 band rows, or no shared template). The
        members' Stat objects are parsed fresh here, so a batch abandoned
        midway never leaks into a caller's serial rerun."""
        if not queries:
            return []
        self._check_members(members, len(queries))
        with tracing.start("stats_batch", schema=name, batch=len(queries)), \
                self.serving.admit("stats"):
            stats = [parse_stat(stat_spec) for _ in queries]
            plans, spec = self._batch_plans(name, queries)
            if spec is None:
                return None
            t0 = time.perf_counter()
            with query_deadline(self._timeout_s()):
                out = self._executor(name).stats_batch(plans, spec, stats)
            if out is None:
                return None
            metrics.inc(metrics.SERVING_FUSED_DISTINCT, len(out))
            self._batch_audit(name, "stats", plans, [0] * len(out), t0, members,
                              extra_hints={"stat": stat_spec})
            return out

    @_traced("query")
    def query(self, name: str, query="INCLUDE") -> FeatureCollection:
        """Matching features. A sorted query with ``0 < max_features <=``
        ``geomesa.topk.max`` (0 disables) first selects candidates on the device by the
        primary sort key (every boundary tie included when there are more
        keys), and the host gathers and sorts only those; then, as the
        reference, sort -> limit -> projection."""
        q = self._as_query(query)
        plan = self._fresh_plan(name, q)
        st = self._store(name)
        t0 = time.perf_counter()
        ex = self._executor(name)
        with metrics.registry().timer("query.scan").time(), \
                query_deadline(self._timeout_s()):
            batch = self._query_scan(q, plan, st, ex)
        self._audit(name, q, plan, t0, batch.n)
        if q.sort_by and batch.n:
            batch = _sort_batch(batch, q.sort_by, st.dicts)
        if q.max_features is not None and batch.n > q.max_features:
            batch = ColumnBatch(
                {k: v[: q.max_features] for k, v in batch.columns.items()},
                q.max_features,
            )
        if q.properties:
            batch = _project(batch, q.properties)
        return FeatureCollection(st.ft, batch, st.dicts)

    @staticmethod
    def _query_scan(q: Query, plan: QueryPlan, st, ex) -> ColumnBatch:
        """The scan half of :meth:`query`: the device top-k candidates of a
        sorted, limited query, else every match."""
        batch = None
        topk_max = config.TOPK_MAX.to_int() or 0
        if q.sort_by and q.max_features is not None and 0 < q.max_features <= topk_max:
            attr, desc = q.sort_by[0]
            names = None
            if q.properties:
                names = list(q.properties) + [a for a, _ in q.sort_by]
            ties = len(q.sort_by) > 1
            if isinstance(ex, PartitionedExecutor):
                # each partition's candidates; query()'s exact sort finishes
                batch = ex.top_batch(plan, attr, desc, q.max_features, names,
                                     include_ties=ties)
            else:
                pos = ex.top_rows(plan, attr, desc, q.max_features, include_ties=ties)
                if pos is not None:
                    batch = st.tables[plan.index_name].gather_sorted(pos, names)
            if batch is not None:
                plan.exec_path["sort"] = f"device-topk(k={q.max_features})"
        return ex.features(plan) if batch is None else batch

    def query_batches(self, name: str, query="INCLUDE",
                      batch_rows: Optional[int] = None):
        """Query results as ColumnBatch chunks. A sorted query yields one
        materialized batch (a global sort needs every row); otherwise the
        plan is made now (so a bad query raises here) and the chunks of the
        executor's ``features_iter`` are projected one by one (a
        partitioned store yields partition at a time)."""
        q = self._as_query(query)
        if q.sort_by:
            fc = self.query(name, q)
            return iter([fc.batch] if fc.batch.n else [])
        # the root span is opened and closed by hand (adopt + finish): it
        # covers the consumer-driven iteration, which outlives this frame
        root = tracing.start("query_batches", schema=name)
        traced = root is not tracing.NOOP
        prev = tracing.snapshot()
        if traced:
            root.t0 = time.perf_counter()
            tracing.adopt(root)
        try:
            # admission covers the eager planning; the stream body runs as
            # the consumer iterates
            with self.serving.admit("query_batches"):
                plan = self._fresh_plan(name, q)
        except BaseException:
            # the stream, which owns the finish, never runs
            if traced:
                root.finish()
            raise
        finally:
            if traced:
                tracing.adopt(prev)  # restore any enclosing span
        ex = self._executor(name)

        def chunks():
            t0 = time.perf_counter()
            hits = 0
            iter_prev = tracing.snapshot()  # the consumer thread's context
            if traced:
                tracing.adopt(root)
            try:
                with metrics.registry().timer("query.scan").time(), \
                        query_deadline(self._timeout_s()):
                    for batch in ex.features_iter(plan, batch_rows):
                        hits += batch.n
                        yield _project(batch, q.properties) if q.properties else batch
                self._audit(name, q, plan, t0, hits)
            finally:
                if traced:
                    root.finish()
                    tracing.adopt(iter_prev)

        return chunks()

    def sample(self, name: str, one_in_n: int, query="INCLUDE") -> FeatureCollection:
        """1-in-``one_in_n`` of the matches (``query`` with ``sampling``)."""
        return self.query(name, dataclasses.replace(self._as_query(query),
                                                    sampling=one_in_n))

    def bounds(self, name: str) -> Optional[Tuple[float, float, float, float]]:
        """Geometry bounds of the schema's rows (None when empty), from the
        write-time ``bounds`` sketch."""
        st = self._store(name)
        st.flush()
        return st.bounds()

    # -- stats -------------------------------------------------------------
    @_traced("stats", speculative="_speculative_stats")
    def stats(self, name: str, stat_spec: str, query="INCLUDE",
              region=None) -> sk.Stat:
        """Exact statistics of the matches, from the stat DSL
        (``Count();MinMax(a);Histogram(a,bins,lo,hi);...``). ``region``:
        optional polygon clipping the matches. ``speculative_ok=True``: a
        shed call returns :meth:`_speculative_stats`."""
        st, q, plan = self._cache_args(name, self._with_region(name, query, region))
        parse_stat(stat_spec)  # validate the spec before any scan
        t0 = time.perf_counter()
        with query_deadline(self._timeout_s()):
            out = self.cache.stats(self, st, q, plan, stat_spec)
        self._audit(name, q, plan, t0, 0, op="stats")
        return out

    def _speculative_stats(self, name: str, stat_spec: str, query="INCLUDE",
                           region=None) -> sk.Stat:
        """A shed :meth:`stats` from the write-time sketches, host reads
        only: a ``Count`` leaf reads the store's count (unfiltered) or the
        planner's estimate, a ``MinMax`` of an indexed attribute or of the
        date reads its sketch, and other leaves stay empty. The result has
        the spec's shape; the audit marker tells it apart."""
        st, _, plan = self._cache_args(name, self._with_region(name, query, region))
        stat = parse_stat(stat_spec)
        leaves = stat.stats if isinstance(stat, sk.SeqStat) else [stat]
        served = 0
        for leaf in leaves:
            if isinstance(leaf, sk.CountStat):
                leaf.count = int(st.count if isinstance(plan.filter, ir.Include)
                                 else plan.est_count)
                served += 1
            elif isinstance(leaf, sk.MinMax):
                mm = st.stats.get(f"minmax-{leaf.attribute}")
                if mm is None and leaf.attribute == st.ft.dtg_field:
                    mm = st.stats.get("time-bounds")
                if isinstance(mm, sk.MinMax) and not mm.is_empty:
                    leaf.merge(mm)
                    served += 1
        self._speculative_audit(name, plan, "stats", 0,
                                {"stat": stat_spec, "served_leaves": served})
        return stat

    def unique(self, name: str, attribute: str, query="INCLUDE") -> List:
        """Distinct values, sorted (None last)."""
        vals = list(self.stats(name, f"Enumeration({attribute})", query).value())
        return sorted(vals, key=lambda v: (v is None, v))

    def min_max(self, name: str, attribute: str, query="INCLUDE",
                exact: bool = True):
        """``{"min", "max", "cardinality"}`` of an attribute. ``exact=False``
        reads the write-time sketch of an indexed attribute (no scan)."""
        if not exact:
            st = self._store(name)
            st.flush()
            mm = st.stats.get(f"minmax-{attribute}")
            if isinstance(mm, sk.MinMax) and not mm.is_empty:
                return mm.value()
        return self.stats(name, f"MinMax({attribute})", query).value()

    def histogram(self, name: str, attribute: str, bins: int = 20,
                  bounds: Optional[Tuple[float, float]] = None,
                  query="INCLUDE") -> sk.Histogram:
        """Binned histogram; ``bounds`` default to the attribute's min /
        max (the write-time sketch when there is one)."""
        if bounds is None:
            mm = self.min_max(name, attribute, query, exact=False)
            if not mm or mm.get("min") is None:
                raise ValueError(f"no data to bound histogram on {attribute!r}")
            bounds = (float(mm["min"]), float(mm["max"]))
        lo, hi = bounds
        if hi <= lo:
            hi = lo + 1.0
        return self.stats(name, f"Histogram({attribute},{bins},{lo},{hi})", query)

    def frequency(self, name: str, attribute: str, width: int = 256,
                  query="INCLUDE") -> sk.Frequency:
        """Count-min frequency sketch."""
        return self.stats(name, f"Frequency({attribute},{width})", query)

    def top_k(self, name: str, attribute: str, k: int = 10,
              query="INCLUDE") -> List:
        """The k most frequent values with their counts."""
        return self.stats(name, f"TopK({attribute},{k})", query).value()

    # -- joins -------------------------------------------------------------
    def spatial_join(self, points: str, polygons, query="INCLUDE",
                     weight: Optional[str] = None):
        """Point-in-polygon join of ``points`` against ``polygons`` (see
        ``processes.spatial_join``): (assign int32 per row, counts f32 per
        polygon)."""
        from geomesa_tpu_torch import processes

        return processes.spatial_join(self, points, polygons, query, weight)

    def join(self, left: str, right: str, left_attr: Optional[str] = None,
             right_attr: Optional[str] = None, left_query="INCLUDE",
             right_query="INCLUDE", *, predicate: Optional[str] = None,
             distance=None, dx=None, dy=None, level: Optional[int] = None):
        """Join two schemas. With ``left_attr``/``right_attr``: the
        attribute equi-join (a ColumnBatch). With ``predicate``: the spatial
        join of :meth:`join_spatial` — ``"bbox"`` (envelopes of half-widths
        ``dx``/``dy`` intersect), ``"dwithin"`` (planar degree
        ``distance``), ``"dwithin_meters"`` (great-circle ``distance``
        meters) between point schemas, or ``"pip"`` / ``"poly_bbox"``
        against a polygon schema — returning a :class:`SpatialJoinResult`."""
        if predicate is None:
            if left_attr is None or right_attr is None:
                raise ValueError(
                    "join needs left_attr/right_attr (equi-join) or "
                    "predicate= (spatial join)"
                )
            from geomesa_tpu_torch import processes

            return processes.join(self, left, right, left_attr, right_attr,
                                  left_query, right_query)
        return self.join_spatial(
            left, right, predicate=predicate, distance=distance, dx=dx,
            dy=dy, left_query=left_query, right_query=right_query,
            level=level,
        )

    def _join_sides(self, left: str, right: str, left_query, right_query,
                    right_polygon: bool = False):
        """Plan and scan both join sides (each under its own filter),
        validating the geometry contract: both sides POINT, except polygon
        joins (``right_polygon``), whose right side must be a POLYGON or
        MULTIPOLYGON schema."""
        lplan = self._fresh_plan(left, left_query)
        lst = self._store(left)
        rplan = self._fresh_plan(right, right_query)
        rst = self._store(right)
        for st_, nm, poly in ((lst, left, False), (rst, right, right_polygon)):
            g = st_.ft.geom_field
            a = None if g is None else st_.ft.attr(g)
            if poly:
                if a is None or a.type not in ("polygon", "multipolygon"):
                    raise ValueError(
                        f"[GM-ARG] polygon join requires a POLYGON "
                        f"geometry on schema {nm!r}"
                    )
            elif a is None or not a.is_point:
                raise ValueError(
                    f"[GM-ARG] spatial join requires a POINT geometry "
                    f"on schema {nm!r}"
                )
        with tracing.span("scan.join.sides"):
            lbatch = self._executor(left).features(lplan)
            rbatch = self._executor(right).features(rplan)
        return lst, lplan, lbatch, rst, rbatch

    @staticmethod
    def _side_xy(st: FeatureStore, batch: ColumnBatch):
        g = st.ft.geom_field
        z = np.zeros(0, np.float64)
        return (batch.columns.get(g + "__x", z),
                batch.columns.get(g + "__y", z))

    @staticmethod
    def _side_polygons(st: FeatureStore, batch: ColumnBatch):
        """The polygon side's geometries, parsed from the schema's host
        WKT column (row order == batch order, so pair indices line up)."""
        col = batch.columns.get(st.ft.geom_field + "__wkt")
        if col is None:
            return []
        return [geo.parse_wkt(w) for w in col]

    def _join_run(self, left: str, right: str, predicate: str, distance,
                  dx, dy, left_query, right_query, level,
                  want_pairs: bool) -> SpatialJoinResult:
        """The shared spatial-join body: scan both sides, then the polygon
        join (``pip`` / ``poly_bbox``) or the co-partitioned pairwise join
        on this dataset's device. A count-only ``dwithin`` / ``bbox`` join
        over a partitioned right store streams the right side through the
        lake window instead (:meth:`_join_pushdown_count`)."""
        from geomesa_tpu_torch.kernels import join as kjoin
        from geomesa_tpu_torch.planning import join_exec

        t0 = time.perf_counter()
        metrics.inc(metrics.JOIN_QUERIES)
        with query_deadline(self._timeout_s()):
            if predicate in kjoin.POLYGON_PREDICATES:
                lst, lplan, lbatch, rst, rbatch = self._join_sides(
                    left, right, left_query, right_query, right_polygon=True)
                lx, ly = self._side_xy(lst, lbatch)
                geoms = self._side_polygons(rst, rbatch)
                pairs, total, stats = join_exec.run_polygon_join(
                    lx, ly, geoms, predicate, level=level, device=self.device,
                    want_pairs=want_pairs)
            elif not want_pairs and self._join_pushdown_ready(right, predicate, right_query):
                lplan, lbatch, total, stats = self._join_pushdown_count(
                    left, right, predicate, distance, dx, dy, left_query,
                    right_query, level)
                rbatch, pairs = ColumnBatch({}, 0), None
            else:
                lst, lplan, lbatch, rst, rbatch = self._join_sides(left, right, left_query,
                                                            right_query)
                lx, ly = self._side_xy(lst, lbatch)
                rx, ry = self._side_xy(rst, rbatch)
                pairs, total, stats = join_exec.run_join(
                    lx, ly, rx, ry, predicate, distance=distance, dx=dx, dy=dy,
                    level=level, device=self.device, want_pairs=want_pairs)
        hints = {
            "op": "join", "index": lplan.index_name, "right": right,
            "predicate": predicate, "level": stats.level,
            "cells_joint": stats.cells_joint,
            "candidate_pairs": stats.candidate_pairs,
            "naive_pairs": stats.naive_pairs,
            "strip_fraction": round(stats.strip_fraction, 4),
            "adaptive": stats.adaptive,
        }
        if stats.strategy_cells:
            # the decision trail: joint cells per strategy
            hints["strategies"] = dict(stats.strategy_cells)
        if stats.wholesale_pairs:
            hints["wholesale_pairs"] = stats.wholesale_pairs
        if stats.pushdown:
            hints["pushdown"] = dict(stats.pushdown)
        if stats.skipped:
            hints["degraded"] = list(stats.skipped)
        tid = tracing.current_trace_id()
        if tid is not None:
            hints["trace_id"] = tid
        hints.update(self._plan_audit_extras(lplan))
        self.audit.record(
            left, lplan.ecql, hints,
            lplan.__dict__.get("plan_time_ms", 0.0),
            (time.perf_counter() - t0) * 1e3, total,
            user=self._current_user(),
            scanned=lplan.__dict__.get("scanned_rows", 0),
            table_rows=lplan.__dict__.get("table_rows", 0),
        )
        return SpatialJoinResult(lbatch, rbatch, pairs, total, stats)

    def _join_pushdown_ready(self, right: str, predicate: str, right_query) -> bool:
        """Whether a count-only join can stream its right side through
        lake window scans: a planar predicate (``dwithin_meters``' reach
        depends on each row's latitude and wraps the antimeridian), a
        right query without row-set-dependent hints, and a partitioned
        point right store."""
        from geomesa_tpu_torch.kernels import join as kjoin

        if predicate not in (kjoin.JOIN_BBOX, kjoin.JOIN_DWITHIN):
            return False
        if not config.JOIN_PUSHDOWN.to_bool():
            return False
        if isinstance(right_query, Query) and (
                right_query.max_features is not None or right_query.sampling is not None
                or right_query.sample_by is not None or right_query.sort_by
                or right_query.properties):
            return False
        st = self._stores.get(right)
        if not isinstance(st, PartitionedFeatureStore):
            return False
        g = st.ft.geom_field
        return g is not None and st.ft.attr(g).is_point

    def _join_pushdown_count(self, left: str, right: str, predicate: str,
                             distance, dx, dy, left_query, right_query, level):
        """Count-only join with window-pushdown side scans: the left side's
        occupied cells (at a window level sized to the reach) chunk into
        groups of ``geomesa.join.pushdown.cells``; each chunk re-plans the
        right side as ``(right_query) AND (OR of the chunk's cell boxes
        grown by reach + 2 CLASSIFY_MARGIN)`` and scans it through
        ``features_pushdown``, so the right side is never whole on the
        host. A left row's cell lies in exactly one chunk and every right
        row within reach of it lies in that chunk's window (one margin for
        the strip contract, one for the scan's f32 edges; the bounds round
        outward to nine decimals), so the chunk counts partition the pair
        set. Returns ``(left plan, left batch, total, JoinStats)`` with
        ``JoinStats.pushdown``."""
        from geomesa_tpu_torch.cache import cells as gcells
        from geomesa_tpu_torch.cache.cells import CLASSIFY_MARGIN
        from geomesa_tpu_torch.kernels import join as kjoin
        from geomesa_tpu_torch.lake.residency import GroupResidencyCache
        from geomesa_tpu_torch.planning import join_exec

        lst = self._store(left)
        lplan = self._fresh_plan(left, left_query)
        g = lst.ft.geom_field
        if g is None or not lst.ft.attr(g).is_point:
            raise ValueError(f"[GM-ARG] spatial join requires a POINT geometry "
                             f"on schema {left!r}")
        rgeom = self._store(right).ft.geom_field
        with tracing.span("scan.join.sides"):
            lbatch = self._executor(left).features(lplan)
        lx, ly = self._side_xy(lst, lbatch)
        lx = np.asarray(lx, np.float64)
        ly = np.asarray(ly, np.float64)
        p0, p1 = kjoin.pair_params(predicate, distance=distance, dx=dx, dy=dy)
        reach_x, reach_y, _ = join_exec.join_reach(predicate, p0, p1, distance, None)
        if level is None:
            # the level votes from the left side only: the right side is
            # never whole on the host
            bounds = None
            if len(lx):
                bounds = (float(lx.min()), float(ly.min()), float(lx.max()), float(ly.max()))
            level = join_exec.choose_level(len(lx), len(lx), max(reach_x, reach_y), bounds)
        stats = join_exec.JoinStats(level=level, n_left=len(lx))
        if not len(lx):
            return lplan, lbatch, 0, stats
        # window cells sized to the reach, finer than the join grid, so a
        # window is comparable to a row group's footprint (exactness holds
        # at any level)
        wlevel = int(np.clip(int(np.floor(np.log2(
            360.0 / max(2.0 * (max(reach_x, reach_y) + CLASSIFY_MARGIN), 1e-9)))),
            level, 15))
        ix, iy = gcells.point_cells(lx, ly, wlevel)
        cell = join_exec._cell_ids(ix, iy)
        order = np.argsort(cell, kind="stable")
        ucell, starts = np.unique(cell[order], return_index=True)
        ends = np.concatenate([starts[1:], [len(order)]])
        uix = ix[order][starts]
        uiy = iy[order][starts]
        stats.cells_left = len(ucell)
        per = max(int(config.JOIN_PUSHDOWN_CELLS.to_int() or 256), 1)
        rq_base = right_query if isinstance(right_query, Query) else Query(ecql=right_query)
        base = rq_base.ecql
        pad_x = reach_x + 2.0 * CLASSIFY_MARGIN
        pad_y = reach_y + 2.0 * CLASSIFY_MARGIN

        def _lo(v):
            return f"{np.floor(v * 1e9) / 1e9:.9f}"

        def _hi(v):
            return f"{np.ceil(v * 1e9) / 1e9:.9f}"

        total = chunks = 0
        bytes_loaded = groups_loaded = bytes_side = groups_side = 0
        # one cache spans the chunk loop: adjacent chunks' windows overlap,
        # and their shared row groups decode once
        residency = GroupResidencyCache.from_config()
        rex = self._executor(right)
        for clo in range(0, len(ucell), per):
            chi = min(clo + per, len(ucell))
            chunks += 1
            boxes = gcells.cell_boxes(wlevel, uix[clo:chi], uiy[clo:chi])
            clause = " OR ".join(
                f"BBOX({rgeom}, {_lo(b[0] - pad_x)}, {_lo(b[1] - pad_y)},"
                f" {_hi(b[2] + pad_x)}, {_hi(b[3] + pad_y)})" for b in boxes)
            ecql = clause if base.strip().upper() == "INCLUDE" else f"({base}) AND ({clause})"
            rplan = self._fresh_plan(right, dataclasses.replace(rq_base, ecql=ecql))
            if residency is not None:
                rplan.__dict__["residency"] = residency
            try:
                with tracing.span("scan.join.side.window", chunk=chunks):
                    rb = rex.features_pushdown(rplan)
            finally:
                rplan.__dict__.pop("residency", None)
            rx, ry = self._side_xy(self._store(right), rb)
            stats.n_right += len(rx)
            sel = order[starts[clo]: ends[chi - 1]]
            plan = join_exec.co_partition(lx[sel], ly[sel], rx, ry, predicate, reach_x,
                                          reach_y, level=level, p0=p0, p1=p1)
            _, cnt = join_exec.execute_predicate(plan, lx[sel], ly[sel], rx, ry, predicate,
                                                 device=self.device, want_pairs=False)
            total += cnt
            cst = plan.stats
            stats.cells_joint += cst.cells_joint
            stats.candidate_pairs += cst.candidate_pairs
            stats.strip_entries += cst.strip_entries
            stats.tiles += cst.tiles
            stats.devices = max(stats.devices, cst.devices)
            stats.adaptive = cst.adaptive
            for dst, src in ((stats.strategy_cells, cst.strategy_cells),
                             (stats.est_pairs, cst.est_pairs),
                             (stats.dispatched_pairs, cst.dispatched_pairs)):
                for k, v in src.items():
                    dst[k] = dst.get(k, 0) + v
            stats.skipped.extend(f"chunk{chunks - 1}:{s}" for s in cst.skipped)
            acct = rplan.__dict__.get("lake_acct") or {}
            bytes_loaded += int(acct.get("bytes_loaded", 0))
            groups_loaded += int(acct.get("groups_loaded", 0))
            # every chunk's scan sees every row group's footer: one chunk's
            # totals are the whole side
            bytes_side = max(bytes_side, int(acct.get("bytes_payload", 0)))
            groups_side = max(groups_side, int(acct.get("groups_total", 0)))
        stats.matched = total
        res_hits = residency.hits if residency is not None else 0
        res_saved = residency.bytes_saved if residency is not None else 0
        stats.pushdown = {
            "chunks": chunks, "cells": len(ucell),
            "bytes_loaded": bytes_loaded, "bytes_side": bytes_side,
            "groups_loaded": groups_loaded, "groups_side": groups_side,
            "residency_hits": res_hits, "bytes_saved_residency": res_saved,
        }
        metrics.inc(metrics.JOIN_PUSHDOWN_RESIDENCY_HITS, res_hits)
        metrics.inc(metrics.JOIN_PUSHDOWN_RESIDENCY_BYTES, res_saved)
        join_exec.record_metrics(stats, total)
        metrics.inc(metrics.JOIN_PUSHDOWN_BYTES, bytes_loaded)
        tracing.add_cost("join_pushdown_bytes", float(bytes_loaded))
        tracing.add_cost("join_cells", float(stats.cells_joint))
        tracing.add_cost("join_candidate_pairs", float(stats.candidate_pairs))
        return lplan, lbatch, total, stats

    @_traced("join")
    def join_spatial(self, left: str, right: str, *, predicate: str,
                     distance=None, dx=None, dy=None, left_query="INCLUDE",
                     right_query="INCLUDE",
                     level: Optional[int] = None) -> SpatialJoinResult:
        """Spatial join: the matched pairs (``.pairs``, row positions into
        each side's scan in table order) and their count, streaming as
        ColumnBatches through ``SpatialJoinResult.batches()``."""
        return self._join_run(left, right, predicate, distance, dx, dy,
                              left_query, right_query, level, want_pairs=True)

    @_traced("join")
    def join_count(self, left: str, right: str, *, predicate: str,
                   distance=None, dx=None, dy=None, left_query="INCLUDE",
                   right_query="INCLUDE", level: Optional[int] = None) -> int:
        """The join's exact matched-pair count without materializing pairs:
        the verdict mask stays on the device and only per-tile counts come
        back."""
        return self._join_run(left, right, predicate, distance, dx, dy,
                              left_query, right_query, level,
                              want_pairs=False).count

    @_traced("explain_join")
    def explain_join(self, left: str, right: str, *, predicate: str,
                     distance=None, dx=None, dy=None, left_query="INCLUDE",
                     right_query="INCLUDE", level: Optional[int] = None,
                     analyze: bool = False) -> str:
        """Join plan explain: the co-partition's pruning account — cells,
        candidate pairs vs naive N*M, boundary-strip fraction, the adaptive
        decision trail — plus (``analyze=True``) the executed match count
        and its milliseconds."""
        from geomesa_tpu_torch.kernels import join as kjoin
        from geomesa_tpu_torch.planning import join_exec
        from geomesa_tpu_torch.planning.explain import Explainer

        exp = Explainer(enabled=True)
        if predicate in kjoin.POLYGON_PREDICATES:
            lst, lplan, lbatch, rst, rbatch = self._join_sides(
                left, right, left_query, right_query, right_polygon=True)
            lx, ly = self._side_xy(lst, lbatch)
            geoms = self._side_polygons(rst, rbatch)
            t0 = time.perf_counter()
            _, total, st = join_exec.run_polygon_join(
                lx, ly, geoms, predicate, level=level, device=self.device,
                want_pairs=False)
            exp.push("Join")
            exp.kv("predicate", predicate)
            exp.kv("sides", f"{left} ({st.n_left} rows) x "
                   f"{right} ({st.n_right} polygons)")
            exp.kv("cell level", st.level)
            exp.kv("cells", f"{st.cells_left} occupied point cells")
            exp.pop()
            exp.push("Adaptive")
            exp.kv("cells[interior]",
                   f"{st.strategy_cells.get('interior', 0)} "
                   f"(wholesale: {st.wholesale_pairs} pairs, zero "
                   f"kernel work)")
            exp.kv("cells[boundary]",
                   f"{st.strategy_cells.get('boundary', 0)} "
                   f"(kernel: {st.candidate_pairs} candidate pairs)")
            exp.kv("statistics read",
                   "classify_cells(cell box, polygon, "
                   "CLASSIFY_MARGIN) per candidate cell")
            if analyze:
                exp.kv("matched (analyze)", total)
                exp.kv("kernel ms", round((time.perf_counter() - t0) * 1e3, 3))
                if st.skipped:
                    exp.kv("degraded", ", ".join(st.skipped))
            exp.pop()
            return str(exp)
        lst, lplan, lbatch, rst, rbatch = self._join_sides(
            left, right, left_query, right_query)
        lx, ly = self._side_xy(lst, lbatch)
        rx, ry = self._side_xy(rst, rbatch)
        p0, p1 = kjoin.pair_params(predicate, distance=distance, dx=dx, dy=dy)
        reach_x, reach_y, wrap_x = join_exec.join_reach(predicate, p0, p1, distance, ry)
        plan = join_exec.co_partition(
            lx, ly, rx, ry, predicate, reach_x, reach_y, level=level,
            p0=p0, p1=p1, wrap_x=wrap_x,
        )
        st = plan.stats
        exp.push("Join")
        exp.kv("predicate", predicate)
        exp.kv("sides", f"{left} ({st.n_left} rows) x "
               f"{right} ({st.n_right} rows)")
        exp.kv("co-partition level", st.level)
        exp.kv("cells", f"{st.cells_left} build, {st.cells_right} "
               f"probe, {st.cells_joint} joint (dispatched)")
        exp.kv("candidate pairs",
               f"{st.candidate_pairs} of {st.naive_pairs} naive "
               f"({st.candidate_fraction:.4f})")
        exp.kv("boundary-strip fraction", round(st.strip_fraction, 4))
        exp.kv("tiles", f"{st.tiles} ({plan.Bp} x {plan.Pp} padded, "
               f"{len(plan.sections)} section(s))")
        exp.pop()
        # the adaptive decision trail: what each joint cell's routing read
        # and what it chose
        exp.push("Adaptive")
        exp.kv("enabled", str(bool(st.adaptive)).lower())
        for strat in ("pairwise", "brute", "split.l", "split.r"):
            if strat not in st.strategy_cells:
                continue
            exp.kv(f"cells[{strat}]",
                   f"{st.strategy_cells[strat]} "
                   f"(est {st.est_pairs.get(strat, 0)} pairs, "
                   f"dispatched {st.dispatched_pairs.get(strat, 0)} "
                   f"slots)")
        exp.kv("statistics read",
               "per-cell (n_build, n_probe); thresholds: brute <= "
               f"{config.JOIN_ADAPTIVE_BRUTE_PAIRS.to_int() or 256} "
               "pairs, skew >= "
               f"{config.JOIN_ADAPTIVE_SKEW_RATIO.to_int() or 8}:1 "
               "over tile")
        if analyze:
            t0 = time.perf_counter()
            _, total = join_exec.execute_predicate(
                plan, lx, ly, rx, ry, predicate, device=self.device,
                want_pairs=False)
            exp.kv("matched (analyze)", total)
            exp.kv("pairwise ms", round((time.perf_counter() - t0) * 1e3, 3))
            if st.skipped:
                exp.kv("degraded", ", ".join(st.skipped))
        exp.pop()
        return str(exp)

    # -- kNN ---------------------------------------------------------------
    @_traced("knn")
    def knn(self, name: str, x: float, y: float, k: int = 10,
            query="INCLUDE") -> FeatureCollection:
        """The k nearest matches to (x, y) by great-circle distance, by the
        reference's expanding-radius search: a first radius sized for about
        4k points at the store's average density restricts the plan to its
        box (split at the antimeridian) so the index prunes the scan, and
        the radius doubles until the k-th candidate's exact f64 distance
        lies inside the box's inscribed circle. Near a pole, with a radius
        as wide as the data, or on the 16th attempt the search runs
        unrestricted, so it never returns a truncated result."""
        q = self._as_query(query)
        st = self._store(name)
        st.flush()
        ex = self._executor(name)
        if st.count == 0 or k <= 0:
            return FeatureCollection(st.ft, ColumnBatch({}, 0), st.dicts)
        geom = st.ft.geom_field
        base = parse_ecql(q.ecql)
        bounds = self.bounds(name) or (-180.0, -90.0, 180.0, 90.0)
        area = max((bounds[2] - bounds[0]) * (bounds[3] - bounds[1]), 1e-9)
        full_span = max(bounds[2] - bounds[0], bounds[3] - bounds[1], 1e-6)
        r = max(math.sqrt(4.0 * k * area / (math.pi * max(st.count, 1))), 1e-4)
        deg_m = math.pi / 180.0 * EARTH_RADIUS_M
        base_compiled = compile_filter(base, st.ft, st.dicts)
        batch, order, prev_n = None, None, -1
        for attempt in range(16):
            # the lon half-width uses the band-edge cosine so every point
            # within r * deg_m metres lies inside the box
            pole = (y + r >= 89.99) or (y - r <= -89.99)
            cos_edge = math.cos(math.radians(min(abs(y) + r, 89.99)))
            restricted = r < full_span and not pole and cos_edge >= 0.05 \
                and attempt < 15
            if restricted:
                boxes = _search_boxes(x, y, r, cos_edge)
                bb = tuple(ir.BBox(geom, *b) for b in boxes)
                f = ir.And((base, bb[0] if len(bb) == 1 else ir.Or(bb)))
            else:
                boxes, f = None, base
            plan = plan_query(st, f, q.hints())
            if restricted:
                # the box prunes through the plan's windows and inside the
                # scan; the predicate stays the location-free base filter
                plan.compiled = base_compiled
            # one location-free token: every origin and radius shares the
            # registry's scan callable, as the reference's kernel
            plan.__dict__["cache_token"] = ("knn", q.ecql, None)
            if isinstance(ex, PartitionedExecutor):  # each partition's k nearest
                batch = ex.knn_features(plan, x, y, k, boxes=boxes)
            else:
                pos, _ = ex.knn(plan, x, y, k, boxes=boxes)
                batch = st.tables[plan.index_name].gather_sorted(np.sort(pos))
            order = np.zeros(0, np.int64)
            kth_m = math.inf
            if batch.n:
                d = haversine_m(batch.columns[geom + "__x"],
                                batch.columns[geom + "__y"], x, y)
                order = np.argsort(d)[:k]
                kth_m = float(d[order[-1]])
            if not restricted:
                break
            # exact iff the k-th neighbour lies inside the box's inscribed
            # circle (clamped edges hold no points beyond the domain)
            if len(order) >= k and kth_m <= r * deg_m:
                break
            if batch.n == prev_n and batch.n < k:
                # a doubling added nothing and k is still short: the base
                # filter limits, not the box; go unrestricted
                r = full_span
            else:
                r *= 2.0
            prev_n = batch.n
        batch = ColumnBatch({kk: v[order] for kk, v in batch.columns.items()},
                            len(order))
        return FeatureCollection(st.ft, batch, st.dicts)


def _search_boxes(x: float, y: float, r: float, cos_edge: float):
    """The kNN search box of radius ``r`` degrees around (x, y), split in
    two where it crosses the antimeridian."""
    half_lon = r / cos_edge
    lat_lo, lat_hi = max(y - r, -90.0), min(y + r, 90.0)
    lon_lo, lon_hi = x - half_lon, x + half_lon
    if lon_hi - lon_lo >= 360.0:
        return [(-180.0, lat_lo, 180.0, lat_hi)]
    if lon_lo < -180.0:
        return [(-180.0, lat_lo, lon_hi, lat_hi), (lon_lo + 360.0, lat_lo, 180.0, lat_hi)]
    if lon_hi > 180.0:
        return [(lon_lo, lat_lo, 180.0, lat_hi), (-180.0, lat_lo, lon_hi - 360.0, lat_hi)]
    return [(lon_lo, lat_lo, lon_hi, lat_hi)]


def _sort_batch(batch: ColumnBatch, sort_by, dicts) -> ColumnBatch:
    """Stable multi-key sort, least significant key first; strings sort by
    their decoded value (nulls as the empty string, so first)."""
    order = np.arange(batch.n)
    for attr, desc in reversed(sort_by):
        col = batch.columns[attr][order]
        if attr in dicts:
            col = np.asarray([v if v is not None else ""
                              for v in dicts[attr].decode(col)], dtype=object)
        if desc:
            o2 = (batch.n - 1) - np.argsort(col[::-1], kind="stable")[::-1]
        else:
            o2 = np.argsort(col, kind="stable")
        order = order[o2]
    return ColumnBatch({k: v[order] for k, v in batch.columns.items()}, batch.n)


def _project(batch: ColumnBatch, properties) -> ColumnBatch:
    """Keep the feature id, each property and its ``<name>__*``
    companions."""
    keep = set(properties) | {"__fid__"}
    pref = tuple(p + "__" for p in properties)
    return ColumnBatch({k: v for k, v in batch.columns.items()
                        if k in keep or k.startswith(pref)}, batch.n)
