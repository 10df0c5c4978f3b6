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
it), and the schema and data lifecycle (``get_schema``, ``list_schemas``,
``describe``, ``delete_schema``, ``update_schema``,
``add_attribute_index``, ``remove_attribute_index``, ``delete_features``,
``age_off``, ``z3_histogram``; the reference's journal, standing-query and
aggregate-cache hooks in these calls have no counterpart here yet). A
schema with
``geomesa.partition='time'`` gets a time-partitioned, out-of-core store
and serves the same calls partition at a time (``index/partitioned.py``, ``planning/partitioned_exec.py``).
Extent-geometry columns take WKT strings or geometry objects on insert
and come back as WKT. The layers the JAX ``GeoDataset`` wraps around its executor (aggregate
cache, audit, serving, tracing, journal, fleet) are not part of this port
yet: every call goes to the executor directly.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.index.partitioned import PartitionedFeatureStore, is_partitioned_schema
from geomesa_tpu_torch.index.store import FeatureStore
from geomesa_tpu_torch.planning.batch import build_spec
from geomesa_tpu_torch.planning.executor import Executor
from geomesa_tpu_torch.planning.partitioned_exec import PartitionedExecutor
from geomesa_tpu_torch.planning.planner import QueryHints, QueryPlan, plan_query
from geomesa_tpu_torch.schema.columns import (
    ColumnBatch, DictionaryEncoder, decode_batch, fid_strs,
)
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stats import parse_stat
from geomesa_tpu_torch.stats import sketches as sk
from geomesa_tpu_torch.utils import geometry as geo
from geomesa_tpu_torch.utils.geometry import EARTH_RADIUS_M, haversine_m

#: ROADMAP items the port refuses by name
_HOST_LAYERS = "ROADMAP Queue 1, host layers"


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
    total plus a streaming matched-pair view. ``batches()`` streams
    matched pairs as ColumnBatches of at most ``geomesa.join.batch.rows``
    rows: left columns verbatim, right columns prefixed ``right.`` (the
    attribute equi-join's convention)."""

    def __init__(self, lbatch: ColumnBatch, rbatch: ColumnBatch, pairs,
                 count: int, stats):
        self._lbatch, self._rbatch = lbatch, rbatch
        #: matched (left, right) row positions, int64 [K, 2], row-major
        self.pairs = pairs
        self.count = int(count)
        self.stats = stats

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


class GeoDataset:
    """Schema catalog + stores on one device.

    ``compact_min_rows`` / ``compact_fraction``: the compacted scan layout
    engages for tables of at least ``compact_min_rows`` rows whose windows
    admit less than ``compact_fraction`` of the table (the JAX package's
    ``geomesa.compact.min.rows`` / ``geomesa.compact.fraction``)."""

    def __init__(self, n_shards: int = 8, device=None,
                 compact_min_rows: int = 1 << 20,
                 compact_fraction: float = 0.5):
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.compact_min_rows = compact_min_rows
        self.compact_fraction = compact_fraction
        self._stores: Dict[str, FeatureStore] = {}
        self._executors: Dict[str, Any] = {}
        self._plans: Dict[tuple, QueryPlan] = {}

    # -- schemas ------------------------------------------------------------
    def create_schema(self, name_or_ft, spec: Optional[str] = None) -> FeatureType:
        ft = (name_or_ft if isinstance(name_or_ft, FeatureType)
              else FeatureType.from_spec(name_or_ft, spec))
        if ft.name in self._stores:
            raise ValueError(f"schema {ft.name!r} already exists")
        store_cls = PartitionedFeatureStore if is_partitioned_schema(ft) else FeatureStore
        self._stores[ft.name] = store_cls(ft, self.n_shards, self.device)
        return ft

    def get_schema(self, name: str) -> FeatureType:
        return self._store(name).ft

    def list_schemas(self) -> List[str]:
        return sorted(self._stores)

    def delete_schema(self, name: str) -> None:
        self._store(name)  # raises if missing
        del self._stores[name]
        self._forget(name)

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
        st.add_columns(new_ft, added)
        self._forget(name)
        return new_ft

    def add_attribute_index(self, name: str, attr: str) -> None:
        """Enable an attribute index on a live schema: only the new
        permutation is built (per resident partition; spilled partitions
        build theirs when they load)."""
        st = self._store(name)
        a = st.ft.attr(attr)
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
        n = st.delete(lambda cols: cols[dtg] < cutoff)
        self._forget(name)
        return n

    def delete_features(self, name: str, ecql: str, auths=None) -> int:
        """Delete the features matching ``ecql``, through the exact host
        mask (extent geometries refine, never the envelope superset).
        Returns the rows removed. Authorizations belong to the host
        layers and raise."""
        if auths is not None:
            raise NotImplementedError(f"delete authorizations: {_HOST_LAYERS}")
        st = self._store(name)
        cf = compile_filter(parse_ecql(ecql), st.ft, st.dicts)
        n = st.delete(lambda cols: cf.exact_mask(cols, len(cols["__fid__"])))
        self._forget(name)
        return n

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
        return self._store(name).append(data, fids)

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

    def _plan(self, name: str, query) -> QueryPlan:
        """The plan of ECQL text or a ``Query``, cached per (query, store
        version); its ``exec_path`` describes the last call that ran it."""
        q = self._as_query(query)
        st = self._store(name)
        st.flush()
        # the knobs planning reads key the cache too, so a scoped change
        # never serves a plan compiled under another setting
        key = (name, repr(q), id(st), st.version, config.LOOSE_BBOX.get(),
               config.SCAN_RANGES_TARGET.get())
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 256:
                self._plans.clear()
            plan = self._plans[key] = plan_query(st, q.ecql, q.hints())
            if isinstance(q.ecql, str):
                # a plan of ECQL text can be reproduced from it: the
                # reference's ``cache_token``, which a query-axis batch
                # requires of every member
                plan.__dict__["cache_token"] = q.ecql
        return plan

    def _fresh_plan(self, name: str, query) -> QueryPlan:
        """:meth:`_plan` with its ``exec_path`` cleared for a new call."""
        plan = self._plan(name, query)
        plan.__dict__["exec_path"] = {}
        plan.__dict__.pop("lake_acct", None)
        return plan

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

    def count(self, name: str, query="INCLUDE", exact: bool = True,
              region=None) -> int:
        """Feature count of ``query``: exact, or (``exact=False``) the
        planner's estimate from the write-time sketches, with no scan.
        ``region``: optional polygon (WKT or geometry) clipping the count
        (see :meth:`_with_region`)."""
        plan = self._fresh_plan(name, self._with_region(name, query, region))
        if not exact:
            return int(plan.est_count)
        return self._executor(name).count(plan)

    def density(self, name: str, query="INCLUDE", bbox=None, width: int = 256,
                height: int = 256, weight: Optional[str] = None,
                region=None) -> np.ndarray:
        """(height, width) f32 heatmap of ``query`` over ``bbox`` (default:
        the data's bounds), optionally summing the ``weight`` attribute.
        ``region``: optional polygon clipping the aggregate."""
        plan = self._fresh_plan(name, self._with_region(name, query, region))
        if bbox is None:
            bbox = self.bounds(name) or (-180, -90, 180, 90)
        return self._executor(name).density(plan, tuple(bbox), width, height, weight)

    # -- curve-aligned density ------------------------------------------------
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
        plan = self._fresh_plan(name, q)
        if bbox is None:
            bbox = self.bounds(name) or (-180.0, -90.0, 180.0, 90.0)
        window, snapped = self._snap_blocks(bbox, level)
        return self._executor(name).density_curve(plan, level, window, weight), snapped

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
        plan = self._fresh_plan(name, dataclasses.replace(self._as_query(query), index="z2"))
        windows, snaps = self._curve_windows(name, bboxes, level)
        grids = self._executor(name).density_curve_batch(plan, level, windows, weight)
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
        plans, spec = self._batch_plans(name, qs)
        if spec is None:
            return None
        windows, snaps = self._curve_windows(name, bboxes, level)
        grids = self._executor(name).density_curve_filter_batch(
            plans, spec, level, windows, weight)
        return None if grids is None else list(zip(grids, snaps))

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
        plans, spec = self._batch_plans(name, queries)
        if spec is None:
            return None
        return self._executor(name).count_batch(plans, spec)

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
        return self._executor(name).density_batch(plans, spec, boxes, width, height, weight)

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
        stats = [parse_stat(stat_spec) for _ in queries]
        plans, spec = self._batch_plans(name, queries)
        if spec is None:
            return None
        return self._executor(name).stats_batch(plans, spec, stats)

    def query(self, name: str, query="INCLUDE") -> FeatureCollection:
        """Matching features. A sorted query with ``0 < max_features <=``
        ``geomesa.topk.max`` (0 disables) first selects candidates on the device by the
        primary sort key (every boundary tie included when there are more
        keys), and the host gathers and sorts only those; then, as the
        reference, sort -> limit -> projection."""
        q = self._as_query(query)
        plan = self._fresh_plan(name, q)
        st = self._store(name)
        ex = self._executor(name)
        batch = None
        topk_max = config.TOPK_MAX.to_int() or 0
        if q.sort_by and q.max_features is not None and 0 < q.max_features <= topk_max:
            attr, desc = q.sort_by[0]
            names = None
            if q.properties:
                names = list(q.properties) + [a for a, _ in q.sort_by]
            ties = len(q.sort_by) > 1
            if isinstance(ex, PartitionedExecutor):
                # each partition's candidates; the exact sort below finishes
                batch = ex.top_batch(plan, attr, desc, q.max_features, names,
                                     include_ties=ties)
            else:
                pos = ex.top_rows(plan, attr, desc, q.max_features, include_ties=ties)
                if pos is not None:
                    batch = st.tables[plan.index_name].gather_sorted(pos, names)
            if batch is not None:
                plan.exec_path["sort"] = f"device-topk(k={q.max_features})"
        if batch is None:
            batch = ex.features(plan)
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
        plan = self._fresh_plan(name, q)
        ex = self._executor(name)

        def chunks():
            for batch in ex.features_iter(plan, batch_rows):
                yield _project(batch, q.properties) if q.properties else batch

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
    def stats(self, name: str, stat_spec: str, query="INCLUDE",
              region=None) -> sk.Stat:
        """Exact statistics of the matches, from the stat DSL
        (``Count();MinMax(a);Histogram(a,bins,lo,hi);...``). ``region``:
        optional polygon clipping the matches."""
        plan = self._fresh_plan(name, self._with_region(name, query, region))
        stat = parse_stat(stat_spec)
        return self._executor(name).stats(plan, stat)

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
        lbatch = self._executor(left).features(lplan)
        rbatch = self._executor(right).features(rplan)
        return lst, lbatch, rst, rbatch

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

        if predicate in kjoin.POLYGON_PREDICATES:
            lst, lbatch, rst, rbatch = self._join_sides(
                left, right, left_query, right_query, right_polygon=True)
            lx, ly = self._side_xy(lst, lbatch)
            geoms = self._side_polygons(rst, rbatch)
            pairs, total, stats = join_exec.run_polygon_join(
                lx, ly, geoms, predicate, level=level, device=self.device,
                want_pairs=want_pairs)
        elif not want_pairs and self._join_pushdown_ready(right, predicate, right_query):
            lbatch, total, stats = self._join_pushdown_count(
                left, right, predicate, distance, dx, dy, left_query,
                right_query, level)
            rbatch, pairs = ColumnBatch({}, 0), None
        else:
            lst, lbatch, rst, rbatch = self._join_sides(left, right, left_query, right_query)
            lx, ly = self._side_xy(lst, lbatch)
            rx, ry = self._side_xy(rst, rbatch)
            pairs, total, stats = join_exec.run_join(
                lx, ly, rx, ry, predicate, distance=distance, dx=dx, dy=dy,
                level=level, device=self.device, want_pairs=want_pairs)
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
        set. Returns ``(left batch, total, JoinStats)`` with
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
            return lbatch, 0, stats
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
            acct = rplan.__dict__.get("lake_acct") or {}
            bytes_loaded += int(acct.get("bytes_loaded", 0))
            groups_loaded += int(acct.get("groups_loaded", 0))
            # every chunk's scan sees every row group's footer: one chunk's
            # totals are the whole side
            bytes_side = max(bytes_side, int(acct.get("bytes_payload", 0)))
            groups_side = max(groups_side, int(acct.get("groups_total", 0)))
        stats.matched = total
        stats.pushdown = {
            "chunks": chunks, "cells": len(ucell),
            "bytes_loaded": bytes_loaded, "bytes_side": bytes_side,
            "groups_loaded": groups_loaded, "groups_side": groups_side,
            "residency_hits": residency.hits if residency is not None else 0,
            "bytes_saved_residency": residency.bytes_saved if residency is not None else 0,
        }
        return lbatch, total, stats

    def join_spatial(self, left: str, right: str, *, predicate: str,
                     distance=None, dx=None, dy=None, left_query="INCLUDE",
                     right_query="INCLUDE",
                     level: Optional[int] = None) -> SpatialJoinResult:
        """Spatial join: the matched pairs (``.pairs``, row positions into
        each side's scan in table order) and their count, streaming as
        ColumnBatches through ``SpatialJoinResult.batches()``."""
        return self._join_run(left, right, predicate, distance, dx, dy,
                              left_query, right_query, level, want_pairs=True)

    def join_count(self, left: str, right: str, *, predicate: str,
                   distance=None, dx=None, dy=None, left_query="INCLUDE",
                   right_query="INCLUDE", level: Optional[int] = None) -> int:
        """The join's exact matched-pair count without materializing pairs:
        the verdict mask stays on the device and only per-tile counts come
        back."""
        return self._join_run(left, right, predicate, distance, dx, dy,
                              left_query, right_query, level,
                              want_pairs=False).count

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
            lst, lbatch, rst, rbatch = self._join_sides(
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
            exp.pop()
            return str(exp)
        lst, lbatch, rst, rbatch = self._join_sides(
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
        exp.pop()
        return str(exp)

    # -- kNN ---------------------------------------------------------------
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
