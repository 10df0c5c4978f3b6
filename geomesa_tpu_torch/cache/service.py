"""Aggregate-cache orchestration: memoize pushdown aggregates per SFC cell.

Copy of ``geomesa_tpu/cache/service.py``. One :class:`AggregateCache`
hangs off a GeoDataset and fronts its four aggregate entry points
(count / density / density_curve / stats):

1. whole-result fast path: an exact repeat of a query (same canonical
   filter, op parameters and auths, same store epoch) returns the stored
   aggregate without touching the executor;
2. partial-cover reuse: a decomposable query (``cells.py``) looks up each
   interior SFC cell, executes only the missing cells and the boundary
   strips through the ordinary planner and executor, merges cached and
   fresh partials (grids add, counts add, sketches merge), and stores the
   fresh cells for the next overlapping query;
3. hierarchical pre-aggregation (``hierarchy.py``): a missing cell
   assembles from its four finer children before a scan, and completed
   sibling quads roll up on put, so a zoom-out over a warm region costs
   O(visible cells) and no device launch;
4. polygon regions (``cells.decompose_region``): interior cells come from
   the cache (sharing cell keys with box queries over the same residual),
   boundary cells scan exactly under the polygon predicate, through the
   partitioned executor on a partitioned store.

Invalidation is by epoch (``store.py``): the FeatureStore ``version``.

Bit-identity: decomposition is only attempted where the partial merge is
exact: counts (integer addition over disjoint cells), unweighted density
(f32 grids of integer counts, exact to 2^24), stats whose every leaf
merges by integer / extremum algebra, and unweighted ``density_curve`` by
block-space chunks (``_serve_curve``). Weighted grids and other stats
cache their whole result only.

Every miss scans through the executor on the card; cached values are
host copies (numpy arrays, ints, stat JSON), never device tensors.
Degraded aggregates (``plan.degraded``) are never cached; sampling
bypasses the cache. Queries are planned all-public, as every port path
is, so the auth part of every key is None.

Under tracing, the reference's spans mark each stage (``cache.lookup``,
``cache.cells``, ``cache.hierarchy``, ``cache.cell.scan``,
``cache.residual``, ``cache.merge``) and every cached piece served adds
one to the trace's ``cache_hits`` cost. :meth:`AggregateCache.probe_cover`
is ``explain``'s dry run of a query's cell cover.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config, heat, metrics, tracing
from geomesa_tpu_torch.cache import cells as cellmod
from geomesa_tpu_torch.cache import hierarchy
from geomesa_tpu_torch.cache.store import CacheStore
from geomesa_tpu_torch.planning.planner import QueryHints, plan_query
from geomesa_tpu_torch.stats import sketches as sk

#: sketch kinds whose merge is exact (integer / extremum algebra): the only
#: ones partial-cover decomposition may split
EXACT_MERGE_KINDS = {
    "count", "minmax", "enumeration", "topk", "histogram", "frequency",
}


def stats_exact_merge(stat) -> bool:
    """True when every leaf sketch of ``stat`` merges exactly: an
    aggregate may be split over disjoint row sets iff its partial merge
    is exact."""
    from geomesa_tpu_torch.kernels.stats_scan import leaf_stats

    return all(leaf.kind in EXACT_MERGE_KINDS for leaf in leaf_stats(stat))


def merge_bundle(kind: str, *, shape=None, stat_spec: Optional[str] = None):
    """The partial-merge table: ``(zero, merge)`` for every aggregate kind
    whose partial composition over disjoint row sets is exact, or None for
    kinds that must stay whole.

    * ``count``: integer addition;
    * ``density`` (unweighted; ``shape=(h, w)``): f32 grids hold integer
      counts (exact to 2^24), cell-partition grid addition is bit-exact;
    * ``stats`` (``stat_spec``; only when :func:`stats_exact_merge`):
      sketch merge through :meth:`Stat.merge`, integer / extremum algebra;
    * ``curve``: f64 block-count grids add exactly (integers to 2^53);
      the cache composes them by chunk families (``_serve_curve``).
    """
    if kind == "count":
        return (lambda: 0), (lambda a, b: a + int(b))
    if kind == "density":
        h, w = int(shape[0]), int(shape[1])
        return (lambda: np.zeros((h, w), np.float32)), (
            lambda a, b: a + np.asarray(b, np.float32)
        )
    if kind == "stats":
        from geomesa_tpu_torch.stats import parse_stat

        if not stats_exact_merge(parse_stat(stat_spec)):
            return None

        def merge(acc: sk.Stat, piece: sk.Stat) -> sk.Stat:
            acc.merge(piece)
            return acc

        return (lambda: parse_stat(stat_spec)), merge
    if kind == "curve":
        return (lambda: None), (lambda a, b: b if a is None else a + b)
    return None


class _Op:
    """Per-aggregate behavior bundle for the generic serve loop."""

    def __init__(self, fingerprint: Tuple, run: Callable, zero: Callable,
                 merge: Callable, pack: Callable, unpack: Callable,
                 decomposable: bool, cell_nbytes: int = 0):
        self.fingerprint = fingerprint
        self.run = run          # plan -> raw value (through the executor)
        self.zero = zero        # () -> empty value
        self.merge = merge      # (acc, piece) -> acc
        self.pack = pack        # value -> storable (immutable-ish)
        self.unpack = unpack    # storable -> fresh value safe to hand out
        self.decomposable = decomposable
        #: estimated stored size of one cell entry (0 = negligible): gates
        #: decomposition against the LRU budget
        self.cell_nbytes = cell_nbytes


class AggregateCache:
    """Query-result cache of one GeoDataset (shared by its queries)."""

    #: sub-plans kept (LRU): twice the default cell cap (their windows and
    #: compaction may hold card memory)
    PLAN_CAPACITY = 512

    def __init__(self, budget_bytes: Optional[int] = None):
        self.store = CacheStore(budget_bytes)
        #: (uid, version, index, canonical filter, planning knobs) -> plan
        self._plans: "OrderedDict[Tuple, Any]" = OrderedDict()
        #: uid -> the store version its kept sub-plans were planned at
        self._plan_versions: dict = {}

    # -- gates -------------------------------------------------------------
    @staticmethod
    def enabled() -> bool:
        return bool(config.CACHE_ENABLED.to_bool())

    @staticmethod
    def _bypass(q) -> bool:
        # sampling's 1-in-n counter depends on scan order: not cacheable
        return q.sampling is not None or q.sample_by is not None

    # -- plumbing ----------------------------------------------------------
    @staticmethod
    def _note(plan, **kw) -> None:
        plan.__dict__.setdefault("exec_path", {}).update(kw)

    @staticmethod
    def _auth_key(ds, q) -> Optional[Tuple[str, ...]]:
        # the port plans all-public and refuses Query.auths, so the key is
        # the reference's with no auths configured
        return None

    def _sub_plan(self, ds, st, q, f):
        """Plan a residual / cell filter through the ordinary planner.
        Cell filters are canonical per (cell, residual), so the sub-plan
        gets a stable ``cache_token``, as the reference's does, and is
        kept in this cache's own LRU of plans: a cell scanned again at the
        same store version (another aggregate over the same cell, a drop
        of the cached results) reuses its windows and compaction, as the
        reference's cells reuse their compiled kernels. The dataset's plan
        cache, which holds the user's plans and their exec-path notes, is
        not touched."""
        key = (st.uid, st.version, q.index, repr(f), config.LOOSE_BBOX.get(),
               config.SCAN_RANGES_TARGET.get())
        plan2 = self._plans.get(key)
        if plan2 is not None:
            self._plans.move_to_end(key)
            return plan2
        if self._plan_versions.get(st.uid) != st.version:
            # a mutation left this store's older sub-plans unreachable
            for k in [k for k in self._plans if k[0] == st.uid]:
                del self._plans[k]
            self._plan_versions[st.uid] = st.version
        plan2 = plan_query(st, f, QueryHints(query_index=q.index))
        plan2.__dict__["cache_token"] = ("cache_cell", repr(plan2.filter), None)
        self._plans[key] = plan2
        while len(self._plans) > self.PLAN_CAPACITY:
            self._plans.popitem(last=False)
        return plan2

    def _run_sub(self, ds, st, q, f, op, plan, scan_acc: List[int]):
        """Execute one cell/strip query; returns (value, cacheable)."""
        plan2 = self._sub_plan(ds, st, q, f)
        value = op.run(plan2)
        scan_acc[0] += plan2.__dict__.get("scanned_rows", 0)
        scan_acc[1] = max(scan_acc[1], plan2.__dict__.get("table_rows", 0))
        degraded = plan2.__dict__.pop("degraded", None)
        if degraded:
            # carry the skipped-partition account onto the outer plan; the
            # piece itself must not be cached
            plan.__dict__.setdefault("degraded", []).extend(degraded)
            return value, False
        return value, True

    # -- the generic serve loop --------------------------------------------
    def _whole_hit(self, plan, st, wkey, op: "_Op"):
        """The stored whole result of ``wkey`` (unpacked), or None."""
        with tracing.span("cache.lookup", key="whole"):
            hit = self.store.get(st.uid, st.version, wkey)
        if hit is None:
            return None
        metrics.inc(metrics.CACHE_HIT)
        tracing.add_cost("cache_hits", 1.0)
        self._note(plan, cache="hit")
        plan.__dict__["scanned_rows"] = 0
        plan.__dict__.setdefault("table_rows", 0)
        return op.unpack(hit)

    def _serve(self, ds, st, q, plan, op: "_Op"):
        if not self.enabled() or self._bypass(q):
            return op.run(plan)
        uid, epoch = st.uid, st.version
        akey = self._auth_key(ds, q)
        wkey = ("whole",) + op.fingerprint + (repr(plan.filter), akey)
        hit = self._whole_hit(plan, st, wkey, op)
        if hit is not None:
            return hit

        geom = st.ft.geom_field
        decomp = None
        if op.decomposable and not plan.is_empty:
            decomp = cellmod.decompose(plan.filter, st.ft)
            if decomp is None:
                # the polygon-region shape: interior cells share keys with
                # box queries over the same residual
                decomp = cellmod.decompose_region(plan.filter, st.ft)
                if decomp is not None:
                    metrics.inc(metrics.CACHE_POLYGON)
        if (
            decomp is not None
            and op.cell_nbytes
            and op.cell_nbytes * (len(decomp.cells) + 1)
                > self.store.budget() // 2
        ):
            # the cell partials alone would take half the LRU budget (a
            # large density raster stored once per cell), evicting this
            # query's own earlier cells: keep the whole result only
            decomp = None
        if decomp is None:
            value = op.run(plan)
            if not plan.__dict__.get("degraded"):
                self.store.put(uid, epoch, wkey, op.pack(value))
            metrics.inc(metrics.CACHE_MISS)
            self._note(plan, cache="miss")
            return value

        # partial cover: cached interior cells + the executed residual.
        # Cell keys are level-qualified, so the hierarchy addresses any
        # level of the quadtree with the same builder.
        def cell_key(level: int, cell) -> Tuple:
            return ("cell",) + op.fingerprint + (
                decomp.residual_key, akey, level,
                cellmod.cell_prefix(level, cell),
            )

        def hier_get(level: int, cell):
            return self.store.get(uid, epoch, cell_key(level, cell))

        def hier_put(level: int, cell, packed):
            return self.store.put(uid, epoch, cell_key(level, cell), packed)

        def merge4(vals):
            acc4 = op.zero()
            for v in vals:
                acc4 = op.merge(acc4, op.unpack(v))
            return op.pack(acc4)

        use_hier = hierarchy.enabled()
        hstats: dict = {}
        acc = op.zero()
        hits = 0
        hier_hits = 0
        scan_acc = [0, 0]  # [scanned_rows, table_rows] over executed pieces
        all_cacheable = True
        with tracing.span("cache.cells", total=len(decomp.cells),
                          level=decomp.level, kind=decomp.kind) as cells_span:
            for cell in decomp.cells:
                ckey = cell_key(decomp.level, cell)
                cprefix = cellmod.cell_prefix(decomp.level, cell)
                with tracing.span("cache.lookup", key="cell"):
                    got = self.store.get(uid, epoch, ckey)
                if got is None and use_hier:
                    # the zoom-out path: merge the cell from cached finer
                    # children before paying a scan
                    with tracing.span("cache.hierarchy", level=decomp.level):
                        got = hierarchy.assemble(hier_get, hier_put, merge4,
                                                 decomp.level, cell, stats=hstats)
                    if got is not None:
                        hier_hits += 1
                        metrics.inc(metrics.CACHE_HIER_HIT)
                    else:
                        metrics.inc(metrics.CACHE_HIER_RESIDUAL)
                if got is not None:
                    hits += 1
                    tracing.add_cost("cache_hits", 1.0)
                    # a hit is a touch with no attributed cost
                    heat.record(st.ft.name, decomp.level, cprefix, hit=1)
                    acc = op.merge(acc, op.unpack(got))
                    continue
                t_cell = time.perf_counter()
                with tracing.span("cache.cell.scan"):
                    value, cacheable = self._run_sub(
                        ds, st, q, decomp.cell_filter(cell, geom), op, plan, scan_acc)
                # a miss carries the scan's wall-clock ms
                heat.record(st.ft.name, decomp.level, cprefix, miss=1,
                            device_ms=(time.perf_counter() - t_cell) * 1e3)
                if cacheable:
                    self.store.put(uid, epoch, ckey, op.pack(value))
                    if use_hier:
                        # a completed sibling quad writes its parent for the
                        # next zoom-out
                        hierarchy.rollup(hier_get, hier_put, merge4,
                                         decomp.level, cell)
                else:
                    all_cacheable = False
                acc = op.merge(acc, value)
            cells_span.set(hits=hits, assembled=hier_hits)
        strip_f = decomp.residual_scan_filter(geom)
        if strip_f is not None:
            with tracing.span("cache.residual", kind=decomp.kind):
                value, cacheable = self._run_sub(ds, st, q, strip_f, op, plan, scan_acc)
            if not cacheable:
                all_cacheable = False
            acc = op.merge(acc, value)
        with tracing.span("cache.merge"):
            if all_cacheable:
                self.store.put(uid, epoch, wkey, op.pack(acc))
        plan.__dict__["scanned_rows"] = scan_acc[0]
        plan.__dict__["table_rows"] = scan_acc[1]
        metrics.inc(metrics.CACHE_PARTIAL if hits else metrics.CACHE_MISS)
        self._note(
            plan,
            cache=("partial" if hits else "miss"),
            cache_cells=f"{hits}/{len(decomp.cells)}",
            cache_level=decomp.level,
        )
        if decomp.kind == "polygon":
            covered = len(decomp.cells) + len(decomp.boundary)
            self._note(
                plan, cache_region="polygon",
                cache_boundary_cells=len(decomp.boundary),
                cache_residual_fraction=round(
                    len(decomp.boundary) / max(covered, 1), 3),
            )
        if hier_hits:
            self._note(
                plan,
                hierarchy=f"{hier_hits}/{len(decomp.cells)} cells assembled"
                          f" (children to level {hstats.get('deepest', 0)})",
            )
        return acc

    # -- explain support -----------------------------------------------------
    def probe_cover(self, ds, st, q, plan) -> Optional[dict]:
        """Dry-run decomposition and residency probe for ``explain``'s
        Hierarchy section: which cells the query would cover, how many are
        resident at the query's own level, how many the hierarchy could
        assemble from finer children (probed with the ``count``
        fingerprint, promoting nothing), and the residual fraction a
        polygon query would scan exactly. None when the query has no cell
        cover."""
        if plan.is_empty:
            return None
        decomp = cellmod.decompose(plan.filter, st.ft)
        if decomp is None:
            decomp = cellmod.decompose_region(plan.filter, st.ft)
        if decomp is None:
            return None
        uid, epoch = st.uid, st.version
        akey = self._auth_key(ds, q)
        fp = ("count",)

        def key(level, cell):
            return ("cell",) + fp + (
                decomp.residual_key, akey, level,
                cellmod.cell_prefix(level, cell),
            )

        levels: dict = {}
        missing = 0
        dep = hierarchy.depth() if hierarchy.enabled() else 0
        for cell in decomp.cells:
            if self.store.get(uid, epoch, key(decomp.level, cell)) is not None:
                levels[decomp.level] = levels.get(decomp.level, 0) + 1
                continue
            hstats: dict = {}
            got = hierarchy.assemble(
                lambda lvl, c: self.store.get(uid, epoch, key(lvl, c)),
                lambda lvl, c, v: None,  # probe: never promote
                lambda vals: 0,          # count probe: values irrelevant
                decomp.level, cell, max_depth=dep, stats=hstats,
                count_promotes=False,
            ) if dep else None
            if got is not None:
                lvl = hstats.get("deepest", decomp.level + 1)
                levels[lvl] = levels.get(lvl, 0) + 1
            else:
                missing += 1
        boundary = decomp.residual_count()
        covered = len(decomp.cells) + (boundary if decomp.kind == "polygon" else 0)
        return {
            "kind": decomp.kind,
            "level": decomp.level,
            "cells": len(decomp.cells),
            "boundary": boundary,
            "levels": levels,
            "missing": missing,
            "residual_fraction": round(
                (missing + (boundary if decomp.kind == "polygon" else 0))
                / max(covered, 1), 3
            ),
        }

    def speculative_cells(self, ds, st, q, plan):
        """The host-only residency read behind the speculative density and
        stats answers: the query's decomposed cells with their resident
        count values (cache hits, and hierarchy assembly from cached
        children), never a scan and never a promotion. ``(decomp,
        resident, missing)`` with ``resident`` as ``[(cell, count), ...]``,
        or None when the cache is off or the query does not decompose (the
        caller falls back to the planner's estimate)."""
        if not self.enabled() or plan.is_empty:
            return None
        decomp = cellmod.decompose(plan.filter, st.ft)
        if decomp is None:
            decomp = cellmod.decompose_region(plan.filter, st.ft)
        if decomp is None:
            return None
        uid, epoch = st.uid, st.version
        akey = self._auth_key(ds, q)
        fp = ("count",)

        def key(level, cell):
            return ("cell",) + fp + (
                decomp.residual_key, akey, level,
                cellmod.cell_prefix(level, cell),
            )

        def merge4(vals):
            return sum(int(v) for v in vals)

        dep = hierarchy.depth() if hierarchy.enabled() else 0
        resident, missing = [], []
        for cell in decomp.cells:
            got = self.store.get(uid, epoch, key(decomp.level, cell))
            if got is None and dep:
                got = hierarchy.assemble(
                    lambda lvl, c: self.store.get(uid, epoch, key(lvl, c)),
                    lambda lvl, c, v: None,  # read-only: never promote
                    merge4, decomp.level, cell, max_depth=dep,
                    count_promotes=False,
                )
            if got is not None:
                resident.append((cell, int(got)))
            else:
                missing.append(cell)
        return decomp, resident, missing

    # -- ops ----------------------------------------------------------------
    def count(self, ds, st, q, plan) -> int:
        ex = ds._executor(st.ft.name)
        zero, merge = merge_bundle("count")
        op = _Op(
            fingerprint=("count",),
            run=lambda p: int(ex.count(p)),
            zero=zero,
            merge=merge,
            pack=int,
            unpack=int,
            decomposable=True,
        )
        return int(self._serve(ds, st, q, plan, op))

    def density(self, ds, st, q, plan, bbox, width: int, height: int,
                weight: Optional[str]) -> np.ndarray:
        ex = ds._executor(st.ft.name)
        render = tuple(float(v) for v in bbox)

        def run(p):
            return np.asarray(ex.density(p, bbox, width, height, weight))

        def raster_decoupled() -> bool:
            # cell entries carry the render raster in their fingerprint, so
            # they are reusable only while the raster stays fixed. In the
            # pan / zoom map shape the filter box is the raster: a pan
            # moves both and every cell key changes, so decompose only when
            # the raster is fixed apart from the filter (the dashboard
            # shape)
            split = cellmod.split_bbox_conjunct(plan.filter, st.ft.geom_field)
            if split is None:
                return True  # decompose() checks again and rejects these
            b = split[0]
            return (b.xmin, b.ymin, b.xmax, b.ymax) != render

        zero, merge = merge_bundle("density", shape=(height, width))
        op = _Op(
            fingerprint=("density", render, int(width), int(height), weight),
            run=run,
            zero=zero,
            merge=merge,
            pack=lambda v: np.asarray(v, np.float32).copy(),
            unpack=lambda v: v.copy(),
            # unweighted grids are integer-valued f32: cell addition is
            # exact; weighted grids would reorder f32 rounding
            decomposable=weight is None and raster_decoupled(),
            # every cell entry holds a full render raster
            cell_nbytes=int(width) * int(height) * 4,
        )
        return self._serve(ds, st, q, plan, op)

    def density_curve(self, ds, st, q, plan, level: int, block_window,
                      weight: Optional[str]) -> np.ndarray:
        ex = ds._executor(st.ft.name)
        zero, merge = merge_bundle("curve")
        op = _Op(
            fingerprint=("density_curve", int(level),
                         tuple(int(v) for v in block_window), weight),
            run=lambda p: np.asarray(ex.density_curve(p, level, block_window, weight)),
            zero=zero,
            merge=merge,
            pack=lambda v: v.copy(),
            unpack=lambda v: v.copy(),
            # coordinate-space cells cannot reproduce SFC block membership,
            # block-space chunks can: this op's partial cover is
            # _serve_curve, not the generic cell loop
            decomposable=False,
        )
        if (self.enabled() and not self._bypass(q) and weight is None
                and not plan.is_empty):
            # unweighted only: a block's count does not depend on the
            # window, so chunk grids concatenate and downsample-add exactly
            # (f64 integer counts); weighted sums would re-round f32
            return self._serve_curve(ds, st, q, plan, int(level), block_window, op, ex)
        return self._serve(ds, st, q, plan, op)

    def _serve_curve(self, ds, st, q, plan, level: int, block_window,
                     op: "_Op", ex) -> np.ndarray:
        """Block-space partial cover of ``density_curve``: the window
        splits into aligned power-of-two chunks; cached chunk grids
        assemble by slicing, only missing sub-windows execute (one
        ``density_curve_batch`` call for several), and the hierarchy serves
        a zoom-out by downsample-adding the chunk's level-(k+1) projection.
        Tile pyramids over one filter share chunks across tiles and levels.

        Polygon-region filters split the chunk loop into families:
        interior chunks key on the residual alone and scan without the
        polygon (shared with non-region pyramids over that residual),
        outside chunks are zeros with no scan, and only boundary chunks
        scan under the polygon."""
        uid, epoch = st.uid, st.version
        akey = self._auth_key(ds, q)
        wkey = ("whole",) + op.fingerprint + (repr(plan.filter), akey)
        hit = self._whole_hit(plan, st, wkey, op)
        if hit is not None:
            return hit

        ix0, iy0, ix1, iy1 = (int(v) for v in block_window)
        nx, ny = ix1 - ix0 + 1, iy1 - iy0 + 1
        per_axis = config.CACHE_CELLS_PER_AXIS.to_int() or 8
        c = 1
        while max(nx, ny) > per_axis * c:
            c *= 2
        cx0, cx1, cy0, cy1 = ix0 // c, ix1 // c, iy0 // c, iy1 // c
        n_chunks = (cx1 - cx0 + 1) * (cy1 - cy0 + 1)
        if c * c * 8 * (n_chunks + 1) > self.store.budget() // 2:
            # the chunk grids alone would take half the LRU budget: keep
            # the whole result only
            return self._serve(ds, st, q, plan, op)

        base = ("curve",) + (repr(plan.filter), akey)

        # polygon chunk families: classify each chunk's geographic box
        # against the polygon with CLASSIFY_MARGIN room (the argument
        # decompose_region makes)
        from geomesa_tpu_torch.kernels import join as jk

        region_split = None
        geomf = st.ft.geom_field
        if (config.CACHE_POLYGON.to_bool() and geomf is not None
                and st.ft.attr(geomf).is_point):
            region_split = cellmod.split_region_conjunct(plan.filter, geomf)
        codes = None
        base_plain = base
        if region_split is not None:
            spatial, residual = region_split
            base_plain = ("curve",) + (repr(residual), akey)
            n_side = 1 << level
            bsx, bsy = 360.0 / n_side, 180.0 / n_side
            coords = [(kx, ky) for ky in range(cy0, cy1 + 1)
                      for kx in range(cx0, cx1 + 1)]
            cboxes = np.asarray([
                (kx * c * bsx - 180.0, ky * c * bsy - 90.0,
                 (kx + 1) * c * bsx - 180.0, (ky + 1) * c * bsy - 90.0)
                for kx, ky in coords
            ], np.float64)
            kcodes = jk.classify_cells(cboxes, spatial.geom, cellmod.CLASSIFY_MARGIN)
            codes = dict(zip(coords, (int(v) for v in kcodes)))
            metrics.inc(metrics.CACHE_CURVE_REGION)

        def _family(fam_base):
            def get(lvl: int, side: int, kx: int, ky: int):
                return self.store.get(uid, epoch, fam_base + (lvl, side, kx, ky))

            def put(lvl: int, side: int, kx: int, ky: int, g):
                return self.store.put(uid, epoch, fam_base + (lvl, side, kx, ky),
                                      np.ascontiguousarray(g))
            return get, put

        families = {False: _family(base), True: _family(base_plain)}

        use_hier = hierarchy.enabled()
        hstats: dict = {}
        out = np.zeros((ny, nx), np.float64)
        hits = hier_hits = n_outside = 0
        #: (sub_window, out-slice, full-chunk coords or None, plain?)
        misses = []
        with tracing.span("cache.cells", total=n_chunks, level=level,
                          kind="curve", chunk=c) as cells_span:
            for ky in range(cy0, cy1 + 1):
                for kx in range(cx0, cx1 + 1):
                    plain = False
                    if codes is not None:
                        code = codes[(kx, ky)]
                        if code == jk.CELL_OUTSIDE:
                            # wholly outside the polygon (with margin): the
                            # slice stays zero, no scan, no entry
                            n_outside += 1
                            continue
                        plain = code == jk.CELL_INTERIOR
                    get_, put_ = families[plain]
                    bx0, by0 = kx * c, ky * c
                    bx1, by1 = bx0 + c - 1, by0 + c - 1
                    sx0, sy0 = max(bx0, ix0), max(by0, iy0)
                    sx1, sy1 = min(bx1, ix1), min(by1, iy1)
                    full = (sx0, sy0, sx1, sy1) == (bx0, by0, bx1, by1)
                    with tracing.span("cache.lookup", key="chunk"):
                        g = get_(level, c, kx, ky)
                    if g is None and use_hier:
                        with tracing.span("cache.hierarchy", level=level):
                            g = hierarchy.assemble_curve(get_, put_, level, c, kx, ky,
                                                         stats=hstats)
                        if g is not None:
                            hier_hits += 1
                            metrics.inc(metrics.CACHE_HIER_HIT)
                        else:
                            metrics.inc(metrics.CACHE_HIER_RESIDUAL)
                    dst = np.s_[sy0 - iy0: sy1 - iy0 + 1, sx0 - ix0: sx1 - ix0 + 1]
                    if g is not None:
                        hits += 1
                        tracing.add_cost("cache_hits", 1.0)
                        out[dst] = g[sy0 - by0: sy1 - by0 + 1, sx0 - bx0: sx1 - bx0 + 1]
                    else:
                        misses.append(((sx0, sy0, sx1, sy1), dst,
                                       (kx, ky) if full else None, plain))
            cells_span.set(hits=hits, assembled=hier_hits, outside=n_outside)

        all_cacheable = True
        if misses:
            scan_acc = [0, 0]  # executed [scanned_rows, table_rows]
            deg0 = len(plan.__dict__.get("degraded") or ())

            def _exec_windows(p, windows):
                """Execute missing sub-windows under plan ``p``, folding its
                scan accounting (and any degradation) into the outer
                plan's."""

                def _fold():
                    scan_acc[0] += p.__dict__.pop("scanned_rows", 0)
                    scan_acc[1] = max(scan_acc[1], p.__dict__.pop("table_rows", 0))

                with tracing.span("cache.cell.scan", n=len(windows)):
                    if len(windows) > 1:
                        grids = ex.density_curve_batch(p, level, windows, None)
                    else:
                        grids = [np.asarray(ex.density_curve(p, level, windows[0], None))]
                    _fold()
                if p is not plan:
                    deg = p.__dict__.pop("degraded", None)
                    if deg:
                        plan.__dict__.setdefault("degraded", []).extend(deg)
                return grids

            poly_misses = [m for m in misses if not m[3]]
            plain_misses = [m for m in misses if m[3]]
            grids_by: dict = {}
            if poly_misses:
                for m, g in zip(poly_misses, _exec_windows(
                        plan, [m[0] for m in poly_misses])):
                    grids_by[id(m)] = g
            if plain_misses:
                # interior chunks scan under the residual alone: the
                # polygon is a tautology over them, and the residual-only
                # grids are the ones plain curve queries share
                plan_plain = self._sub_plan(ds, st, q, region_split[1])
                for m, g in zip(plain_misses, _exec_windows(
                        plan_plain, [m[0] for m in plain_misses])):
                    grids_by[id(m)] = g
            plan.__dict__["scanned_rows"] = scan_acc[0]
            plan.__dict__["table_rows"] = scan_acc[1]
            if len(plan.__dict__.get("degraded") or ()) > deg0:
                # a partition was skipped in a fresh scan: none of them
                # may be cached
                all_cacheable = False
            for m in misses:
                win, dst, full_at, plain = m
                g = np.asarray(grids_by[id(m)], np.float64)
                out[dst] = g
                if full_at is not None and all_cacheable:
                    kx, ky = full_at
                    get_, put_ = families[plain]
                    put_(level, c, kx, ky, g)
                    if use_hier:
                        hierarchy.rollup_curve(get_, put_, level, c, kx, ky, g)
        else:
            # fully chunk-warm: nothing executed
            plan.__dict__["scanned_rows"] = 0
            plan.__dict__.setdefault("table_rows", 0)
        with tracing.span("cache.merge"):
            if all_cacheable:
                self.store.put(uid, epoch, wkey, op.pack(out))
        metrics.inc(metrics.CACHE_PARTIAL if hits else metrics.CACHE_MISS)
        self._note(
            plan,
            cache=("partial" if hits else "miss"),
            cache_cells=f"{hits}/{n_chunks}",
            cache_level=level,
            cache_chunk=c,
        )
        if codes is not None:
            n_int = sum(1 for v in codes.values() if v == jk.CELL_INTERIOR)
            n_bnd = sum(1 for v in codes.values() if v == jk.CELL_BOUNDARY)
            self._note(
                plan, cache_region="polygon-chunks",
                cache_region_chunks=(
                    f"{n_int} interior (residual-keyed) / {n_bnd} "
                    f"boundary / {n_outside} outside (unscanned)"
                ),
            )
        if hier_hits:
            self._note(
                plan,
                hierarchy=f"{hier_hits}/{n_chunks} chunks assembled"
                          f" (children to level {hstats.get('deepest', 0)})",
            )
        return out

    def stats(self, ds, st, q, plan, stat_spec: str) -> sk.Stat:
        from geomesa_tpu_torch.stats import parse_stat

        ex = ds._executor(st.ft.name)
        bundle = merge_bundle("stats", stat_spec=stat_spec)
        # an inexact spec never decomposes, so _serve never merges it
        zero, merge = bundle or (None, None)
        op = _Op(
            fingerprint=("stats", stat_spec),
            run=lambda p: ex.stats(p, parse_stat(stat_spec)),
            zero=zero,
            merge=merge,
            # serialized snapshots: the caller's mutable Stat can never
            # alias an entry
            pack=lambda v: v.to_json(),
            unpack=sk.Stat.from_json,
            decomposable=bundle is not None,
        )
        return self._serve(ds, st, q, plan, op)
