"""PyTorch port vs the JAX package: the aggregate cache (``cache/``), the
metrics registry's core and the cell-heat table.

The scenarios of ``tests/test_cache.py`` run through both packages on the
same seeded rows (some exactly on level-5 cell edges) with both packages'
cache knobs scoped alike. Each call asserts: the port's answer equals the
JAX package's cached answer and the port's cache-off scan bit for bit
(counts, unweighted and weighted density, curve grids, stat values); the
per-call deltas of every ``cache.*`` counter are equal between the
packages; the port's ``exec.device.dispatch`` delta is zero exactly where
the reference's is; and the cache's exec-path notes are equal. Store key
sets are compared after pan / zoom sequences.

The JAX side runs with one device (``geomesa.mesh.devices`` 1). The two
datasets are module-wide and each test starts from empty caches; tests
that write use fids of their own and compare within the test.
"""

import contextlib

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import heat as jheat
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.cache import AggregateCache as JAggregateCache
from geomesa_tpu.cache import cells as jcells
from geomesa_tpu.cache import store as jstore
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.schema.feature_type import FeatureType as JFeatureType
from geomesa_tpu_torch import GeoDataset, Query, config, heat, metrics
from geomesa_tpu_torch.cache import AggregateCache, cells, decompose
from geomesa_tpu_torch.cache import store as cstore
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.schema.feature_type import FeatureType

#: every counter the cache moves, compared per call between the packages
CACHE_COUNTERS = (
    "cache.hit", "cache.partial", "cache.miss", "cache.put", "cache.evict",
    "cache.invalidate", "cache.hierarchy.hit", "cache.hierarchy.promote",
    "cache.hierarchy.residual", "cache.polygon", "cache.curve.region",
    "cache.persist.restored",
)
#: exec-path keys the cache writes
NOTES = ("cache", "cache_cells", "cache_level", "cache_chunk", "hierarchy",
         "cache_region", "cache_boundary_cells", "cache_residual_fraction",
         "cache_region_chunks")

SPEC = "type:String:index=true,weight:Float,dtg:Date,*geom:Point"
Q1 = "BBOX(geom, -22.5, -22.5, 22.5, 22.5) AND type = 'bus'"
#: pan east: heavy cell overlap with Q1, plus a newly exposed cell column
Q2 = "BBOX(geom, -18.0, -22.5, 34.9, 22.5) AND type = 'bus'"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_data():
    """test_cache.py's rows: seeded points including rows exactly on
    level-5 cell edges (span 11.25 deg)."""
    edges = np.arange(-180.0, 180.1, 11.25)
    span = edges[(edges > -30) & (edges < 30)]
    bx, by = np.meshgrid(span, span)
    r = np.random.default_rng(7)
    n = 4000
    x = np.concatenate([bx.ravel(), r.uniform(-35, 35, n)])
    y = np.concatenate([by.ravel(), r.uniform(-35, 35, n)])
    m = len(x)
    lo = np.datetime64("2020-01-01", "ms").astype(np.int64)
    return {
        "geom__x": x, "geom__y": y,
        "weight": r.uniform(0, 2, m),
        "dtg": (lo + r.integers(0, 10**9, m)).astype("datetime64[ms]"),
        "type": r.choice(["bus", "car", "train"], m),
    }, np.arange(m).astype(str)


class Both:
    """One JAX and one port dataset holding the same rows; :meth:`call`
    runs one call on each with the cache knobs scoped alike and holds the
    packages to each other."""

    def __init__(self, name: str, spec: str, data, fids, n_shards=4):
        self.name = name
        self.j = JGeoDataset(n_shards=n_shards)
        self.p = GeoDataset(n_shards=n_shards, device="cpu")
        for ds in (self.j, self.p):
            ds.create_schema(name, spec)
            ds.insert(name, data, fids=fids)
            ds.flush(name)
        orig = self.p._cache_args

        def recording(name_, query):
            out = orig(name_, query)
            self.p._last_plan = out[2]
            return out

        self.p._cache_args = recording
        self.p._last_plan = None

    def fresh(self, budget=None):
        self.j.cache = JAggregateCache(budget_bytes=budget)
        self.p.cache = AggregateCache(budget_bytes=budget)

    @staticmethod
    @contextlib.contextmanager
    def scoped(cfg, knobs):
        with contextlib.ExitStack() as es:
            for k, v in knobs.items():
                es.enter_context(getattr(cfg, k).scoped(v))
            yield

    @staticmethod
    def counts(met):
        reg = met.registry()
        return {n: reg.counter(n).value
                for n in CACHE_COUNTERS + (met.EXEC_DEVICE_DISPATCH,)}

    def _side(self, ds, cfg, met, fn, knobs):
        with self.scoped(cfg, knobs):
            c0 = self.counts(met)
            out = fn(ds)
            c1 = self.counts(met)
        return out, {k: c1[k] - c0[k] for k in c0}

    def j_path(self):
        ev = self.j.audit.recent(1)[0]
        return {k: v for k, v in ev.hints["exec_path"].items() if k in NOTES}

    def p_path(self):
        return {k: v for k, v in self.p._last_plan.exec_path.items() if k in NOTES}

    def call(self, fn, enabled=True, notes=True, **knobs):
        """``fn(ds)`` on both packages: returns (port answer, port delta).
        ``knobs``: config attribute name -> value, scoped on both."""
        knobs = {"CACHE_ENABLED": "true" if enabled else "false", **knobs}
        jout, jd = self._side(self.j, jconfig, jmetrics, fn, knobs)
        jpath = self.j_path() if notes else None
        pout, pd = self._side(self.p, config, metrics, fn, knobs)
        dk = metrics.EXEC_DEVICE_DISPATCH
        assert {k: pd[k] for k in CACHE_COUNTERS} == {k: jd[k] for k in CACHE_COUNTERS}
        assert (pd[dk] == 0) == (jd[dk] == 0), (pd[dk], jd[dk])
        assert_same(pout, jout)
        if notes:
            assert self.p_path() == jpath
        return pout, pd

    def cold(self, fn):
        """``fn`` on the port with the cache off."""
        with config.CACHE_ENABLED.scoped("false"):
            return fn(self.p)

    def keys(self):
        """Both stores' key sets for the schema."""
        out = []
        for ds in (self.j, self.p):
            st = ds._store(self.name)
            out.append(set(ds.cache.store._data.get(st.uid, {})))
        return out


def value_of(v):
    if isinstance(v, tuple):
        return tuple(value_of(x) for x in v)
    if hasattr(v, "value") and callable(v.value):
        return v.value()
    return v


def assert_same(a, b):
    """Bit-identical answers: ints, grids (dtype and bytes), curve tuples,
    stat values."""
    a, b = value_of(a), value_of(b)
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def pts():
    data, fids = make_data()
    jconfig.MESH_DEVICES.set(1)
    try:
        yield Both("pts", SPEC, data, fids)
    finally:
        jconfig.MESH_DEVICES.set(None)


@pytest.fixture()
def b(pts):
    pts.fresh()
    return pts


def count(q):
    return lambda ds: ds.count("pts", q)


#: coarser cells: the JAX side compiles cell scans of new shapes, so the
#: stats, eviction and decomposed density scenarios use four cells an axis
PER_AXIS_4 = {"CACHE_CELLS_PER_AXIS": "4"}


# -- count: identity, partial reuse, scan accounting -----------------------

def test_count_repeat_and_overlap_identical(b):
    cold1, cold2 = b.cold(count(Q1)), b.cold(count(Q2))
    n, d = b.call(count(Q1))                        # cold populate
    assert n == cold1 and d["cache.miss"] == 1
    n, d = b.call(count(Q1))                        # whole-result hit
    assert n == cold1 and d["cache.hit"] == 1
    assert d[metrics.EXEC_DEVICE_DISPATCH] == 0
    n, d = b.call(count(Q2))                        # partial-cover reuse
    assert n == cold2 and d["cache.partial"] == 1
    jkeys, pkeys = b.keys()
    assert pkeys == jkeys and pkeys


def test_warm_overlap_scans_only_residual(b):
    b.call(count(Q1))
    assert b.p_path()["cache"] == "miss"
    assert b.p._last_plan.scanned_rows > 0
    _, d = b.call(count(Q2))
    assert d["cache.partial"] == 1
    path = b.p_path()
    assert path["cache"] == "partial"
    hits, total = map(int, path["cache_cells"].split("/"))
    assert 0 < hits < total
    warm_scanned = b.p._last_plan.scanned_rows
    b.cold(count(Q2))
    assert warm_scanned < b.p._last_plan.scanned_rows


def test_exact_repeat_scans_nothing(b):
    b.call(count(Q1))
    _, d = b.call(count(Q1))
    assert d["cache.hit"] == 1 and d[metrics.EXEC_DEVICE_DISPATCH] == 0
    assert b.p_path()["cache"] == "hit"
    assert b.p._last_plan.scanned_rows == 0


def test_epoch_invalidation_insert_delete(b):
    base, _ = b.call(count(Q1))
    rows = {
        "geom__x": [0.0, 11.25], "geom__y": [0.0, 11.25],
        "weight": [1.0, 1.0],
        "dtg": np.array(["2020-01-02", "2020-01-03"], "datetime64[ms]"),
        "type": ["bus", "bus"],
    }
    for ds in (b.j, b.p):
        ds.insert("pts", rows, fids=["fresh1", "fresh2"])
        ds.flush("pts")
    n, d = b.call(count(Q1))
    assert n == base + 2 and d["cache.invalidate"] > 0
    for ds in (b.j, b.p):
        ds.delete_features("pts", "IN ('fresh1', 'fresh2')")
    n, _ = b.call(count(Q1))
    assert n == base == b.cold(count(Q1))


# -- density ---------------------------------------------------------------

def test_density_unweighted_bit_identical(b):
    bbox = (-22.5, -22.5, 22.5, 22.5)
    grid = lambda q: lambda ds: ds.density("pts", q, bbox=bbox, width=96, height=64)  # noqa: E731
    cold = b.cold(grid(Q1))
    for _ in range(2):  # populate, hit
        g, _ = b.call(grid(Q1))
        assert_same(g, cold)
    g3, _ = b.call(grid(Q2), **PER_AXIS_4)
    assert_same(g3, b.cold(grid(Q2)))


def test_density_partial_reuse_under_fixed_raster(b):
    """A raster fixed apart from the filter box (the dashboard shape)
    decomposes; overlapping filters then reuse cells."""
    bbox = (-30.0, -30.0, 30.0, 30.0)
    grid = lambda q: lambda ds: ds.density("pts", q, bbox=bbox, width=64, height=64)  # noqa: E731
    f1 = "BBOX(geom, -22.5, -22.5, 22.5, 22.5)"
    f2 = "BBOX(geom, -18.0, -22.5, 34.9, 22.5)"
    b.call(grid(f1), **PER_AXIS_4)
    assert "cache_cells" in b.p_path()
    warm2, d = b.call(grid(f2), **PER_AXIS_4)
    assert d["cache.partial"] == 1
    assert_same(warm2, b.cold(grid(f2)))
    jkeys, pkeys = b.keys()
    assert pkeys == jkeys


def test_density_coupled_raster_whole_result_only(b):
    bbox = (-22.5, -22.5, 22.5, 22.5)
    b.call(lambda ds: ds.density("pts", "BBOX(geom, -22.5, -22.5, 22.5, 22.5)",
                                 bbox=bbox, width=32, height=32))
    assert "cache_cells" not in b.p_path()


def test_density_cells_gated_by_budget(b):
    """Per-cell density entries hold full rasters: when the cells alone
    would take half the budget, the query caches its whole result only."""
    b.fresh(budget=100_000)
    b.call(lambda ds: ds.density("pts", "BBOX(geom, -22.5, -22.5, 22.5, 22.5)",
                                 bbox=(-30.0, -30.0, 30.0, 30.0), width=64, height=64))
    assert "cache_cells" not in b.p_path()
    assert b.p.cache.store.total_bytes <= 100_000


def test_density_weighted_whole_result_only(b):
    bbox = (-22.5, -22.5, 22.5, 22.5)
    grid = lambda ds: ds.density("pts", Q1, bbox=bbox, width=64, height=64,  # noqa: E731
                                 weight="weight")
    cold = b.cold(grid)
    g1, _ = b.call(grid)
    assert "cache_cells" not in b.p_path()
    g2, d = b.call(grid)
    assert d["cache.hit"] == 1
    assert_same(g1, cold)
    assert_same(g2, cold)


def test_cached_grid_immune_to_caller_mutation(b):
    grid = lambda ds: ds.density("pts", Q1, bbox=(-22.5, -22.5, 22.5, 22.5),  # noqa: E731
                                 width=32, height=32)
    b.call(grid)
    g_hit, _ = b.call(grid)
    g_hit[:] = -1.0  # hit results are fresh copies
    g_again, _ = b.call(grid)
    assert g_again.min() >= 0.0


def test_density_curve_whole_result_cache(b):
    curve = lambda ds: ds.density_curve("pts", Q1, level=6,  # noqa: E731
                                        bbox=(-22.5, -22.5, 22.5, 22.5))
    cold = b.cold(curve)
    g1, _ = b.call(curve)
    g2, d = b.call(curve)
    assert d["cache.hit"] == 1 and d[metrics.EXEC_DEVICE_DISPATCH] == 0
    assert_same(g1, cold)
    assert_same(g2, cold)


# -- stats -----------------------------------------------------------------

def test_stats_exact_merge_kinds_identical(b):
    spec = "Count();MinMax(weight);Enumeration(type)"
    stat = lambda q: lambda ds: ds.stats("pts", spec, q)  # noqa: E731
    cold = b.cold(stat(Q1)).value()
    for _ in range(2):  # populate, hit
        v, _ = b.call(stat(Q1), **PER_AXIS_4)
        assert v.value() == cold
    warm, d = b.call(stat(Q2), **PER_AXIS_4)
    assert d["cache.partial"] == 1
    assert warm.value() == b.cold(stat(Q2)).value()


def test_stats_inexact_merge_kind_whole_result_only(b):
    spec = "DescriptiveStats(weight)"
    stat = lambda ds: ds.stats("pts", spec, Q1)  # noqa: E731
    cold = b.cold(stat).value()
    v1, _ = b.call(stat)
    assert "cache_cells" not in b.p_path()
    v2, _ = b.call(stat)
    assert v1.value() == cold and v2.value() == cold


def test_cached_stat_immune_to_caller_mutation(b):
    stat = lambda ds: ds.stats("pts", "Count()", Q1)  # noqa: E731
    b.call(stat, **PER_AXIS_4)
    hot, _ = b.call(stat, **PER_AXIS_4)
    expected = hot.value()
    hot.count = -999  # entries are serialized snapshots
    again, _ = b.call(stat, **PER_AXIS_4)
    assert again.value() == expected


# -- bypasses / admission ---------------------------------------------------

def test_sampling_bypasses_cache(b):
    _, d = b.call(lambda ds: ds.count("pts", Query(ecql=Q1, sampling=4)),
                  notes=False)
    assert not any(d[k] for k in CACHE_COUNTERS)


def test_auths_still_refused():
    """The port plans all-public and refuses Query.auths, so every cache
    key's auth part is None, as the reference's is without auths."""
    ds = GeoDataset(device="cpu")
    ds.create_schema("sec", "name:String,*geom:Point")
    with config.CACHE_ENABLED.scoped("true"), pytest.raises(NotImplementedError):
        ds.count("sec", Query(ecql="INCLUDE", auths=["admin"]))


def test_eviction_under_budget(b):
    b.fresh(budget=500)
    results = {}
    evicted = 0
    for dx in range(8):
        q = f"BBOX(geom, {-22.5 + dx}, -22.5, {22.5 + dx}, 22.5)"
        results[q], d = b.call(count(q), **PER_AXIS_4)
        evicted += d["cache.evict"]
    for q, v in results.items():
        n, d = b.call(count(q), **PER_AXIS_4)
        assert n == v == b.cold(count(q))
        evicted += d["cache.evict"]
    assert evicted > 0
    assert b.p.cache.store.total_bytes <= 500


def test_delete_schema_drops_cached_entries():
    data, fids = make_data()
    pair = Both("gone", SPEC, data, fids, n_shards=2)
    with config.CACHE_ENABLED.scoped("true"):
        pair.p.count("gone", Q1)
    assert pair.p.cache.store.total_entries > 0
    pair.p.delete_schema("gone")
    assert pair.p.cache.store.total_entries == 0
    assert pair.p.cache.store.total_bytes == 0


def test_refresh_schema_drops_the_replaced_store(tmp_path):
    data, fids = make_data()
    ds = GeoDataset(n_shards=2, device="cpu")
    ds.create_schema("r", SPEC)
    ds.insert("r", data, fids=fids)
    ds.save(str(tmp_path))
    with config.CACHE_ENABLED.scoped("true"):
        ds.count("r", Q1)
    old = ds._store("r").uid
    assert ds.cache.store.export_uid(old)[1]
    assert ds.refresh_schema("r", str(tmp_path))
    assert ds._store("r").uid != old
    assert ds.cache.store.export_uid(old) == (None, [])


def test_wide_decomposition_keeps_the_outer_plan_notes(b):
    """The cell sub-plans live in the cache's own LRU: a decomposition of
    more than 256 cells (the dataset's plan-cache size) neither evicts the
    user's plans nor drops the notes on the outer plan."""
    ds = b.p
    # 17 x 16 level-7 cells
    q = "BBOX(geom, -22.5, -11.25, 25.3125, 11.25) AND type = 'bus'"
    knobs = {"CACHE_CELLS_PER_AXIS": "20", "CACHE_MAX_CELLS": "2000",
             "CACHE_HIERARCHY": "false"}
    with b.scoped(config, knobs):
        dec = decompose(parse_ecql(q), ds._store("pts").ft)
        assert len(dec.cells) == 272
        other = ds._plan("pts", Q2)
        plans = len(ds._plans)
        with config.CACHE_ENABLED.scoped("false"):
            want = ds.count("pts", q)
        with config.CACHE_ENABLED.scoped("true"):
            assert ds.count("pts", q) == want
    assert len(ds._plans) <= plans + 1 and ds._plan("pts", Q2) is other
    path = ds._plan("pts", q).exec_path
    assert path["cache"] == "miss"
    assert path["cache_cells"] == f"0/{len(dec.cells)}"
    assert len(ds.cache._plans) <= AggregateCache.PLAN_CAPACITY


def test_disabled_cache_stores_nothing(b):
    _, d = b.call(count(Q1), enabled=False, notes=False)
    b.call(lambda ds: ds.density("pts", Q1, bbox=(-22.5, -22.5, 22.5, 22.5),
                                 width=16, height=16), enabled=False, notes=False)
    assert d["cache.put"] == 0
    assert b.p.cache.store.total_entries == 0


def test_extent_geometry_whole_result_only():
    """A polygon straddling cell edges counts once with the cache on
    (extent schemas skip decomposition)."""
    pair = Both("poly", "type:String,*geom:Polygon",
                {"type": ["a"], "geom": ["POLYGON((-1 -1, 1 -1, 1 1, -1 1, -1 -1))"]},
                ["p0"], n_shards=2)
    q = "BBOX(geom, -22.5, -22.5, 22.5, 22.5)"
    f = lambda ds: ds.count("poly", q)  # noqa: E731
    assert pair.cold(f) == 1
    n, _ = pair.call(f)
    assert n == 1 and "cache_cells" not in pair.p_path()
    n, d = pair.call(f)
    assert n == 1 and d["cache.hit"] == 1


# -- decomposition: the same cells, boxes, strips and keys -----------------

PT = "type:String,*geom:Point"

BOXES = [
    Q1, Q2, "BBOX(geom, -180, -90, 180, 90)", "BBOX(geom, -100, 30, -80, 45)",
    "BBOX(geom, 0.5, 0.5, 0.6, 0.6) AND type = 'x'",
    "BBOX(geom, 170, 80, 180, 90)", "BBOX(geom, -180, -90, -170, -80)",
    "BBOX(geom, 10, 10, 10, 20)",
    "BBOX(geom, 0, 0, 10, 10) AND BBOX(geom, 5, 5, 15, 15)",
    "INTERSECTS(geom, POLYGON((0 0, 10 0, 10 10, 0 10, 0 0)))",
    "BBOX(geom, 0, 0, 10, 10) OR type = 'bus'", "INCLUDE",
]


def _dc(d):
    if d is None:
        return None
    return (d.level, d.residual_key, d.cells, d.cell_boxes, d.kind,
            getattr(d, "strips", None), getattr(d, "boundary", None),
            getattr(d, "boundary_boxes", None))


@pytest.mark.parametrize("q", BOXES)
def test_decompose_equals_reference(q):
    ft, jft = FeatureType.from_spec("t", PT), JFeatureType.from_spec("t", PT)
    for per_axis in ("8", "4", "64"):
        with config.CACHE_CELLS_PER_AXIS.scoped(per_axis), \
                jconfig.CACHE_CELLS_PER_AXIS.scoped(per_axis):
            d = decompose(parse_ecql(q), ft)
            assert _dc(d) == _dc(jcells.decompose(jparse(q), jft))
            if d is not None:
                geom = ft.geom_field
                sf = d.strip_filter(geom)
                jd = jcells.decompose(jparse(q), jft)
                assert repr(sf) == repr(jd.strip_filter(geom))
                for c in d.cells:
                    assert repr(d.cell_filter(c, geom)) == repr(jd.cell_filter(c, geom))
                    assert d.cell_prefix(c) == jd.cell_prefix(c)
                    assert type(d.cell_prefix(c)) is int


def test_decompose_shapes():
    ft = FeatureType.from_spec("t", PT)
    d = decompose(parse_ecql(Q1), ft)
    assert d is not None and d.cells and len(d.strips) <= 4
    assert d.residual_key == repr(parse_ecql("type = 'bus'"))
    (ix, iy) = d.cells[0]
    bx = d.cell_boxes[(ix, iy)]
    assert bx[2] < bx[0] + 360.0 / (1 << d.level) + 1e-12
    d2 = decompose(parse_ecql(Q2), ft)
    shared = set(d.cells) & set(d2.cells)
    assert shared
    for c in shared:
        assert d.cell_boxes[c] == d2.cell_boxes[c]
    poly_ft = FeatureType.from_spec("p", "type:String,*geom:Polygon")
    assert decompose(parse_ecql("BBOX(geom, 0, 0, 10, 10)"), poly_ft) is None


def test_split_conjuncts_equal_reference():
    poly = "POLYGON((0 0, 10 0, 10 10, 0 10, 0 0))"
    for q in BOXES + [f"WITHIN(geom, {poly}) AND type = 'a'",
                      f"INTERSECTS(geom, {poly}) AND BBOX(geom, 0, 0, 1, 1)",
                      f"DISJOINT(geom, {poly})"]:
        for fn in ("split_bbox_conjunct", "split_region_conjunct"):
            got = getattr(cells, fn)(parse_ecql(q), "geom")
            want = getattr(jcells, fn)(jparse(q), "geom")
            assert repr(got) == repr(want), (fn, q)


# -- the store ---------------------------------------------------------------

def test_value_nbytes_equal_reference():
    for v in (3, 2.5, "abc", b"xy", np.zeros((4, 5), np.float32),
              (np.zeros(3), 1, "z")):
        assert cstore.value_nbytes(v) == jstore.value_nbytes(v)


def test_store_lru_epoch_and_snapshot():
    s, js = cstore.CacheStore(budget_bytes=100), jstore.CacheStore(budget_bytes=100)
    c0, j0 = Both.counts(metrics), Both.counts(jmetrics)
    for st in (s, js):
        for i in range(6):
            assert st.put(7, 1, ("k", i), np.zeros(4, np.float32))  # 16 bytes
        st.get(7, 1, ("k", 2))  # touch: 2 becomes the hottest
        st.put(7, 1, ("k", 6), np.zeros(8, np.float32))  # 32 bytes evict two
        assert not st.put(7, 1, ("big",), np.zeros(40, np.float32))
    assert s.export_uid(7)[1][-1][0] == ("k", 6)
    assert [k for k, _ in s.export_uid(7)[1]] == [k for k, _ in js.export_uid(7)[1]]
    assert s.total_bytes == js.total_bytes <= 100
    assert s.get(7, 2, ("k", 6)) is None  # another epoch drops the uid
    js.get(7, 2, ("k", 6))
    d = {k: v - c0[k] for k, v in Both.counts(metrics).items()}
    jd = {k: v - j0[k] for k, v in Both.counts(jmetrics).items()}
    assert d == jd and d["cache.evict"] == 2 and d["cache.invalidate"] == 5
    snap = s.snapshot()
    assert snap["budget_bytes"] == 100 and "7" not in snap["datasets"]
    assert set(snap) == set(js.snapshot())
    s.put(8, 0, ("a",), 1)
    s.invalidate(8)
    assert s.total_entries == 0


def test_wire_round_trip_both_ways():
    vals = {("whole", "count", "f", None): 5,
            ("cell", "density", (0.0, 1.0, 2.0, 3.0), 4, 4, None, "INCLUDE", None, 3, 17):
                np.arange(16, dtype=np.float32).reshape(4, 4),
            ("whole", "stats", "Count()", "f", None): '{"kind": "count"}',
            ("curve", "f", None, 6, 2, 1, 1): np.ones((2, 2)),
            ("t",): (1, 2.5, "x", True)}
    for src_mod, dst_mod in ((cstore, jstore), (jstore, cstore)):
        src, dst = src_mod.CacheStore(), dst_mod.CacheStore()
        for k, v in vals.items():
            src.put(1, 3, k, v)
        epoch, wire = src.export_wire(1)
        assert epoch == 3 and len(wire) == len(vals)
        assert dst.import_wire(9, 4, wire) == len(vals)
        for k, v in vals.items():
            assert_same(dst.get(9, 4, k), v)
    for v in vals.values():
        assert cstore.encode_wire_value(v) == jstore.encode_wire_value(v)
    assert cstore.encode_wire_value(object()) is None


# -- the metrics registry's core and the heat table ---------------------------

def test_registry_core_equals_reference():
    r, jr = metrics.MetricRegistry(), jmetrics.MetricRegistry()
    for reg in (r, jr):
        reg.counter("c").inc()
        reg.counter("c").inc(4)
        reg.gauge("g").set(2.5)
        reg.gauge("f", lambda: 7.0)
        with pytest.raises(ValueError):
            reg.gauge("f", lambda: 8.0)
        reg.gauge("f", lambda: 9.0, replace=True)
        for s in (0.0004, 0.003, 0.2, 0.2, 7.0, 99.0):
            reg.timer("t").update(s)
            reg.histogram("h").observe(s, trace_id="x")
        reg.histogram("n", buckets=(1.0, 2.0), unit=None).observe(1.5)
        with reg.timer("ctx").time():
            pass
        with pytest.raises(TypeError):
            reg.counter("g")
    rep, jrep = r.report(), jr.report()
    for k in ("ctx",):  # wall-clock durations
        rep.pop(k), jrep.pop(k)
    assert rep == jrep
    h, jh = r.histogram("h").snapshot(), jr.histogram("h").snapshot()
    assert {k: v for k, v in h.items() if k != "exemplars"} == \
        {k: v for k, v in jh.items() if k != "exemplars"}
    assert r.histogram("h").quantile(0.5) == jr.histogram("h").quantile(0.5)
    assert r.timer("t").mean_s == jr.timer("t").mean_s
    r.clear()
    assert r.report() == {}


def test_process_registry_and_names():
    for name in ("CACHE_HIT", "CACHE_PARTIAL", "CACHE_MISS", "CACHE_PUT", "CACHE_EVICT",
                 "CACHE_INVALIDATE", "CACHE_BYTES", "CACHE_ENTRIES", "CACHE_HIER_HIT",
                 "CACHE_HIER_PROMOTE", "CACHE_HIER_RESIDUAL", "CACHE_POLYGON",
                 "CACHE_CURVE_REGION", "CACHE_PERSIST_RESTORED", "EXEC_DEVICE_DISPATCH",
                 "HEAT_CELLS", "HEAT_EVICTED"):
        assert getattr(metrics, name) == getattr(jmetrics, name)
    before = metrics.registry().counter("test.torch.cache").value
    metrics.inc("test.torch.cache", 3)
    metrics.observe("test.torch.cache.h", 0.01)
    assert metrics.registry().counter("test.torch.cache").value == before + 3
    assert metrics.registry().histogram("test.torch.cache.h").count >= 1


def test_heat_table_equals_reference():
    t, jt = heat.HeatTable(max_cells=3), jheat.HeatTable(max_cells=3)
    e0 = metrics.registry().counter(metrics.HEAT_EVICTED).value
    je0 = jmetrics.registry().counter(jmetrics.HEAT_EVICTED).value
    ops = [("a", 5, 17, 1, 0, 0.0), ("a", 5, 17, 0, 1, 2.5), ("a", 5, 18, 1, 0, 0.0),
           ("b", 3, 2, 0, 1, 1.0), ("a", 6, 99, 1, 0, 0.0), ("a", 5, 17, 1, 0, 0.0)]
    for tab in (t, jt):
        for s, lvl, pre, h, m, ms in ops:
            tab.record(s, lvl, pre, hit=h, miss=m, device_ms=ms)
    assert t.snapshot() == jt.snapshot()
    assert t.snapshot(top=1) == jt.snapshot(top=1)
    assert (metrics.registry().counter(metrics.HEAT_EVICTED).value - e0
            == jmetrics.registry().counter(jmetrics.HEAT_EVICTED).value - je0 > 0)
    with config.HEAT_CELLS_MAX.scoped(0):
        off = heat.HeatTable()
        off.record("a", 1, 1, hit=1)
        assert off.snapshot() == {}
    t.reset()
    assert t.snapshot() == {}


def test_cache_feeds_heat_like_reference(b):
    heat.reset()
    jheat.reset()
    b.call(count(Q1))
    b.call(count(Q2))

    def rows(snap):
        return [{k: v for k, v in r.items() if k != "device_ms"}
                for r in snap.get("pts", [])]

    got, want = rows(heat.snapshot()), rows(jheat.snapshot())
    assert got == want and got


# -- partitioned stores -----------------------------------------------------

def test_partitioned_store_cache(tmp_path):
    r = np.random.default_rng(3)
    n = 2000
    lo = np.datetime64("2020-01-01", "ms").astype(np.int64)
    data = {
        "geom__x": r.uniform(-20, 20, n), "geom__y": r.uniform(-20, 20, n),
        "weight": r.uniform(0, 1, n),
        "dtg": (lo + r.integers(0, 40 * 86_400_000, n)).astype("datetime64[ms]"),
    }
    jconfig.MESH_DEVICES.set(1)
    try:
        with config.SPILL_DIR.scoped(str(tmp_path)), \
                config.MAX_RESIDENT_PARTITIONS.scoped(2):
            pair = Both("part", "weight:Float,dtg:Date,*geom:Point;geomesa.partition='time'",
                        data, np.arange(n).astype(str), n_shards=2)
        q = ("BBOX(geom, -10, -10, 12.5, 12.5) AND "
             "dtg DURING 2020-01-01T00:00:00Z/2020-02-01T00:00:00Z")
        f = lambda ds: ds.count("part", q)  # noqa: E731
        cold = pair.cold(f)
        n1, d = pair.call(f, **PER_AXIS_4)
        assert n1 == cold and d["cache.miss"] == 1
        n2, d = pair.call(f, **PER_AXIS_4)
        assert n2 == cold and pair.p_path()["cache"] == "hit"
        assert d[metrics.EXEC_DEVICE_DISPATCH] == 0
        jkeys, pkeys = pair.keys()
        assert pkeys == jkeys
    finally:
        jconfig.MESH_DEVICES.set(None)
