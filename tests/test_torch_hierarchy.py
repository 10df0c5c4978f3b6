"""PyTorch port vs the JAX package: hierarchical pre-aggregation, polygon
regions and curve chunk families of the aggregate cache
(``cache/hierarchy.py``, ``cache/cells.py::decompose_region``,
``cache/service.py::_serve_curve``).

The scenarios of ``tests/test_hierarchy.py`` run through both packages on
the same seeded global rows (some exactly on level-4 cell edges and on the
domain edges x = 180, y = 90) with both packages' cache knobs scoped
alike. Each call asserts the port's answer bit-identical to the JAX
package's cached answer and to the port's cache-off scan, the per-call
deltas of every ``cache.*`` counter equal between the packages, the
port's ``exec.device.dispatch`` delta zero exactly where the reference's
is (a warm zoom-out launches nothing), and the cache's exec-path notes
equal. The store key sets are compared after a pan / zoom / polygon
sequence. The JAX side runs with one device (``geomesa.mesh.devices`` 1).
"""

import contextlib

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.cache import AggregateCache as JAggregateCache
from geomesa_tpu.cache import cells as jcells
from geomesa_tpu.cache import hierarchy as jhierarchy
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.schema.feature_type import FeatureType as JFeatureType
from geomesa_tpu_torch import GeoDataset, config, metrics
from geomesa_tpu_torch.cache import AggregateCache, decompose, decompose_region, hierarchy
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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

    def call(self, fn, enabled=True, notes=True, close=None, **knobs):
        """``fn(ds)`` on both packages: returns (port answer, port delta).
        ``knobs``: config attribute name -> value, scoped on both.
        ``close(port, jax)``: the packages' answers are held to it instead
        of bit identity (weighted curves)."""
        knobs = {"CACHE_ENABLED": "true" if enabled else "false", **knobs}
        jout, jd = self._side(self.j, jconfig, jmetrics, fn, knobs)
        jpath = self.j_path() if notes else None
        pout, pd = self._side(self.p, config, metrics, fn, knobs)
        dk = metrics.EXEC_DEVICE_DISPATCH
        assert {k: pd[k] for k in CACHE_COUNTERS} == {k: jd[k] for k in CACHE_COUNTERS}
        assert (pd[dk] == 0) == (jd[dk] == 0), (pd[dk], jd[dk])
        if close is None:
            assert_same(pout, jout)
        else:
            close(pout, jout)
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


#: the regional zoom-out (test_hierarchy.py's at four cells an axis: the
#: 90 x 45 warm boxes at level 4, the 180 x 90 zoom-out at level 3; here at
#: two, levels 3 and 2)
ZOOM = "BBOX(geom, -90, -45, 90, 45)"
WARM4 = [
    "BBOX(geom, -90, -45, 0, 0)", "BBOX(geom, 0, -45, 90, 0)",
    "BBOX(geom, -90, 0, 0, 45)", "BBOX(geom, 0, 0, 90, 45)",
]
#: the domain-spanning query (two cells an axis: level 1, no strips)
WORLD = "BBOX(geom, -180, -90, 180, 90)"
WORLD_WARM = [
    "BBOX(geom, -180, -90, 0, 0)", "BBOX(geom, 0, -90, 180, 0)",
    "BBOX(geom, -180, 0, 0, 90)", "BBOX(geom, 0, 0, 180, 90)",
]
POLY = "POLYGON((-100 -40, 100 -50, 120 60, -120 55, -100 -40))"
POLY_Q = f"INTERSECTS(geom, {POLY})"
PER_AXIS_4 = {"CACHE_CELLS_PER_AXIS": "4"}
#: the JAX side traces every new cell scan: the domain zoom-outs warm 16
#: level-2 cells and assemble the 4 of level 1 (test_hierarchy.py takes
#: four cells an axis, 32 and 16)
PER_AXIS_2 = {"CACHE_CELLS_PER_AXIS": "2"}
NO_HIER = {"CACHE_HIERARCHY": "false"}
SPEC = "type:String,weight:Float,*geom:Point"
WORLD_BOX = (-180.0, -90.0, 180.0, 90.0)


def make_data():
    """test_hierarchy.py's rows."""
    r = np.random.default_rng(11)
    n = 2500
    edges = np.arange(-90.0, 90.1, 22.5)
    bx, by = np.meshgrid(edges, edges[:5])
    x = np.concatenate([r.uniform(-170, 170, n), bx.ravel(), [180.0, -180.0, 180.0]])
    y = np.concatenate([r.uniform(-85, 85, n), by.ravel(), [90.0, -90.0, 0.0]])
    m = len(x)
    return {
        "geom__x": x, "geom__y": y,
        "weight": r.uniform(0, 2, m).astype(np.float32),
        "type": r.choice(["bus", "car"], m),
    }, np.arange(m).astype(str)


@pytest.fixture(scope="module")
def pts():
    data, fids = make_data()
    jconfig.MESH_DEVICES.set(1)
    try:
        yield Both("pts", SPEC, data, fids, n_shards=2)
    finally:
        jconfig.MESH_DEVICES.set(None)


@pytest.fixture()
def b(pts):
    pts.fresh()
    return pts


def count(q, **kw):
    return lambda ds: ds.count("pts", q, **kw)


def curve(q="INCLUDE", level=6, bbox=WORLD_BOX, **kw):
    return lambda ds: ds.density_curve("pts", q, level=level, bbox=bbox, **kw)


DISPATCH = metrics.EXEC_DEVICE_DISPATCH


# -- zoom-out: O(visible cells), no device launch ---------------------------

def test_warm_zoomout_zero_dispatch_bit_identical(b):
    cold = b.cold(count(WORLD))
    for q in WORLD_WARM:
        b.call(count(q), **PER_AXIS_2)  # fine-level warm + roll-up
    warm, d = b.call(count(WORLD), **PER_AXIS_2)
    assert d[DISPATCH] == 0, "warm zoom-out launched on the device"
    assert b.p._last_plan.scanned_rows == 0
    hits, total = map(int, b.p_path()["cache_cells"].split("/"))
    assert hits == total > 0
    assert warm == cold
    jkeys, pkeys = b.keys()
    assert pkeys == jkeys


def test_zoomout_assembles_when_rollup_missing(b):
    """Fine cells stored without the hierarchy (no roll-up), then a coarse
    query with it on: assembly is the only path that avoids a scan."""
    cold = b.cold(count(WORLD))
    for q in WORLD_WARM:
        b.call(count(q), **PER_AXIS_2, **NO_HIER)
    warm, d = b.call(count(WORLD), **PER_AXIS_2)
    assert d[DISPATCH] == 0 and d["cache.hierarchy.hit"] > 0
    assert "hierarchy" in b.p_path()
    assert warm == cold
    again, d = b.call(count(WORLD), **PER_AXIS_2)
    assert again == cold and d["cache.hit"] == 1


def test_zoomout_density_and_stats_bit_identical(b):
    raster = (-120.0, -60.0, 120.0, 60.0)
    grid = lambda q: lambda ds: ds.density("pts", q, bbox=raster, width=64, height=32)  # noqa: E731
    stat = lambda q: lambda ds: ds.stats("pts", "Count();MinMax(weight)", q)  # noqa: E731
    grid_cold, stat_cold = b.cold(grid(WORLD)), b.cold(stat(WORLD)).value()
    for q in WORLD_WARM:
        b.call(grid(q), **PER_AXIS_2)
        b.call(stat(q), **PER_AXIS_2)
    grid_warm, d1 = b.call(grid(WORLD), **PER_AXIS_2)
    stat_warm, d2 = b.call(stat(WORLD), **PER_AXIS_2)
    assert d1[DISPATCH] == 0 and d2[DISPATCH] == 0
    assert_same(grid_warm, grid_cold)
    assert stat_warm.value() == stat_cold


def test_density_curve_cross_level_downsample(b):
    """Tile-pyramid zoom-out: level-k curve grids assemble from cached
    level-(k+1) chunks by downsample-add, exact and with no launch."""
    cold6, cold5 = b.cold(curve(level=6)), b.cold(curve(level=5))
    g6, _ = b.call(curve(level=6), **NO_HIER)
    g5, d = b.call(curve(level=5))
    assert d[DISPATCH] == 0 and d["cache.hierarchy.hit"] > 0
    assert "hierarchy" in b.p_path()
    g5b, _ = b.call(curve(level=5))
    assert_same(g6, cold6)
    assert_same(g5, cold5)
    assert_same(g5b, cold5)


def test_density_curve_chunk_reuse_across_tiles(b):
    b.call(curve(bbox=(-180.0, -90.0, 0.0, 90.0)))
    g, d = b.call(curve(bbox=(-180.0, -90.0, 90.0, 90.0)))
    assert d["cache.partial"] == 1
    assert_same(g, b.cold(curve(bbox=(-180.0, -90.0, 90.0, 90.0))))


def weighted_close(got, want):
    """Weighted curve grids against the JAX package's: a block is the
    difference of two f32 prefix sums the packages add in different orders
    (tests/test_torch_curve.py): rtol 1e-4 plus 8 f32 ulps of the largest
    prefix (the total weight)."""
    g, w = got[0], np.asarray(want[0])
    assert got[1] == want[1] and g.shape == w.shape
    atol = 8 * float(np.spacing(np.float32(w.sum())))
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)


def test_density_curve_weighted_stays_whole_result(b):
    f = curve(level=5, weight="weight")
    cold = b.cold(f)
    g1, _ = b.call(f, close=weighted_close)
    assert "cache_chunk" not in b.p_path()
    g2, d = b.call(f, close=weighted_close)
    assert d["cache.hit"] == 1
    assert_same(g1, cold)
    assert_same(g2, cold)


def test_polygon_curve_chunks_share_and_skip_outside(b):
    """Interior chunks come from the residual-keyed family a plain pyramid
    warmed, outside chunks are zeros with no scan, and the grid equals the
    undecomposed polygon scan."""
    cold = b.cold(curve(region=POLY))
    plain, _ = b.call(curve())
    g, d = b.call(curve(region=POLY))
    assert d["cache.curve.region"] == 1
    assert_same(g, cold)
    path = b.p_path()
    assert "outside" in path["cache_region_chunks"]
    hits, _total = map(int, path["cache_cells"].split("/"))
    assert hits > 0
    assert g[0].sum() <= plain[0].sum()
    g2, d = b.call(curve(region=POLY))
    assert d["cache.hit"] == 1
    assert_same(g2, cold)


def test_polygon_curve_warms_plain_family_for_later_queries(b):
    plain_cold = b.cold(curve())
    b.call(curve(region=POLY))
    g, _ = b.call(curve())
    hits, _total = map(int, b.p_path()["cache_cells"].split("/"))
    assert hits > 0
    assert_same(g, plain_cold)


# -- polygon regions --------------------------------------------------------

def test_polygon_count_density_stats_bit_identical(b):
    raster = (-180.0, -90.0, 180.0, 90.0)
    grid = lambda ds: ds.density("pts", POLY_Q, bbox=raster, width=64, height=48)  # noqa: E731
    stat = lambda ds: ds.stats("pts", "Count();Enumeration(type)", POLY_Q)  # noqa: E731
    cold_n, cold_g, cold_s = b.cold(count(POLY_Q)), b.cold(grid), b.cold(stat).value()
    n1, d = b.call(count(POLY_Q), **PER_AXIS_4)
    assert d["cache.polygon"] == 1
    path = b.p_path()
    assert path["cache_region"] == "polygon" and path["cache_boundary_cells"] > 0
    g1, _ = b.call(grid, **PER_AXIS_4)
    s1, _ = b.call(stat, **PER_AXIS_4)
    n2, d = b.call(count(POLY_Q), **PER_AXIS_4)
    assert d["cache.hit"] == 1 and b.p_path()["cache"] == "hit"
    assert n1 == n2 == cold_n
    assert_same(g1, cold_g)
    assert s1.value() == cold_s


def test_region_parameter_matches_explicit_conjunct(b):
    exact = b.cold(count(POLY_Q))
    assert b.cold(lambda ds: ds.count("pts", region=POLY)) == exact
    n, _ = b.call(lambda ds: ds.count("pts", region=POLY), **PER_AXIS_4)
    assert n == exact
    n1, _ = b.call(lambda ds: ds.count("pts", "type = 'bus'", region=POLY), **PER_AXIS_4)
    n2, _ = b.call(count(f"(type = 'bus') AND {POLY_Q}"), **PER_AXIS_4)
    assert n1 == n2


def test_polygon_cells_shared_with_bbox_queries(b):
    """At four cells an axis the box and the polygon both decompose at
    level 2, where two of the polygon's interior cells lie in the box."""
    b.call(count("BBOX(geom, -180, -45, 180, 45)"), **PER_AXIS_4)
    n, d = b.call(count(POLY_Q), **PER_AXIS_4)
    hits, _total = map(int, b.p_path()["cache_cells"].split("/"))
    assert hits > 0 and d["cache.hit"] == 0
    assert n == b.cold(count(POLY_Q))


def test_polygon_boundary_exactness_on_cell_edges():
    """Points on level cell edges and on / near the polygon boundary: the
    decomposed total equals the exact scan."""
    poly = "POLYGON((-45 -22.5, 45 -22.5, 45 22.5, -45 22.5, -45 -22.5))"
    eps = 1e-9
    xs = [-45.0, 45.0, 0.0, 22.5, -22.5, 45.0 - eps, -45.0 + eps,
          45.0 + eps, -45.0 - eps, 22.5, 0.0]
    ys = [0.0, 0.0, 22.5, -22.5, 22.5, 0.0, 0.0, 0.0, 0.0,
          22.5 - eps, -22.5 + eps]
    m = len(xs)
    pair = Both("edge", "type:String,*geom:Point",
                {"geom__x": np.asarray(xs), "geom__y": np.asarray(ys),
                 "type": np.array(["a"] * m)}, np.arange(m).astype(str), n_shards=2)
    f = lambda ds: ds.count("edge", f"INTERSECTS(geom, {poly})")  # noqa: E731
    cold = pair.cold(f)
    for _ in range(2):
        n, _ = pair.call(f)
        assert n == cold


@pytest.mark.parametrize("wkt", [
    "POLYGON((-120 -60, 120 -60, 120 70, -120 70, -120 -60), "
    "(-30 -20, 30 -20, 30 25, -30 25, -30 -20))",
    "MULTIPOLYGON(((-150 -70, -20 -70, -20 0, -150 0, -150 -70)), "
    "((20 10, 150 10, 150 80, 20 80, 20 10)))",
], ids=["holed", "multi"])
def test_polygon_with_hole_and_multipolygon(b, wkt):
    f = count(f"INTERSECTS(geom, {wkt})")
    cold = b.cold(f)
    for _ in range(2):
        n, _ = b.call(f)
        assert n == cold


def test_polygon_partitioned_store_residual_fans_out(tmp_path):
    """Boundary scans go through the partitioned executor and stay exact."""
    r = np.random.default_rng(5)
    n = 3000
    lo = np.datetime64("2020-01-01", "ms").astype(np.int64)
    data = {
        "geom__x": r.uniform(-60, 60, n), "geom__y": r.uniform(-50, 50, n),
        "weight": r.uniform(0, 1, n),
        "dtg": (lo + r.integers(0, 40 * 86_400_000, n)).astype("datetime64[ms]"),
    }
    jconfig.MESH_DEVICES.set(1)
    try:
        with config.SPILL_DIR.scoped(str(tmp_path)), config.MAX_RESIDENT_PARTITIONS.scoped(2):
            pair = Both("part", "weight:Float,dtg:Date,*geom:Point;geomesa.partition='time'",
                        data, np.arange(n).astype(str), n_shards=2)
        poly = "POLYGON((-50 -40, 50 -45, 55 45, -55 40, -50 -40))"
        f = lambda ds: ds.count("part", f"INTERSECTS(geom, {poly})")  # noqa: E731
        cold = pair.cold(f)
        n1, d = pair.call(f, **PER_AXIS_4)
        assert n1 == cold and d["cache.polygon"] == 1 and d[DISPATCH] > 0
        n2, d = pair.call(f, **PER_AXIS_4)
        assert n2 == cold and pair.p_path()["cache"] == "hit" and d[DISPATCH] == 0
    finally:
        jconfig.MESH_DEVICES.set(None)


# -- invalidation -----------------------------------------------------------

def test_subtree_invalidation_under_insert_delete(b):
    """At two cells an axis the warm boxes fill level 3 and the zoom-out's
    level-2 cells are their merges."""
    for q in WARM4:
        b.call(count(q), **PER_AXIS_2)
    base, d = b.call(count(ZOOM), **PER_AXIS_2)
    assert "cache_cells" in b.p_path() and d["cache.put"] > 0
    rows = {"geom__x": [1.0, -80.0], "geom__y": [1.0, 40.0],
            "weight": [1.0, 1.0], "type": ["bus", "bus"]}
    for ds in (b.j, b.p):
        ds.insert("pts", rows, fids=["h1", "h2"])
        ds.flush("pts")
    n, d = b.call(count(ZOOM), **PER_AXIS_2)
    assert n == base + 2 and d["cache.invalidate"] > 0
    for ds in (b.j, b.p):
        ds.delete_features("pts", "IN ('h1', 'h2')")
    n, _ = b.call(count(ZOOM), **PER_AXIS_2)
    assert n == base == b.cold(count(ZOOM))


# -- seeded property test ---------------------------------------------------

def test_random_pan_zoom_polygon_sequence_bit_identical(b):
    """A seeded walk over pans, zooms, polygon counts and density rasters
    with inserts between: every cached answer equals the cache-off scan
    and the JAX package's, and the stores end with equal key sets."""
    r = np.random.default_rng(42)
    raster = (-180.0, -90.0, 180.0, 90.0)

    def random_query():
        kind = r.choice(["bbox", "zoom", "poly", "density"])
        if kind in ("bbox", "zoom", "density"):
            span = float(r.choice([45.0, 90.0, 180.0]))
            x0 = float(r.uniform(-180, 180 - span))
            y0 = float(r.uniform(-90, 90 - min(span, 90)))
            return kind, (f"BBOX(geom, {x0}, {y0}, {x0 + span}, "
                          f"{min(y0 + min(span, 90), 90.0)})")
        k = int(r.integers(3, 7))
        ang = np.sort(r.uniform(0, 2 * np.pi, k))
        cxp, cyp = r.uniform(-60, 60), r.uniform(-40, 40)
        rad = r.uniform(25, 70)
        ring = [(float(np.clip(cxp + rad * np.cos(a), -179, 179)),
                 float(np.clip(cyp + rad * np.sin(a), -89, 89))) for a in ang]
        wkt = ", ".join(f"{px:.4f} {py:.4f}" for px, py in ring + [ring[0]])
        return kind, f"INTERSECTS(geom, POLYGON(({wkt})))"

    fid = 20_000
    added = []
    for step in range(10):
        kind, q = random_query()
        if kind == "density":
            f = lambda ds, q=q: ds.density("pts", q, bbox=raster, width=32, height=32)  # noqa: E731
        else:
            f = count(q)
        warm, _ = b.call(f, **PER_AXIS_4)
        assert_same(warm, b.cold(f))
        if step % 4 == 3:  # an epoch bump in the sequence
            row = {"geom__x": [float(r.uniform(-170, 170))],
                   "geom__y": [float(r.uniform(-85, 85))],
                   "weight": [1.0], "type": ["car"]}
            for ds in (b.j, b.p):
                ds.insert("pts", row, fids=[str(fid)])
                ds.flush("pts")
            added.append(str(fid))
            fid += 1
    jkeys, pkeys = b.keys()
    assert pkeys == jkeys and pkeys
    ids = ", ".join(f"'{f}'" for f in added)
    for ds in (b.j, b.p):
        ds.delete_features("pts", f"IN ({ids})")


# -- unit: decomposition and hierarchy shapes ------------------------------

def _pt_ft():
    return FeatureType.from_spec("t", "type:String,*geom:Point")


def test_world_bbox_has_no_strips():
    with config.CACHE_CELLS_PER_AXIS.scoped(4):
        d = decompose(parse_ecql(WORLD), _pt_ft())
    assert d is not None and not d.strips
    n = 1 << d.level
    assert d.cell_boxes[(n - 1, n - 1)][2] == 180.0
    assert d.cell_boxes[(n - 1, n - 1)][3] == 90.0
    assert d.cell_boxes[(0, 0)][2] < -180.0 + 360.0 / n


REGIONS = [
    POLY_Q, f"{POLY_Q} AND type = 'bus'",
    "INTERSECTS(geom, POLYGON((-45 -22.5, 45 -22.5, 45 22.5, -45 22.5, -45 -22.5)))",
    "WITHIN(geom, MULTIPOLYGON(((-150 -70, -20 -70, -20 0, -150 0, -150 -70)), "
    "((20 10, 150 10, 150 80, 20 80, 20 10))))",
    "INTERSECTS(geom, POLYGON((-120 -60, 120 -60, 120 70, -120 70, -120 -60), "
    "(-30 -20, 30 -20, 30 25, -30 25, -30 -20)))",
    "INTERSECTS(geom, POLYGON((0 0, 0.001 0, 0.001 0.001, 0 0)))",
    f"{POLY_Q} OR type = 'bus'", f"{POLY_Q} AND BBOX(geom, 0, 0, 10, 10)",
]


@pytest.mark.parametrize("q", REGIONS)
def test_decompose_region_equals_reference(q):
    jft = JFeatureType.from_spec("t", "type:String,*geom:Point")
    for per_axis in ("8", "4"):
        with config.CACHE_CELLS_PER_AXIS.scoped(per_axis), \
                jconfig.CACHE_CELLS_PER_AXIS.scoped(per_axis):
            r = decompose_region(parse_ecql(q), _pt_ft())
            jr = jcells.decompose_region(jparse(q), jft)
            if jr is None:
                assert r is None
                continue
            assert (r.level, r.residual_key, r.cells, r.cell_boxes, r.boundary,
                    r.boundary_boxes) == (jr.level, jr.residual_key, jr.cells,
                                          jr.cell_boxes, jr.boundary, jr.boundary_boxes)
            assert repr(r.residual_scan_filter("geom")) == repr(jr.residual_scan_filter("geom"))


def test_decompose_region_shapes():
    r = decompose_region(parse_ecql(POLY_Q), _pt_ft())
    assert r is not None and r.cells and r.boundary
    assert r.residual_key == repr(parse_ecql("INCLUDE"))
    assert not set(r.cells) & set(r.boundary)
    assert len(r.boundary_boxes) <= len(r.boundary)
    with config.CACHE_POLYGON.scoped("false"):
        assert decompose_region(parse_ecql(POLY_Q), _pt_ft()) is None


def test_hierarchy_child_order_and_rollup():
    store = {}
    get = lambda lvl, c: store.get((lvl, c))  # noqa: E731
    put = lambda lvl, c, v: store.__setitem__((lvl, c), v)  # noqa: E731
    merge4 = lambda vals: sum(vals)  # noqa: E731
    assert hierarchy.children((3, 5)) == [(6, 10), (7, 10), (6, 11), (7, 11)]
    assert hierarchy.children((3, 5)) == jhierarchy.children((3, 5))
    assert hierarchy.parent((7, 11)) == jhierarchy.parent((7, 11)) == (3, 5)
    for ch, v in zip(hierarchy.children((0, 0)), (1, 2, 4, 8)):
        put(5, ch, v)
    stats = {}
    assert hierarchy.assemble(get, put, merge4, 4, (0, 0), stats=stats) == 15
    assert store[(4, (0, 0))] == 15 and stats == {"assembled": 1, "deepest": 5}
    store.clear()
    for ch, v in zip(hierarchy.children((1, 1)), (1, 1, 1, 1)):
        put(3, ch, v)
    assert hierarchy.rollup(get, put, merge4, 3, (2, 2)) == 1
    assert store[(2, (1, 1))] == 4


def test_curve_assembly_equals_reference():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 9, (8, 8)).astype(np.float64)
    d = hierarchy.downsample(g)
    assert d.shape == (4, 4) and d[0, 0] == g[0, 0] + g[0, 1] + g[1, 0] + g[1, 1]
    assert np.array_equal(d, jhierarchy.downsample(g))
    outs = []
    for mod in (hierarchy, jhierarchy):
        store = {}
        get = lambda *k: store.get(k)  # noqa: E731
        put = lambda *a: store.__setitem__(a[:4], a[4])  # noqa: E731
        wrote = mod.rollup_curve(get, put, 6, 8, 1, 2, g)
        got = mod.assemble_curve(get, put, 2, 1, 1, 2)
        outs.append((wrote, sorted(store), got))
    assert outs[0][0] == outs[1][0] == 3
    assert outs[0][1] == outs[1][1]
    assert outs[0][2] is None and outs[1][2] is None
    store = {(6, 8, 1, 2): g}
    got = hierarchy.assemble_curve(lambda *k: store.get(k),
                                   lambda *a: store.__setitem__(a[:4], a[4]), 5, 4, 1, 2)
    assert np.array_equal(got, d)
