"""PyTorch port vs the JAX package: extent geometries (LineString, Polygon,
Multi*, Geometry columns), the xz2 / xz3 index tables, exact spatial
refinement over the ``__wkt`` column, and loose BBOX.

Both packages ingest the same geometries made from a NumPy seed (random
star-convex polygons and polylines as in ``tests/test_spatial_exact.py``,
one in ten with a hole or as a Multi* of two parts) into 4 shards with
explicit feature ids; the JAX side runs its Pallas kernels in interpret
mode with compaction forced, the port runs on the CPU with its kernels'
plain versions. Rows are planted where f32 and the envelope tests matter:
envelopes touching the literal's bounds, bounds one f64 ulp outside them
(equal at f32), and a copy of the polygon literal itself."""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.filter import compile_filter as jcompile
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.index import keyspace as jks
from geomesa_tpu.utils import geometry as jgeo
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch import config as pconfig
from geomesa_tpu_torch.convert import store_from_arrays
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.index.store import device_view
from geomesa_tpu_torch.utils import geometry as geo

N = 1500
T0 = parse_iso_ms("2021-06-01")
MONTH_MS = 30 * 86_400_000
LIT_POLY = "POLYGON ((-2 -2, 4 -1, 5 4, -1 5, -3 1, -2 -2))"
LIT_HOLED = ("POLYGON ((-6 -6, 6 -6, 6 6, -6 6, -6 -6), "
             "(-2 -2, 2 -2, 2 2, -2 2, -2 -2))")
LIT_LINE = "LINESTRING (-8 -8, 0 0, 3 6, 9 2)"
BOX = (-2.0, -2.0, 3.0, 3.0)
DURING = "dtg DURING 2021-06-05T00:00:00Z/2021-06-15T00:00:00Z"


def _ring(rng, cx, cy, scale=1.0):
    k = int(rng.integers(3, 7))
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(0.3, 1.6, k) * scale
    pts = [(float(cx + a * np.cos(t)), float(cy + a * np.sin(t))) for t, a in zip(ang, r)]
    return pts + [pts[0]], ang, r


def rand_polys(rng, n):
    """Star-convex polygons around (-10..10)^2; one in ten with a hole (the
    ring scaled by 0.3 toward its centre), one in ten a 2-part
    MultiPolygon."""
    out = []
    for i in range(n):
        cx, cy = rng.uniform(-10, 10, 2)
        shell, ang, r = _ring(rng, cx, cy)
        if i % 10 == 3:
            hole = [(float(cx + 0.3 * a * np.cos(t)), float(cy + 0.3 * a * np.sin(t)))
                    for t, a in zip(ang, r)]
            out.append(geo.Polygon(tuple(shell), (tuple(hole + [hole[0]]),)))
        elif i % 10 == 7:
            other, _, _ = _ring(rng, cx + 3.5, cy + 0.5, 0.5)
            out.append(geo.MultiPolygon((geo.Polygon(tuple(shell)), geo.Polygon(tuple(other)))))
        else:
            out.append(geo.Polygon(tuple(shell)))
    return out


def rand_lines(rng, n):
    """3-5 vertex polylines; one in ten a 2-part MultiLineString."""
    out = []
    for i in range(n):
        x0, y0 = rng.uniform(-10, 10, 2)
        k = int(rng.integers(2, 5))
        pts = np.cumsum(np.vstack([[x0, y0], rng.uniform(-1.5, 1.5, (k, 2))]), axis=0)
        ls = geo.LineString(tuple((float(x), float(y)) for x, y in pts))
        if i % 10 == 5:
            pts2 = pts + rng.uniform(1, 2, 2)
            out.append(geo.MultiLineString(
                (ls, geo.LineString(tuple((float(x), float(y)) for x, y in pts2)))))
        else:
            out.append(ls)
    return out


def planted_polys():
    """Envelopes on and one f64 ulp outside the BBOX literal's bounds, and
    the polygon literal itself (EQUALS)."""
    lo = np.nextafter(BOX[0], -np.inf)
    hi = np.nextafter(BOX[2], np.inf)
    return [
        geo.parse_wkt("POLYGON ((-4 0, -2 0, -3 1, -4 0))"),        # xmax on BOX's xmin
        geo.parse_wkt("POLYGON ((3 0, 5 0, 4 1, 3 0))"),            # xmin on BOX's xmax
        geo.Polygon(((-4.0, 0.0), (lo, 0.0), (-3.0, 1.0), (-4.0, 0.0))),
        geo.Polygon(((hi, 0.0), (5.0, 0.0), (4.0, 1.0), (hi, 0.0))),
        geo.parse_wkt(LIT_POLY),
        geo.parse_wkt("POLYGON ((-1 -1, 1 -1, 1 1, -1 1, -1 -1))"),  # inside the hole
    ]


def planted_lines():
    lo = np.nextafter(BOX[0], -np.inf)
    return [
        geo.parse_wkt("LINESTRING (-4 0, -2 0)"),                    # ends on BOX's edge
        geo.LineString(((-4.0, 1.0), (lo, 1.0))),
        geo.parse_wkt("LINESTRING (-8 -8, 0 0)"),                    # on LIT_LINE
        geo.parse_wkt("LINESTRING (0 0, 3 6, 9 2)"),
    ]


def make_data(geoms, seed):
    rng = np.random.default_rng(seed)
    n = len(geoms)
    return {
        "name": [f"c{int(v):02d}" for v in rng.integers(0, 40, n)],
        "height": rng.uniform(0, 50, n).astype(np.float32),
        "dtg": (T0 + rng.integers(0, MONTH_MS, n)).astype("datetime64[ms]"),
        "geom": [g.wkt() for g in geoms],
    }


def fids_for(n):
    return np.char.add("f", np.arange(n).astype(str))


def build_pair(spec, data):
    fids = fids_for(len(data["geom"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        try:
            j = JGeoDataset(n_shards=4)
            j.create_schema("t", spec)
            j.insert("t", data, fids=fids)
            j.flush("t")
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)
    p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    p.create_schema("t", spec)
    p.insert("t", data, fids=fids)
    p.flush("t")
    return j, p


POLY_SPEC = "name:String,height:Float,dtg:Date,*geom:Polygon"
LINE_SPEC = "name:String,height:Float,dtg:Date,*geom:LineString"


@pytest.fixture(scope="module")
def stores():
    polys = rand_polys(np.random.default_rng(11), N) + planted_polys()
    lines = rand_lines(np.random.default_rng(7), N) + planted_lines()
    poly = build_pair(POLY_SPEC, make_data(polys, 3))
    line = build_pair(LINE_SPEC, make_data(lines, 4))
    return {"polygon": poly, "line": line}


@pytest.fixture(autouse=True)
def _compaction():
    """The JAX side compacts every scan, as the port's datasets here do."""
    config.COMPACT_MIN_ROWS.set(1)
    config.COMPACT_FRACTION.set(2.0)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
            yield
    finally:
        config.COMPACT_MIN_ROWS.set(None)
        config.COMPACT_FRACTION.set(None)


def _assert_tables_equal(jst, pst, name):
    jt, pt = jst.tables[name], pst.tables[name]
    assert jt.key_shifts == pt.key_shifts
    assert np.array_equal(jt.order, pt.order)
    assert np.array_equal(jt.shard_bounds, pt.shard_bounds)
    assert set(jt.key_columns) == set(pt.key_columns)
    for k, v in jt.key_columns.items():
        assert v.dtype == pt.key_columns[k].dtype, k
        assert np.array_equal(v, pt.key_columns[k]), k


def _forget_jax_plans(j):
    """Drop the JAX dataset's plan cache: it is keyed without
    ``geomesa.loose.bbox``, so an exact plan cached for the same ECQL by an
    earlier test would serve a loose call (ROADMAP Queue 3)."""
    j.__dict__.pop("_plan_cache", None)


def _fids(ds, q):
    fc = ds.query("t", q)
    return sorted(fc.fids) if len(fc) else []


# -- encoding, tables and keys ---------------------------------------------------------
@pytest.mark.parametrize("kind", ["polygon", "line"])
def test_encoded_columns_equal(stores, kind):
    """Bounds, bounds centroid and WKT columns equal the JAX package's."""
    j, p = stores[kind]
    jm, pm = j._store("t")._all.columns, p._store("t")._all.columns
    for c in ("geom__xmin", "geom__ymin", "geom__xmax", "geom__ymax", "geom__x", "geom__y"):
        assert pm[c].dtype == np.float64 and np.array_equal(pm[c], jm[c]), c
    assert pm["geom__wkt"].dtype == object
    assert pm["geom__wkt"].tolist() == jm["geom__wkt"].tolist()
    assert device_view(pm["geom__wkt"]) is None
    table = p._store("t").tables["xz2"]
    assert table.is_host_only("geom__wkt")
    assert list(table.device_columns(["geom__wkt", "geom__xmin"])) == ["geom__xmin"]


@pytest.mark.parametrize("kind", ["polygon", "line"])
def test_extent_tables_equal(stores, kind):
    """xz3, xz2 and id by default, with the JAX package's order, keys,
    shifts and shard bounds; the sketches carry no z histograms."""
    j, p = stores[kind]
    jst, pst = j._store("t"), p._store("t")
    assert list(pst.tables) == list(jst.tables) == ["xz3", "xz2", "id"]
    for name in ("xz3", "xz2", "id"):
        _assert_tables_equal(jst, pst, name)
    assert set(pst.stats) == set(jst.stats)
    assert pst.stats["bounds"].value() == jst.stats["bounds"].value()
    assert pst.stats["time-bounds"].value() == jst.stats["time-bounds"].value()


@pytest.mark.parametrize("kind", ["xz2", "xz3"])
def test_xz_keys_equal(stores, kind):
    j, p = stores["polygon"]
    jst, pst = j._store("t"), p._store("t")
    cols = jst._all.columns
    jk = jst.tables[kind].keyspace.index_keys(jst.ft, cols)
    pk = pst.tables[kind].keyspace.index_keys(pst.ft, pst._all.columns)
    assert set(jk) == set(pk)
    for k in jk:
        assert jk[k].dtype == pk[k].dtype and np.array_equal(jk[k], pk[k]), k


PLANS = {
    "bbox": f"BBOX(geom, {', '.join(str(v) for v in BOX)})",
    "bbox_during": f"BBOX(geom, {', '.join(str(v) for v in BOX)}) AND {DURING}",
    "intersects": f"INTERSECTS(geom, {LIT_POLY})",
    "intersects_during": f"INTERSECTS(geom, {LIT_POLY}) AND {DURING}",
    "within": f"WITHIN(geom, {LIT_HOLED})",
    "line": f"CROSSES(geom, {LIT_LINE}) AND {DURING}",
    "dwithin": f"DWITHIN(geom, {LIT_LINE}, 20, kilometers)",
    "disjoint": f"DISJOINT(geom, {LIT_POLY})",
    "or": "BBOX(geom, -9, -9, -7, -7) OR BBOX(geom, 6, 6, 8, 8)",
    "small": f"BBOX(geom, 0.5, 0.5, 0.6, 0.6) AND {DURING}",
    "during": DURING,
    "include": "INCLUDE",
    "id": "IN ('f3', 'f17', 'nope')",
    "id_bbox": "IN ('f3') AND BBOX(geom, -9, -9, 9, 9)",
    "expr": "height * 2 > 60 AND BBOX(geom, -5, -5, 5, 5)",
    "many_bins": "BBOX(geom, -5, -5, 5, 5) AND dtg DURING 2021-01-01T00:00:00Z/2022-06-01T00:00:00Z",
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_and_windows_equal(stores, name):
    """The decider's index and the chosen table's scan windows equal the
    JAX package's."""
    j, p = stores["polygon"]
    q = PLANS[name]
    jplan = j._plan("t", q)[2]
    pplan = p._plan("t", q)
    assert pplan.index_name == jplan.index_name
    jst, pst = j._store("t"), p._store("t")
    jt, pt = jst.tables[jplan.index_name], pst.tables[pplan.index_name]
    if jplan.key_plan.disjoint:
        assert pplan.key_plan.disjoint
        return
    for a, b in zip(jt.windows(jplan.key_plan), pt.windows(pplan.key_plan)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert p.count("t", q) == j.count("t", q)


@pytest.mark.parametrize("cover", [2000, 32768], ids=["planner", "fine"])
@pytest.mark.parametrize("kind", ["xz2", "xz3"])
def test_xz_windows_at_both_covers(stores, kind, cover):
    j, p = stores["line"]
    q = f"BBOX(geom, -3, -3, 4, 2) AND {DURING}"
    jst, pst = j._store("t"), p._store("t")
    jt, pt = jst.tables[kind], pst.tables[kind]
    cap = max(cover, jks.MAX_SHARD_WINDOWS)
    with config.SCAN_RANGES_TARGET.scoped(cover), jks.window_cap(cap):
        want = jt.windows(jt.keyspace.plan(jst.ft, jparse(q)))
    got = pt.windows(pt.keyspace.plan(pst.ft, parse_ecql(q), cover), cap=cap)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


# -- exact spatial semantics -----------------------------------------------------------
OPS = ["INTERSECTS", "DISJOINT", "WITHIN", "CONTAINS", "CROSSES", "OVERLAPS",
       "TOUCHES", "EQUALS", "DWITHIN", "NOT_BBOX"]
LITERALS = {"polygon": LIT_POLY, "holed": LIT_HOLED, "line": LIT_LINE}


def _op_query(op, lit):
    if op == "DWITHIN":
        return f"DWITHIN(geom, {lit}, 50, kilometers)"
    if op == "NOT_BBOX":
        b = geo.parse_wkt(lit).bounds()
        return f"NOT BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
    return f"{op}(geom, {lit})"


@pytest.mark.parametrize("lit", ["polygon", "line"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["polygon", "line"])
def test_spatial_op_equal(stores, kind, op, lit):
    """Fids and counts of every spatial op against a polygon and a line
    literal equal the JAX package's; the scan refines on the host."""
    j, p = stores[kind]
    q = _op_query(op, LITERALS[lit])
    want = _fids(j, q)
    assert _fids(p, q) == want
    assert p.count("t", q) == j.count("t", q) == len(want)
    assert p._plan("t", q).exec_path["scan"] == "host+device-coarse"


@pytest.mark.parametrize("q", [
    f"WITHIN(geom, {LIT_HOLED})", f"INTERSECTS(geom, {LIT_HOLED})",
    f"NOT INTERSECTS(geom, {LIT_HOLED}) AND {DURING}",
    f"INTERSECTS(geom, {LIT_POLY}) OR CROSSES(geom, {LIT_LINE})",
    f"NOT (DISJOINT(geom, {LIT_POLY}) OR {DURING})",
], ids=["within_holed", "intersects_holed", "not_intersects", "or", "not_or"])
def test_nested_spatial_equal(stores, q):
    for kind in ("polygon", "line"):
        j, p = stores[kind]
        assert _fids(p, q) == _fids(j, q), kind


def test_not_bbox_equals_not_intersects(stores):
    """NOT BBOX agrees with NOT INTERSECTS of the box polygon (exact BBOX),
    in both directions, on the rows planted at the box's bounds."""
    j, p = stores["line"]
    box = "BBOX(geom, -2, -2, 3, 3)"
    poly = "POLYGON ((-2 -2, 3 -2, 3 3, -2 3, -2 -2))"
    got = _fids(p, f"NOT ({box})")
    assert got == _fids(p, f"NOT (INTERSECTS(geom, {poly}))") == _fids(j, f"NOT ({box})")
    assert _fids(p, box) == _fids(p, f"INTERSECTS(geom, {poly})") == _fids(j, box)


# -- compiled masks ----------------------------------------------------------------------
MASKS = {
    "intersects": f"INTERSECTS(geom, {LIT_POLY})",
    "within": f"WITHIN(geom, {LIT_POLY})",
    "contains": "CONTAINS(geom, POINT (0.5 0.5))",
    "equals": f"EQUALS(geom, {LIT_POLY})",
    "disjoint": f"DISJOINT(geom, {LIT_POLY})",
    "not_disjoint": f"NOT DISJOINT(geom, {LIT_POLY})",
    "not_intersects": f"NOT INTERSECTS(geom, {LIT_POLY})",
    "bbox": "BBOX(geom, -2, -2, 3, 3)",
    "not_bbox": "NOT BBOX(geom, -2, -2, 3, 3)",
    "dwithin": f"DWITHIN(geom, {LIT_LINE}, 50, kilometers)",
    "not_dwithin": f"NOT DWITHIN(geom, {LIT_LINE}, 50, kilometers)",
}


def _masks(j, p, q, loose=False):
    import jax.numpy as jnp

    jst, pst = j._store("t"), p._store("t")
    with config.LOOSE_BBOX.scoped(loose), pconfig.LOOSE_BBOX.scoped(loose):
        jc = jcompile(jparse(q), jst.ft, jst.dicts)
        pc = compile_filter(parse_ecql(q), pst.ft, pst.dicts)
    master = pst._all.columns
    host = {k: master[k] for k in pc.columns}
    dev = {k: device_view(v) for k, v in host.items()}
    n = pst.count
    got = np.broadcast_to(np.asarray(pc({k: torch.from_numpy(v) for k, v in dev.items()},
                                        torch)), (n,))
    want = np.broadcast_to(np.asarray(jc({k: jnp.asarray(v) for k, v in dev.items()},
                                         jnp)), (n,))
    return jc, pc, got, want, master


@pytest.mark.parametrize("name", sorted(MASKS))
def test_extent_masks_equal(stores, name):
    """The coarse f32 device mask equals the JAX package's bit for bit, the
    f64 host masks and the exact masks too, and the coarse mask holds every
    exact match."""
    j, p = stores["polygon"]
    jc, pc, got, want, master = _masks(j, p, MASKS[name])
    assert pc.columns == jc.columns
    assert pc.refine_columns == jc.refine_columns
    assert (pc.refine is None) == (jc.refine is None)
    assert np.array_equal(got, want)
    n = len(got)
    cols = {k: master[k] for k in list(pc.columns) + list(pc.refine_columns)}
    exact = pc.exact_mask(cols, n)
    assert np.array_equal(exact, jc.exact_mask(cols, n))
    assert not (exact & ~got).any()


@pytest.mark.parametrize("box", [BOX, (-2.0000001, -2.0, 3.0, 3.0000001), (4.0, 0.0, 4.0, 0.5)],
                         ids=["on_bounds", "inside_ulp", "degenerate"])
@pytest.mark.parametrize("kind", ["polygon", "line"])
def test_loose_bbox_equal(stores, kind, box):
    """Loose BBOX is the f32 envelope overlap with no refinement: mask and
    count equal the JAX package's, and its rows are exactly the f32
    envelope test's."""
    j, p = stores[kind]
    q = f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]})"
    jc, pc, got, want, master = _masks(j, p, q, loose=True)
    assert pc.refine is None and jc.refine is None
    assert np.array_equal(got, want)
    f = {k: master["geom__" + k].astype(np.float32) for k in ("xmin", "ymin", "xmax", "ymax")}
    b = [np.float32(v) for v in box]
    oracle = (f["xmin"] <= b[2]) & (f["xmax"] >= b[0]) & (f["ymin"] <= b[3]) & (f["ymax"] >= b[1])
    assert np.array_equal(got, oracle)
    with config.LOOSE_BBOX.scoped(True), pconfig.LOOSE_BBOX.scoped(True):
        _forget_jax_plans(j)
        assert p.count("t", q) == j.count("t", q) == int(oracle.sum())
        assert p._plan("t", q).exec_path["scan"].startswith("device")


def test_loose_bbox_density_takes_the_grouped_rung(stores):
    """A loose BBOX density on an xz table runs the grouped kernel's plain
    version over chunk boxes of the centroid columns; the grid equals the
    JAX package's (which scatters there) and the plain scatter's."""
    j, p = stores["polygon"]
    q = f"BBOX(geom, -6, -6, 6, 6) AND {DURING}"
    bbox = (-6.0, -6.0, 6.0, 6.0)
    with config.LOOSE_BBOX.scoped(True), pconfig.LOOSE_BBOX.scoped(True):
        _forget_jax_plans(j)
        want = j.density("t", q, bbox=bbox, width=64, height=64)
        got = p.density("t", q, bbox=bbox, width=64, height=64)
        ep = p._plan("t", q).exec_path
        assert ep["scan"] == "device-compact" and ep["density_kernel"] == "grouped", ep
        with pconfig.DENSITY_PALLAS_MAX_DUP.scoped(0.0):
            plan = p._plan("t", q)
            scatter = p._executor("t").density(plan, bbox, 64, 64)
            assert plan.exec_path["density_kernel"] == "scatter"
    assert np.array_equal(got, want)
    assert np.array_equal(got, scatter)
    assert got.sum() > 0


@pytest.fixture(scope="module")
def nan_stores():
    """The random polygons with five NaN-coordinate polygons among them
    (Geometry objects: WKT has no NaN); their xz keys sort them in with
    the rows around them."""
    nan = float("nan")
    data = make_data(rand_polys(np.random.default_rng(11), N), 3)
    wkts = data["geom"]
    k = 700
    fids = fids_for(len(wkts) + 5)
    jd = dict(data, geom=wkts[:k] + [jgeo.Polygon(((nan, nan),) * 4)] * 5 + wkts[k:])
    pd_ = dict(data, geom=wkts[:k] + [geo.Polygon(((nan, nan),) * 4)] * 5 + wkts[k:])
    for key in ("name", "height", "dtg"):
        v = list(data[key])
        jd[key] = pd_[key] = v[:k] + v[k - 5:k] + v[k:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        j = JGeoDataset(n_shards=4)
        j.create_schema("t", POLY_SPEC)
        j.insert("t", jd, fids=fids)
        j.flush("t")
    p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    p.create_schema("t", POLY_SPEC)
    p.insert("t", pd_, fids=fids)
    p.flush("t")
    return j, p


@pytest.mark.parametrize("q", [f"BBOX(geom, -6, -6, 6, 6) AND {DURING}",
                               "NOT BBOX(geom, -6, -6, 6, 6)", "INCLUDE"])
def test_grouped_density_over_nan_rows(nan_stores, q):
    """Chunks holding NaN-coordinate rows still pair with every tile their
    valid rows reach, and with the cell the device puts a NaN row in: the
    loose grouped grid equals the JAX package's scatter."""
    j, p = nan_stores
    bbox = (-12.0, -12.0, 12.0, 12.0)
    with config.LOOSE_BBOX.scoped(True), pconfig.LOOSE_BBOX.scoped(True):
        _forget_jax_plans(j)
        want = j.density("t", q, bbox=bbox, width=256, height=256)
        got = p.density("t", q, bbox=bbox, width=256, height=256)
        assert p._plan("t", q).exec_path["density_kernel"] == "grouped"
        assert int(got.sum()) == p.count("t", q) == j.count("t", q)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["polygon", "line"])
def test_density_respects_refinement(stores, kind):
    """The density of a refine-bearing plan grids the refined rows only:
    equal to the JAX package's grid, summing to the exact count."""
    j, p = stores[kind]
    q = f"INTERSECTS(geom, {LIT_POLY})"
    bbox = (-12.0, -12.0, 12.0, 12.0)
    want = j.density("t", q, bbox=bbox, width=32, height=32)
    got = p.density("t", q, bbox=bbox, width=32, height=32)
    assert np.array_equal(got, want)
    assert int(got.sum()) == p.count("t", q) == j.count("t", q)


def test_stats_respect_refinement(stores):
    j, p = stores["polygon"]
    q = f"WITHIN(geom, {LIT_HOLED})"
    want = j.stats("t", "Count();MinMax(height)", q)
    got = p.stats("t", "Count();MinMax(height)", q)
    assert [s.value() for s in got.stats] == [s.value() for s in want.stats]


# -- features ------------------------------------------------------------------------
def test_features_return_wkt(stores):
    j, p = stores["polygon"]
    q = f"INTERSECTS(geom, {LIT_POLY}) AND {DURING}"
    jd, pd = j.query("t", q).to_dict(), p.query("t", q).to_dict()
    order_j = np.argsort(jd["__fid__"])
    order_p = np.argsort(pd["__fid__"])
    assert [jd["geom"][i] for i in order_j] == [pd["geom"][i] for i in order_p]
    assert all(isinstance(w, str) for w in pd["geom"])
    stored = dict(zip(fids_for(p._store("t").count).tolist(),
                      p._store("t")._all.columns["geom__wkt"].tolist()))
    assert all(stored[f] == w for f, w in zip(pd["__fid__"], pd["geom"]))


def test_wkt_full_precision_round_trip():
    """WKT is the master store of extents: the port formats it at full
    precision, as the JAX package does, and parses it back exactly."""
    x = 100.12345678901234
    for wkt in (
        f"POLYGON (({x} 0, {x + 1} 0, {x + 1} 1.5, {x} 0), "
        f"({x + 0.1} 0.1, {x + 0.2} 0.1, {x + 0.2} 0.2, {x + 0.1} 0.1))",
        f"MULTIPOLYGON ((({x} 0, 101 0, 101 1, {x} 0)), ((102 2, 103 2, 103 3, 102 2)))",
        f"LINESTRING ({x} 1e-300, -0.1 2.5e+300)",
        f"MULTILINESTRING (({x} 0, 1 1), (2 2, 3 3))",
        f"MULTIPOINT (({x} 0), (1 1))",
        "POINT (-0.0 5e-324)",
    ):
        g, jg = geo.parse_wkt(wkt), jgeo.parse_wkt(wkt)
        assert g.wkt() == jg.wkt()
        assert geo.parse_wkt(g.wkt()).wkt() == g.wkt()
        assert g.bounds() == jg.bounds()


def test_equals_planted_literal(stores):
    j, p = stores["polygon"]
    q = f"EQUALS(geom, {LIT_POLY})"
    assert _fids(p, q) == _fids(j, q) == [f"f{N + 4}"]


# -- mixed and Multi* schemas -------------------------------------------------------------
MIXED = [
    "POINT (1 1)", "MULTIPOINT ((0 0), (2 2))", "LINESTRING (0 0, 3 3)",
    "MULTILINESTRING ((0 0, 1 0), (5 5, 6 6))", "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
    "MULTIPOLYGON (((-1 -1, 0 -1, 0 0, -1 -1)), ((7 7, 8 7, 8 8, 7 7)))",
    "POLYGON ((10 10, 11 10, 11 11, 10 10))",
]


@pytest.mark.parametrize("typ", ["Geometry", "MultiPoint", "MultiLineString", "MultiPolygon"])
def test_other_extent_types_served(typ):
    """Geometry and Multi* columns index under xz3 / xz2 and answer as the
    JAX package does."""
    rng = np.random.default_rng(5)
    if typ == "Geometry":
        wkts = MIXED * 20
    elif typ == "MultiPoint":
        wkts = [f"MULTIPOINT (({a} {b}), ({a + 1} {b - 1}))"
                for a, b in rng.uniform(-5, 5, (140, 2))]
    elif typ == "MultiLineString":
        wkts = [g.wkt() for g in rand_lines(rng, 1400)
                if isinstance(g, geo.MultiLineString)]
    else:
        wkts = [g.wkt() for g in rand_polys(rng, 1400) if isinstance(g, geo.MultiPolygon)]
    data = {"dtg": (T0 + rng.integers(0, MONTH_MS, len(wkts))).astype("datetime64[ms]"),
            "geom": wkts}
    j, p = build_pair(f"dtg:Date,*geom:{typ}", data)
    assert list(p._store("t").tables) == list(j._store("t").tables) == ["xz3", "xz2", "id"]
    for q in (f"INTERSECTS(geom, {LIT_POLY})", "BBOX(geom, 0, 0, 2, 2)",
              "CONTAINS(geom, POINT (1 1))", f"DWITHIN(geom, {LIT_LINE}, 100, kilometers)",
              f"WITHIN(geom, {LIT_HOLED}) AND {DURING}"):
        assert _fids(p, q) == _fids(j, q), q


def test_geometry_collection_maps_to_geometry():
    p = GeoDataset(device="cpu")
    ft = p.create_schema("t", "dtg:Date,*geom:GeometryCollection")
    assert ft.attr("geom").type == "geometry"


# -- point columns against extent literals ---------------------------------------------
@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(9)
    n = 3000
    x, y = rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)
    x[:20], y[:20] = np.linspace(-8, 0, 20), np.linspace(-8, 0, 20)  # on LIT_LINE
    data = {"geom__x": x, "geom__y": y,
            "dtg": (T0 + rng.integers(0, MONTH_MS, n)).astype("datetime64[ms]"),
            "weight": rng.uniform(0, 1, n)}
    spec = "weight:Double,dtg:Date,*geom:Point"
    fids = fids_for(n)
    config.COMPACT_MIN_ROWS.set(1)
    config.COMPACT_FRACTION.set(2.0)
    try:
        j = JGeoDataset(n_shards=4)
        j.create_schema("t", spec)
        j.insert("t", data, fids=fids)
        j.flush("t")
    finally:
        config.COMPACT_MIN_ROWS.set(None)
        config.COMPACT_FRACTION.set(None)
    p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    p.create_schema("t", spec)
    p.insert("t", data, fids=fids)
    p.flush("t")
    return j, p


@pytest.mark.parametrize("q", [
    f"DWITHIN(geom, {LIT_LINE}, 30, kilometers)",
    f"DWITHIN(geom, {LIT_POLY}, 10, kilometers)",
    f"DWITHIN(geom, {LIT_HOLED}, 1, meters) AND {DURING}",
    f"BEYOND(geom, {LIT_LINE}, 100, kilometers)",
    f"NOT DWITHIN(geom, {LIT_POLY}, 50, kilometers) AND BBOX(geom, -5, -5, 5, 5)",
    "DWITHIN(geom, MULTIPOINT ((0 0), (3 3)), 200, kilometers)",
], ids=["line", "polygon", "holed", "beyond", "not", "multipoint"])
def test_point_column_non_point_dwithin(points, q):
    j, p = points
    assert _fids(p, q) == _fids(j, q)
    assert p.count("t", q) == j.count("t", q)
    bbox = (-10.0, -10.0, 10.0, 10.0)
    assert np.array_equal(p.density("t", q, bbox=bbox, width=32, height=32),
                          j.density("t", q, bbox=bbox, width=32, height=32))


# -- store_from_arrays ---------------------------------------------------------------------
def test_store_from_arrays_extent(stores):
    """The extent master columns and the xz tables' sorted state carry
    across from the JAX store; the copy answers as the JAX package."""
    j, _ = stores["polygon"]
    jst = j._store("t")
    master = {k: v for k, v in jst._all.columns.items() if not k.startswith("__vis")}
    tables = {name: {"order": t.order, "keys": dict(t.key_columns),
                     "shard_bounds": t.shard_bounds, "key_shifts": t.key_shifts}
              for name, t in jst.tables.items()}
    st = store_from_arrays(POLY_SPEC, {"master": master, "tables": tables,
                                       "dicts": {"name": jst.dicts["name"].values}},
                           4, device="cpu", name="t")
    for name in jst.tables:
        _assert_tables_equal(jst, st, name)
    assert st._all.columns["geom__wkt"].tolist() == master["geom__wkt"].tolist()
    p2 = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    p2.attach_store(st)
    for q in (f"INTERSECTS(geom, {LIT_POLY}) AND {DURING}", f"TOUCHES(geom, {LIT_POLY})",
              "BBOX(geom, -2, -2, 3, 3)"):
        assert _fids(p2, q) == _fids(j, q), q
