"""PyTorch port vs the JAX package: expression predicates (property
against property, arithmetic, ``st_*`` function calls), from the parse
trees and the compiled masks node by node to end-to-end counts and
densities on the z3, z2, xz3 and attribute plans.

Both packages ingest the same rows made from a NumPy seed into 4 shards
with explicit feature ids; the JAX side runs its Pallas kernels in
interpret mode with compaction forced, the port runs on the CPU with its
kernels' plain versions. The rows carry what the f32 interval mask must
survive: exact duplicates across columns, values one f64 ulp apart (equal
at f32), zero denominators, NaN Doubles and null strings."""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.filter import compile_filter as jcompile
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.utils.geometry import haversine_m
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.index.store import device_view

SPEC = ("speed:Double,heading:Double,weight:Float,limit:Double,n:Integer:index=true,"
        "code:Long,flag:Boolean,a:String,b:String,dtg:Date,*geom:Point")
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom, -100, 30, -80, 45)"
N = 6000


def make_data(n=N, seed=31):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    speed = rng.uniform(0, 100, n)
    heading = np.where(rng.random(n) < 0.2, speed, rng.uniform(0, 100, n))
    heading[:50] = np.nextafter(speed[:50], np.inf)  # one ulp apart: equal at f32
    speed[50:80] = np.nan
    limit = rng.uniform(0, 20, n)
    limit[80:120] = 0.0  # zero denominators
    a = rng.choice(np.array(["x", "y", "z"], object), n)
    a[120:140] = None
    return {
        "speed": speed, "heading": heading, "limit": limit,
        "weight": rng.uniform(0, 10, n).astype(np.float32),
        "n": rng.integers(-50, 50, n).astype(np.int32),
        "code": rng.integers(0, 1 << 40, n),
        "flag": rng.random(n) < 0.5,
        "a": list(a), "b": list(rng.choice(np.array(["x", "y"], object), n)),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
    }


def _pair(spec, data, fids):
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


@pytest.fixture(scope="module")
def pair():
    data = make_data()
    j, p = _pair(SPEC, data, np.char.add("e", np.arange(N).astype(str)))
    return j, p, data


@pytest.fixture(scope="module")
def polys():
    rng = np.random.default_rng(8)
    n = 800
    cx, cy = rng.uniform(-10, 10, (2, n))
    w, h = rng.uniform(0.05, 1.5, (2, n))
    wkts = [f"POLYGON (({x} {y}, {x + a} {y}, {x + a} {y + b}, {x} {y + b}, {x} {y}))"
            for x, y, a, b in zip(cx, cy, w, h)]
    lo = parse_iso_ms("2020-01-01")
    data = {"height": rng.uniform(0, 40, n).astype(np.float32), "geom": wkts,
            "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]")}
    j, p = _pair("height:Float,dtg:Date,*geom:Polygon", data,
                 np.char.add("p", np.arange(n).astype(str)))
    return j, p, data, w * h


@pytest.fixture(autouse=True)
def _compaction():
    config.COMPACT_MIN_ROWS.set(1)
    config.COMPACT_FRACTION.set(2.0)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
            yield
    finally:
        config.COMPACT_MIN_ROWS.set(None)
        config.COMPACT_FRACTION.set(None)


# -- parse trees -----------------------------------------------------------------------
PARSE = [
    "speed > heading", "weight * 2 < limit", "(a + b) * 2 >= c - 1",
    "st_area(geom) > 0.5", "speed > 5", "5 < speed", "(speed > 5) AND (heading < speed)",
    "speed < - 2", "speed < 1 + 1", "1 + 1 = 2", "1 + 1 = 3", "speed -5 > heading",
    "speed / 0 > 1", "1 / 0 < speed", "-speed > heading * -1.5",
    "st_distanceSphere(geom, st_geomFromWKT('POINT (-95 38)')) / 1000 < 500",
    "st_x(geom) + st_y(geom) <> 0", "n * 2 = code - 3", "flag = true AND speed >= heading",
    "NOT (speed / limit <= 2.5) OR a = b", "speed BETWEEN 1 AND 2 AND heading * 2 > speed",
    "2 * (speed + heading) / 4 > limit", "st_area(st_geomFromWKT('POLYGON ((0 0, 1 0, 1 1, 0 0))')) > 0.4",
    f"{BOX} AND speed > heading AND {DURING}",
]


@pytest.mark.parametrize("q", PARSE)
def test_parse_trees_equal(q):
    assert repr(parse_ecql(q)) == repr(jparse(q))


def test_parse_shapes():
    f = parse_ecql("weight * 2 < limit")
    assert isinstance(f, ir.ExprCompare) and isinstance(f.left, ir.Arith)
    assert isinstance(parse_ecql("st_area(geom) > 0.5").left, ir.FnCall)
    assert isinstance(parse_ecql("speed < 1 + 1"), ir.Compare)
    assert isinstance(parse_ecql("1 + 1 = 2"), ir.Include)
    assert ir.expr_has_fn(parse_ecql("st_x(geom) * 2 > 1").left)
    assert parse_ecql("speed * heading > limit / n").props() == ["speed", "heading", "limit", "n"]


@pytest.mark.parametrize("q", ["speed + heading", "speed > ", "(speed + heading"])
def test_parse_errors_equal(q):
    with pytest.raises(ValueError):
        jparse(q)
    with pytest.raises(ValueError):
        parse_ecql(q)


def test_json_path_names_the_roadmap():
    """jsonPath() parses to the reference's IR (it was refused before the
    Json slice)."""
    q = "jsonPath('$.a', js) > 2"
    got = parse_ecql(q)
    assert isinstance(got, ir.Compare) and isinstance(got.prop, ir.JsonPath)
    assert repr(got) == repr(jparse(q))


# -- compiled masks, node by node --------------------------------------------------------
#: expressions with an f32 interval mask on the device
DEVICE = {
    "prop_prop": "speed > heading",
    "prop_prop_eq": "speed = heading",
    "prop_prop_ne": "speed <> heading",
    "mul": "weight * 2 < limit",
    "add": "speed + heading >= 100",
    "sub": "speed - heading <= 0.5",
    "div": "speed / limit > 2",
    "div_eq": "speed / limit = 5",
    "div_zero_lit": "speed / 0 > 1",
    "lit_div_zero": "1 / 0 < speed",
    "nested": "2 * (speed + heading) / 4 > limit - 1",
    "int_mix": "n * 3 >= weight",
    "long": "code / 1000000 < speed",
    "bool": "flag * 10 + 1 > weight",
    "unary": "-speed < heading - 100",
    "not": "NOT (speed > heading)",
    "not_eq": "NOT (speed = heading)",
    "not_ne": "NOT (speed <> heading)",
    "not_le": "NOT (speed / limit <= 2.5)",
    "not_not": "NOT (NOT (weight * 2 >= limit))",
    "or": "speed < heading OR weight > limit",
    "and_box": f"{BOX} AND speed * 1.5 > heading AND {DURING}",
}

#: expressions the device cannot evaluate (functions, strings)
HOST = {
    "str_eq": "a = b",
    "str_ne": "a <> b",
    "fn_distance": "st_distanceSphere(geom, st_geomFromWKT('POINT (-95 38)')) < 500000",
    "fn_div": "st_distanceSphere(geom, st_geomFromWKT('POINT (-95 38)')) / 1000 < 500",
    "fn_xy": "st_x(geom) + st_y(geom) < -50",
    "not_fn": "NOT (st_y(geom) > 40)",
    "const_true": "st_area(st_geomFromWKT('POLYGON ((0 0, 1 0, 1 1, 0 0))')) > 0.4",
    "const_false": "st_area(st_geomFromWKT('POLYGON ((0 0, 1 0, 1 1, 0 0))')) > 0.6",
}


def _compiled(j, p, q):
    jst, pst = j._store("t"), p._store("t")
    return (jcompile(jparse(q), jst.ft, jst.dicts),
            compile_filter(parse_ecql(q), pst.ft, pst.dicts))


def _np(a, n):
    return np.broadcast_to(np.asarray(a), (n,))


@pytest.mark.parametrize("name", sorted(DEVICE) + sorted(HOST))
def test_expression_masks_equal(pair, name):
    """The f32 device mask (torch over the device views against jnp), the
    host coarse mask and the exact mask equal the JAX package's; the
    coarse mask holds every exact match."""
    import jax.numpy as jnp

    j, p, _ = pair
    q = DEVICE.get(name) or HOST[name]
    jc, pc = _compiled(j, p, q)
    assert pc.columns == jc.columns
    assert pc.refine_columns == jc.refine_columns
    assert (pc.refine is None) == (jc.refine is None)
    assert (pc.band is None) == (jc.band is None)
    master = p._store("t")._all.columns
    host = {k: master[k] for k in pc.columns}
    dev = {k: device_view(v) for k, v in host.items()}
    n = N
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        got = _np(pc({k: torch.from_numpy(v) for k, v in dev.items()}, torch), n)
        want = _np(jc({k: jnp.asarray(v) for k, v in dev.items()}, jnp), n)
        assert np.array_equal(got, want)
        assert np.array_equal(_np(pc(host, np), n), _np(jc(host, np), n))
        exact = pc.exact_mask(host, n)
        assert np.array_equal(exact, jc.exact_mask(host, n))
    assert not (exact & ~got).any()


def test_interval_mask_is_tight_enough(pair):
    """The f32 coarse mask of a function-free comparison is no looser than
    its error bound needs: it drops most non-matches."""
    j, p, d = pair
    _, pc = _compiled(j, p, "speed > heading")
    dev = {k: torch.from_numpy(device_view(p._store("t")._all.columns[k]))
           for k in pc.columns}
    coarse = pc(dev, torch).numpy()
    exact = d["speed"] > d["heading"]
    assert coarse.sum() - exact.sum() < 0.25 * N


# -- end to end -------------------------------------------------------------------------
E2E = {
    "z3": (f"{BOX} AND {DURING} AND speed > heading", "z3"),
    "z3_fn": (f"{BOX} AND {DURING} AND st_x(geom) * 2 < -190", "z3"),
    "z2": (f"{BOX} AND weight * 2 < limit", "z2"),
    "z2_not": (f"{BOX} AND NOT (speed / limit <= 2.5)", "z2"),
    "attr": ("n = 7 AND speed - heading <= 0.5", "attr:n"),
    "attr_str": ("n BETWEEN -3 AND 3 AND a = b", "attr:n"),
    "full": ("speed = heading", None),
}


@pytest.mark.parametrize("name", sorted(E2E))
def test_end_to_end_equal(pair, name):
    """Counts, fids and unweighted / weighted densities equal the JAX
    package's on the index the decider picks; the plan refines on the
    host after the device's coarse mask."""
    j, p, _ = pair
    q, index = E2E[name]
    assert p.count("t", q) == j.count("t", q)
    pplan = p._plan("t", q)
    assert pplan.index_name == j._plan("t", q)[2].index_name
    if index is not None:
        assert pplan.index_name == index
    assert pplan.exec_path["scan"] == "host+device-coarse"
    assert sorted(p.query("t", q).fids) == sorted(j.query("t", q).fids)
    bbox = (-120.0, 25.0, -70.0, 50.0)
    assert np.array_equal(p.density("t", q, bbox=bbox, width=64, height=64),
                          j.density("t", q, bbox=bbox, width=64, height=64))
    np.testing.assert_allclose(
        p.density("t", q, bbox=bbox, width=64, height=64, weight="weight"),
        j.density("t", q, bbox=bbox, width=64, height=64, weight="weight"), rtol=1e-4)


def test_oracle_counts(pair):
    """Counts against f64 NumPy: NaN rows and zero denominators as IEEE."""
    _, p, d = pair
    s, h, lim = d["speed"], d["heading"], d["limit"]
    with np.errstate(divide="ignore", invalid="ignore"):
        assert p.count("t", "speed > heading") == int((s > h).sum())
        assert p.count("t", "speed = heading") == int((s == h).sum())
        assert p.count("t", "speed <> heading") == int(((s != h) & ~np.isnan(s)).sum())
        r = s / lim
        assert p.count("t", "speed / limit > 2") == int((r > 2).sum())
        assert p.count("t", "NOT (speed > heading)") == int((~(s > h)).sum())
    dist = haversine_m(d["geom__x"], d["geom__y"], -95.0, 38.0)
    assert p.count("t", HOST["fn_distance"]) == int((dist < 500000).sum())


def test_expression_errors(pair):
    _, p, _ = pair
    with pytest.raises(ValueError, match="st_nosuch"):
        p.count("t", "st_nosuch(geom) > 1")
    with pytest.raises(KeyError, match="nope"):
        p.count("t", "nope > speed")
    with pytest.raises(ValueError, match="ordering"):
        p.count("t", "a < b")


@pytest.mark.parametrize("q, index", [
    ("st_area(geom) > 0.5 AND BBOX(geom, -5, -5, 5, 5)", "xz2"),
    (f"height * 3 > 60 AND BBOX(geom, -5, -5, 5, 5) AND {DURING}", "xz3"),
    ("st_area(geom) < height / 40", "xz2"),
    ("NOT (st_area(geom) >= 0.25) AND INTERSECTS(geom, POLYGON ((-3 -3, 3 -3, 0 4, -3 -3)))",
     "xz2"),
], ids=["st_area", "height", "area_vs_prop", "not_area"])
def test_polygon_schema_expressions(polys, q, index):
    """Expressions on a polygon schema, on the xz plans: counts, fids and
    grids equal the JAX package's; ``st_area`` equals the f64 areas."""
    j, p, _, areas = polys
    assert p._plan("t", q).index_name == j._plan("t", q)[2].index_name == index
    assert p.count("t", q) == j.count("t", q)
    assert sorted(p.query("t", q).fids) == sorted(j.query("t", q).fids)
    bbox = (-12.0, -12.0, 12.0, 12.0)
    assert np.array_equal(p.density("t", q, bbox=bbox, width=32, height=32),
                          j.density("t", q, bbox=bbox, width=32, height=32))
    assert p.count("t", "st_area(geom) > 0.5") == int((areas > 0.5).sum())


# -- randomized trees ------------------------------------------------------------------
PROPS = ["speed", "heading", "limit"]


def _rand_expr(rng, depth):
    if depth == 0 or rng.random() < 0.35:
        if rng.random() < 0.55:
            return PROPS[rng.integers(0, len(PROPS))]
        return repr(round(float(rng.uniform(-50, 50)), 3))
    op = "+-*/"[rng.integers(0, 4)]
    return f"({_rand_expr(rng, depth - 1)} {op} {_rand_expr(rng, depth - 1)})"


def _rand_pred(rng, depth):
    if depth == 0 or rng.random() < 0.5:
        op = ["=", "<>", "<", "<=", ">", ">="][rng.integers(0, 6)]
        return f"{_rand_expr(rng, 2)} {op} {_rand_expr(rng, 2)}"
    kind = rng.integers(0, 3)
    left = _rand_pred(rng, depth - 1)
    if kind == 2:
        return f"NOT ({left})"
    return f"({left}) {'AND' if kind == 0 else 'OR'} ({_rand_pred(rng, depth - 1)})"


@pytest.mark.parametrize("seed", range(12))
def test_random_trees_equal(pair, seed):
    """Random arithmetic trees, alone and under a box: the port's counts
    equal the JAX package's."""
    j, p, _ = pair
    rng = np.random.default_rng(1000 + seed)
    for _ in range(4):
        text = _rand_pred(rng, 2)
        assert p.count("t", text) == j.count("t", text), text
        q = f"{BOX} AND ({text})"
        assert p.count("t", q) == j.count("t", q), q
