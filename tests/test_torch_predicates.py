"""PyTorch port vs the JAX package: attribute and spatial predicates, from
the compiled masks of each node type to end-to-end ``count`` and
``density`` on every index the decider picks.

Both packages ingest the same 40k rows made from a NumPy seed into 4
shards with explicit feature ids; the JAX side runs its Pallas kernels in
interpret mode with compaction forced, the port runs on the CPU with its
kernels' plain versions. Rows are planted on the literals' boundaries: on
the f32 images of the box bounds, on a line literal, on a point literal,
on a polygon's edges, on a Double literal."""

import math

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.filter import compile_filter as jcompile
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.utils.geometry import haversine_m
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.index.store import device_view

SPEC = ("name:String:index=true,uid:UUID,code:Long,score:Double,flag:Boolean,"
        "n:Integer,weight:Float,speed:Float,dtg:Date,when:Date,*geom:Point")
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom, -100, 30, -80, 45)"
BBOX = (-100.0, 30.0, -80.0, 45.0)
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
NAMES = np.array([f"c{i:03d}" for i in range(256)])


def make_data(n=40_000, seed=23):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    names = NAMES[rng.choice(256, n, p=zipf / zipf.sum())].astype(object)
    names[rng.random(n) < 0.01] = None
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "when": rng.integers(lo, parse_iso_ms("2021-01-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "speed": rng.uniform(0, 30, n).astype(np.float32),
        "name": list(names),
        "uid": [f"{rng.integers(1 << 62):016x}-{i % 97}" for i in range(n)],
        "code": np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 40, n),
                         rng.integers(0, 1 << 20, n)),
        "score": rng.normal(0, 100, n),
        "flag": rng.random(n) < 0.3,
        "n": rng.integers(-1000, 1000, n).astype(np.int32),
    }
    x, y = data["geom__x"], data["geom__y"]
    x[:40] = -100.0  # on the box's f32 bounds: the band
    y[40:80] = 45.0
    x[80:120], y[80:120] = rng.uniform(-110, -80, 40), 40.0  # on the line
    x[120:160], y[120:160] = -95.5, 33.25  # on the point literal
    x[160:200], y[160:200] = rng.uniform(-94, -86, 40), 32.0  # on TRI's base
    x[200:220], y[200:220] = -90.0, 40.0  # TRI's apex
    data["score"][220:300] = 12.5  # on the Double literal
    data["speed"][300:340] = np.nan  # null Floats
    return data


@pytest.fixture(scope="module")
def pair():
    data = make_data()
    fids = np.char.add("e", np.arange(len(data["dtg"])).astype(str))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        try:
            j = JGeoDataset(n_shards=4)
            j.create_schema("t", SPEC)
            j.insert("t", data, fids=fids)
            j.flush("t")
            p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            p.create_schema("t", SPEC)
            p.insert("t", data, fids=fids)
            p.flush("t")
            yield j, p, data
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)


# -- compiled masks, node by node ---------------------------------------------------
#: predicates the device decides exactly (bit-equal device masks)
DEVICE_EXACT = {
    "str_eq": "name = 'c007'",
    "str_ne": "name <> 'c000'",
    "str_absent": "name = 'absent'",
    "str_order": "name > 'c100' AND name <= 'c150'",
    "str_in": "name IN ('c001', 'c002', 'absent')",
    "str_in_many": "name IN (" + ", ".join(f"'c{i:03d}'" for i in range(0, 60, 3)) + ")",
    "like": "name LIKE 'c01%'",
    "ilike": "name ILIKE 'C2_5'",
    "uuid_like": "uid LIKE '%-42'",
    "is_null": "name IS NULL",
    "is_not_null": "name IS NOT NULL",
    "float_is_null": "speed IS NULL",
    "int_is_null": "n IS NULL",
    "float_between": "weight BETWEEN 0.25 AND 0.75",
    "float_cmp": "weight < 0.1 OR weight >= 0.95",
    "int_cmp": "n > -3 AND n <= 250",
    "int_fraction": "n < 2.5 AND n <> 1.5",
    "int_in": "n IN (-5, 0, 17, 2.5)",
    "long_small": "code < 100000",
    "long_small_in": "code IN (7, 99, 123456)",
    "bool_eq": "flag = true",
    "bool_ne": "flag <> true",
    "date_cmp": "when > '2020-06-01T00:00:00Z' AND when <= '2020-09-01T00:00:00Z'",
    "date_eq": "when = '2020-06-01T00:00:00Z'",
    "during": DURING,
    "bbox": BOX,
    "not_bbox": f"NOT {BOX}",
    "polygon": f"INTERSECTS(geom, {TRI})",
    "disjoint_polygon": f"DISJOINT(geom, {TRI})",
    "double_cmp": "score > 12.5",
    "double_eq": "score = 12.5",
    "double_in": "score IN (12.5, -3.25)",
    "not_double": "NOT score <= 12.5",
    "flipped": "0.5 < weight",
}

#: predicates with a coarse device mask and an exact host refinement
REFINED = {
    "long_big": "code > 500000000000",
    "long_big_eq": "code = 549755813888",
    "long_big_in": "code IN (549755813888, 17)",
    "not_long_big": "NOT code < 500000000000",
    "point_intersects": "INTERSECTS(geom, POINT(-95.5 33.25))",
    "point_equals": "EQUALS(geom, POINT(-95.5 33.25))",
    "point_disjoint": "DISJOINT(geom, POINT(-95.5 33.25))",
    "multipoint": "INTERSECTS(geom, MULTIPOINT((-95.5 33.25), (-90 40)))",
    "line_intersects": "INTERSECTS(geom, LINESTRING(-110 40, -80 40))",
    "line_touches": "TOUCHES(geom, LINESTRING(-110 40, -95 40))",
    "line_within": "WITHIN(geom, LINESTRING(-110 40, -95 40))",
    "within_polygon": f"WITHIN(geom, {TRI})",
    "touches_polygon": f"TOUCHES(geom, {TRI})",
    "not_touches_polygon": f"NOT TOUCHES(geom, {TRI}) AND {BOX}",
}


def _cols(p, names):
    master = p._store("t")._all.columns
    host = {k: master[k] for k in names}
    dev = {k: device_view(v) for k, v in host.items()}
    return host, dev


def _compiled(j, p, q):
    jst, pst = j._store("t"), p._store("t")
    jc = jcompile(jparse(q), jst.ft, jst.dicts)
    pc = compile_filter(parse_ecql(q), pst.ft, pst.dicts)
    return jc, pc


def _np(a, n):
    return np.broadcast_to(np.asarray(a), (n,))


@pytest.mark.parametrize("name", sorted(DEVICE_EXACT))
def test_device_mask_equal(pair, name, monkeypatch):
    """The port's torch mask over the device views equals the JAX
    package's jnp mask bit for bit; the host masks, bands and refiners over
    the master columns equal too."""
    import jax.numpy as jnp

    monkeypatch.setenv("GEOMESA_PALLAS_INTERPRET", "1")
    j, p, _ = pair
    jc, pc = _compiled(j, p, DEVICE_EXACT[name])
    assert pc.columns == jc.columns
    assert (pc.band is None) == (jc.band is None)
    assert (pc.refine is None) == (jc.refine is None)
    host, dev = _cols(p, pc.columns)
    n = len(next(iter(host.values())))
    got = pc({k: torch.from_numpy(v) for k, v in dev.items()}, torch)
    want = jc({k: jnp.asarray(v) for k, v in dev.items()}, jnp)
    assert np.array_equal(_np(got, n), _np(want, n))
    assert np.array_equal(_np(pc(host, np), n), _np(jc(host, np), n))
    if pc.band is not None:
        assert np.array_equal(_np(pc.band(host, np), n), _np(jc.band(host, np), n))
        assert np.array_equal(_np(pc.refine(host, np), n), _np(jc.refine(host, np), n))


@pytest.mark.parametrize("name", sorted(REFINED))
def test_refined_mask_equal(pair, name):
    """Refine-bearing predicates: the coarse host mask, the exact mask
    and the refiner equal the JAX package's; the port's device mask is a
    superset of the exact matches."""
    j, p, _ = pair
    jc, pc = _compiled(j, p, REFINED[name])
    assert pc.columns == jc.columns and pc.refine_columns == jc.refine_columns
    assert pc.refine is not None and jc.refine is not None and pc.band is None
    host, dev = _cols(p, pc.columns)
    n = len(next(iter(host.values())))
    exact = pc.exact_mask(host, n)
    assert np.array_equal(exact, jc.exact_mask(host, n))
    assert np.array_equal(_np(pc(host, np), n), _np(jc(host, np), n))
    coarse = _np(pc({k: torch.from_numpy(v) for k, v in dev.items()}, torch), n)
    assert not (exact & ~coarse).any()


def test_planted_rows_are_decided(pair):
    """The planted boundary rows reach the cases they were planted for."""
    j, p, data = pair
    host, _ = _cols(p, ["geom__x", "geom__y", "score"])
    n = len(host["geom__x"])
    for q, lo in ((REFINED["point_equals"], 40), (REFINED["line_intersects"], 40),
                  (REFINED["touches_polygon"], 40), (DEVICE_EXACT["double_eq"], 80)):
        _, pc = _compiled(j, p, q)
        assert pc.exact_mask(host, n).sum() >= lo, q


# -- end to end --------------------------------------------------------------------------
#: point-schema queries of every index and scan path: (ECQL, chosen index, scan path)
MOTIVATION = {
    "bbox": (BOX, "z2", "device-compact"),
    "include": ("INCLUDE", "z2", "device-compact"),
    "rare_name": (f"name = 'c007' AND {BOX}", "attr:name", "device-compact"),
    "frequent_name": (f"name = 'c000' AND {BOX}", "z2", "device-compact"),
    "fids": ("IN ('e17', 'e4242')", "id", "host"),
    "long_code": (f"code > 500000000000 AND {BOX} AND {DURING}", "z3",
                  "host+device-coarse"),
    "names_weights": (f"name IN ('c003', 'c010', 'c042') AND weight BETWEEN 0.25 "
                      f"AND 0.75 AND {BOX} AND {DURING}", "z3", "device-compact"),
    "like_dwithin": ("name LIKE 'c01%' AND DWITHIN(geom, POINT(-90 40), 500, kilometers)",
                     "z2", "device-compact"),
}


def _run_both(j, p, q, fn):
    _, _, jplan = j._plan("t", q)
    want = fn(j)
    got = fn(p)
    return got, want, p._plan("t", q), jplan


@pytest.mark.parametrize("name", sorted(MOTIVATION))
def test_motivation_count_equal(pair, name):
    j, p, _ = pair
    q, index, scan = MOTIVATION[name]
    got, want, pplan, jplan = _run_both(j, p, q, lambda ds: ds.count("t", q))
    assert pplan.index_name == jplan.index_name == index
    assert pplan.exec_path["scan"] == jplan.exec_path["scan"] == scan
    assert got == want


@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
@pytest.mark.parametrize("name", sorted(MOTIVATION))
def test_motivation_density_equal(pair, name, weight):
    """Unweighted grids exactly, weighted within rtol 1e-4, on every path:
    the grouped kernel under z2 and z3 plans, the scatter under the
    attribute plan, the host grid under id and refine-bearing plans."""
    j, p, _ = pair
    q = MOTIVATION[name][0]
    fn = lambda ds: ds.density("t", q, bbox=BBOX, width=128, height=96,  # noqa: E731
                               weight=weight)
    got, want, pplan, jplan = _run_both(j, p, q, fn)
    assert got.dtype == np.float32 and got.shape == (96, 128)
    kernel = {"pallas-grouped-mxu": "grouped"}.get(jplan.exec_path.get("density_kernel"),
                                                   jplan.exec_path.get("density_kernel"))
    assert pplan.exec_path.get("density_kernel") == kernel
    if weight is None:
        assert np.array_equal(got, want)
    else:
        assert np.allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", ["bbox", "include", "rare_name", "names_weights"])
def test_padded_layout_equal(pair, name):
    """Below the compaction threshold every device plan scans the padded
    [S, L] layout through the window mask (a full scan's windows end at
    the shards' ends): same answers."""
    j, p, _ = pair
    q = MOTIVATION[name][0]
    padded = GeoDataset(n_shards=4, device="cpu")
    padded.attach_store(p._store("t"))
    assert padded.count("t", q) == j.count("t", q)
    assert padded._plan("t", q).exec_path["scan"] == "device-padded"
    assert np.array_equal(padded.density("t", q, bbox=BBOX, width=64, height=64),
                          j.density("t", q, bbox=BBOX, width=64, height=64))


@pytest.mark.parametrize("q", [
    DEVICE_EXACT["is_null"], DEVICE_EXACT["float_is_null"], DEVICE_EXACT["double_eq"],
    DEVICE_EXACT["bool_eq"], DEVICE_EXACT["date_cmp"], DEVICE_EXACT["uuid_like"],
    REFINED["line_intersects"], REFINED["touches_polygon"], REFINED["point_equals"],
    f"{REFINED['within_polygon']} AND {DURING}", f"IN ('e1', 'e120', 'nope') AND {BOX}",
    "IN ('e17', 'e17', 'e3')",
    f"BEYOND(geom, POINT(-90 40), 800, kilometers) AND {DURING}",
    f"{DEVICE_EXACT['double_in']} AND {BOX}",
], ids=lambda q: q[:40])
def test_count_equal(pair, q):
    j, p, _ = pair
    got, want, pplan, jplan = _run_both(j, p, q, lambda ds: ds.count("t", q))
    assert pplan.index_name == jplan.index_name
    assert pplan.exec_path["scan"] == jplan.exec_path["scan"]
    assert got == want


@pytest.mark.parametrize("grid", [(512, 512), (300, 200)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_z2_pair_schedule_equal(pair, grid):
    """Under a z2 plan the compaction descriptor and the grouped kernel's
    (chunk, tile) schedule equal the JAX package's."""
    from geomesa_tpu.kernels import density_pallas as jdp
    from geomesa_tpu_torch.kernels import density_grouped as kg

    j, p, _ = pair
    st, _, jplan = j._plan("t", BOX)
    jex = j._executor(st)
    jsetup = jex._scan_setup(jplan, [])
    jex._maybe_compact(jplan, jsetup, True)
    pplan = p._plan("t", BOX)
    pex = p._executor("t")
    psetup = pex._scan_setup(pplan, [])
    pex._maybe_compact(pplan, psetup)
    assert jplan.index_name == pplan.index_name == "z2"
    dj, dp = jsetup["compact"], psetup["compact"]
    assert (dj["B"], dj["C"]) == (dp["B"], dp["C"])
    for k in ("cstart", "lo", "valid"):
        assert np.array_equal(dj[k], dp[k]), k
    W, H = grid
    tj, tp = jsetup["table"], psetup["table"]
    gj = jdp.build_grouped(dj, tj, tj.keyspace, BBOX, W, H)
    gp = kg.build_grouped(dp, tp, tp.keyspace, BBOX, W, H)
    assert gj is not None and gp is not None and set(gj) == set(gp)
    for k, v in gj.items():
        assert np.array_equal(np.asarray(v), np.asarray(gp[k])), k


def test_band_rows_are_corrected(pair):
    """The Double literal's rows collide with its f32 image: the device
    excises them and the host adds back the exact matches."""
    j, p, data = pair
    q = f"{DEVICE_EXACT['double_eq']} AND {BOX}"
    got = p.count("t", q)
    path = p._plan("t", q).exec_path
    assert path["scan"].startswith("device") and path["band_rows"] > 0
    x, y = data["geom__x"], data["geom__y"]
    want = ((data["score"] == 12.5) & (x >= -100) & (x <= -80) & (y >= 30) & (y <= 45)).sum()
    assert got == want == j.count("t", q)


# -- DWITHIN: f32 transcendentals ------------------------------------------------------------
def _ring(n, cx, cy, r_m, spread_m, seed):
    """Points at great-circle distances r_m +- spread_m from (cx, cy)."""
    rng = np.random.default_rng(seed)
    brg = rng.uniform(0, 2 * math.pi, n)
    d = (r_m + rng.uniform(-spread_m, spread_m, n)) / 6_371_008.8
    la1, lo1 = math.radians(cy), math.radians(cx)
    la2 = np.arcsin(math.sin(la1) * np.cos(d) + math.cos(la1) * np.sin(d) * np.cos(brg))
    lo2 = lo1 + np.arctan2(np.sin(brg) * np.sin(d) * math.cos(la1),
                           np.cos(d) - math.sin(la1) * np.sin(la2))
    return np.degrees(lo2), np.degrees(la2)


@pytest.mark.parametrize("radius_km", [0.5, 50, 500])
def test_dwithin_disagrees_only_near_the_radius(radius_km):
    """The great-circle test runs in f32 on the device in both packages;
    their transcendentals may differ in the last ulp. Over points planted
    within 200 m of the radius, the two masks may disagree only on rows
    whose f64 distance lies within 10 m of it."""
    import jax.numpy as jnp

    ft_spec = "*geom:Point"
    x, y = _ring(20_000, -90.0, 40.0, radius_km * 1000, 200.0, int(radius_km * 10))
    q = f"DWITHIN(geom, POINT(-90 40), {radius_km}, kilometers)"
    from geomesa_tpu.schema.feature_type import FeatureType as JFeatureType
    from geomesa_tpu_torch.schema.feature_type import FeatureType

    jc = jcompile(jparse(q), JFeatureType.from_spec("t", ft_spec), {})
    pc = compile_filter(parse_ecql(q), FeatureType.from_spec("t", ft_spec))
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    got = pc({"geom__x": torch.from_numpy(x32), "geom__y": torch.from_numpy(y32)}, torch)
    want = np.asarray(jc({"geom__x": jnp.asarray(x32), "geom__y": jnp.asarray(y32)}, jnp))
    d64 = haversine_m(x32.astype(np.float64), y32.astype(np.float64), -90.0, 40.0)
    differ = got.numpy() != want
    print(f"DWITHIN {radius_km} km: {int(differ.sum())} of {len(x)} rows differ")
    assert (np.abs(d64[differ] - radius_km * 1000) < 10.0).all()
    # the exact host tree agrees with f64 haversine away from rounding
    host = np.asarray(pc({"geom__x": x, "geom__y": y}, np))
    far = np.abs(haversine_m(x, y, -90.0, 40.0) - radius_km * 1000) > 1e-3
    assert np.array_equal(host[far], (haversine_m(x, y, -90.0, 40.0) <= radius_km * 1000)[far])


def test_dwithin_count_near_the_radius(pair):
    j, p, data = pair
    q = MOTIVATION["like_dwithin"][0]
    got, want = p.count("t", q), j.count("t", q)
    names = np.array([v if v is not None else "" for v in data["name"]])
    d = haversine_m(data["geom__x"], data["geom__y"], -90.0, 40.0)
    near = (np.char.startswith(names, "c01") & (np.abs(d - 500_000) < 10.0)).sum()
    assert abs(got - want) <= near
