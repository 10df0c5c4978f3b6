"""PyTorch port vs the JAX package: the stat DSL, the sketches, the scan's
device stats (``kernels/stats_scan.py``) through ``GeoDataset.stats`` on
every index and scan path, and kNN (``kernels/knn.py`` and the
expanding-radius search).

Both packages ingest the same rows made from a NumPy seed (4 shards,
explicit feature ids); the JAX side runs its Pallas kernels in interpret
mode with compaction forced, the port runs on the CPU with its kernels'
plain versions.

Tolerances: counts, min / max, histogram counts, enumerations and top-k
counts exact; the descriptive sums ``s1`` / ``s2`` (f32 sums whose bits
depend on the reduction layout) at rtol 1e-5 against an f64 oracle over
the same rows, and at rtol 1e-5 against the JAX package wherever its own
sums lie within 1e-5 of that oracle (on the CPU, XLA's f32 ``mw.T @ mat``
strays up to about 5e-5 on the squares of an Integer column). kNN: the distance set equal
to the f64 brute force's at rtol 1e-9, except that a row whose f64
distance lies within 1e-6 (relative, about f32 rounding: 1 m at 1000 km)
of the k-th distance may stand in for another such row (a boundary pair);
the port's fids equal the JAX package's under the same rule."""

import json

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.kernels import knn as jknn
from geomesa_tpu.kernels import stats_scan as jstats_scan
from geomesa_tpu.stats import parse_stat as jparse_stat
from geomesa_tpu.utils.geometry import haversine_m as jhaversine
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import knn as pknn
from geomesa_tpu_torch.kernels import stats_scan as pstats_scan
from geomesa_tpu_torch.stats import parse_stat
from geomesa_tpu_torch.utils.geometry import haversine_m

SPEC = ("name:String:index=true,kind:String,code:Long,n:Integer,weight:Float,"
        "speed:Float,dtg:Date,*geom:Point")
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom, -100, 30, -80, 45)"
BOX2 = "BBOX(geom, -101.3, 31.7, -81.1, 44.3)"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
NAMES = np.array([f"c{i:03d}" for i in range(256)])
N = 20_000


def make_data(n=N, seed=41):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    names = NAMES[rng.choice(256, n, p=zipf / zipf.sum())].astype(object)
    names[rng.random(n) < 0.01] = None
    kinds = np.array(["a", "b", "c", "d"])[rng.integers(0, 4, n)].astype(object)
    kinds[rng.random(n) < 0.05] = None
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "speed": rng.uniform(0, 30, n).astype(np.float32),
        "name": list(names),
        "kind": list(kinds),
        "code": rng.integers(0, 1 << 40, n),
        "n": rng.integers(-50, 150, n).astype(np.int32),
    }
    data["geom__x"][:30] = -100.0  # on the box's f32 bounds: the band
    data["speed"][500:520] = np.nan  # null Floats
    return data


@pytest.fixture(scope="module")
def pair():
    data = make_data()
    fids = np.char.add("e", np.arange(N).astype(str))
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


# -- the stat DSL -------------------------------------------------------------------------
#: every spec tests/test_stats.py parses, and one of each stat
SPECS = [
    "Count();MinMax(v);Histogram(v,20,-10,30);TopK(cat,5);"
    "GroupBy(cat,DescriptiveStats(v));Z3Histogram(geom,dtg,week,512)",
    "Count()", "MinMax(v)", "Enumeration(name)", "TopK(name)", "TopK(name,3)",
    "Histogram(v,50,-10.0,30.0)", "Frequency(cat)", "Frequency(cat,256)",
    "DescriptiveStats(v,w)", "GroupBy(cat,MinMax(v))", "GroupBy(a,GroupBy(b,Count()))",
    "Z3Histogram(geom,dtg)", "Z3Frequency(geom,dtg,day,8)", "MinMax('v') ; Count()",
    "Enumeration(\"name\")",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_stat_equal(spec):
    got, want = parse_stat(spec), jparse_stat(spec)
    assert type(got).__name__ == type(want).__name__
    assert json.loads(got.to_json()) == json.loads(want.to_json())


@pytest.mark.parametrize("spec", ["Bogus(x)", "MinMax(", "", "Count() x", "MinMax(v,)"])
def test_parse_stat_errors(spec):
    with pytest.raises(ValueError):
        jparse_stat(spec)
    with pytest.raises(ValueError):
        parse_stat(spec)


# -- the sketches ---------------------------------------------------------------------------
def sketch_columns(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "v": rng.normal(10, 5, n),
        "w": rng.uniform(0, 1, n).astype(np.float32),
        "cat": rng.integers(0, 7, n),
        "geom__x": rng.uniform(-75, -73, n),
        "geom__y": rng.uniform(40, 42, n),
        "dtg": rng.integers(1_600_000_000_000, 1_601_000_000_000, n).astype(np.int64),
    }


SKETCHES = [
    "Count()", "MinMax(v)", "MinMax(geom)", "Enumeration(cat)", "TopK(cat,3)",
    "Histogram(v,50,-10,30)", "Frequency(cat,256)", "Frequency(v,64)",
    "DescriptiveStats(v,w)", "GroupBy(cat,MinMax(v))", "GroupBy(cat,DescriptiveStats(v))",
    "Z3Histogram(geom,dtg,week,512)", "Z3Frequency(geom,dtg,week,6)",
    "Count();MinMax(v);TopK(cat,2)",
]


@pytest.mark.parametrize("spec", SKETCHES)
def test_sketch_observe_merge_value_equal(spec):
    """observe (with and without a mask), merge of two halves, value and
    the JSON round trip equal the JAX package's sketches."""
    cols = sketch_columns()
    mask = np.random.default_rng(9).random(4000) < 0.7
    halves = [{k: v[:1500] for k, v in cols.items()}, {k: v[1500:] for k, v in cols.items()}]
    out = []
    for parse in (parse_stat, jparse_stat):
        whole, masked, a, b = (parse(spec) for _ in range(4))
        whole.observe(cols)
        masked.observe(cols, mask)
        a.observe(halves[0])
        b.observe(halves[1])
        a.merge(b)
        back = type(whole).from_json(whole.to_json())
        out.append((whole, masked, a, back))
    for got, want in zip(*out):
        assert _norm(got.value()) == _norm(want.value())
        assert json.loads(got.to_json()) == json.loads(want.to_json())


def _norm(v):
    """Values with numpy scalars and tuples as plain JSON types."""
    return json.loads(json.dumps(v, default=lambda o: o.item() if hasattr(o, "item")
                                 else str(o)))


# -- device stats in the scan ------------------------------------------------------------------
#: the device-reduced stats: every kind, geometry bounds, an f32 / int32 /
#: date min-max, histograms of f32 and int32 columns
DEVICE_SPEC = ("Count();MinMax(weight);MinMax(geom);MinMax(n);MinMax(dtg);MinMax(speed);"
               "Histogram(weight,10,0,1);Histogram(n,16,-50,150);Enumeration(name);"
               "TopK(name,5);Enumeration(kind);TopK(kind,2);DescriptiveStats(weight,n)")
#: the gather path: sketches with no device reduction
HOST_SPECS = {
    "frequency": "Frequency(name,256)",
    "groupby": "GroupBy(kind,MinMax(weight))",
    "z3frequency": "Z3Frequency(geom,dtg,week,8)",
    "int_enumeration": "Count();Enumeration(n)",
}
#: (ECQL, the scan path of the stats scan)
QUERIES = {
    "z3": (f"{BOX2} AND {DURING}", "device-compact"),
    "z3_band": (f"{BOX} AND {DURING}", "host+device-coarse"),
    "z2": (BOX2, "device-compact"),
    "attr": (f"name = 'c007' AND {BOX2}", "device-compact"),
    "id": ("IN ('e17', 'e4242', 'e19999', 'nope')", "host"),
    "include": ("INCLUDE", "device-compact"),
    "polygon": (f"INTERSECTS(geom, {TRI})", "device-compact"),
    "long_refine": (f"code > 500000000000 AND {BOX2}", "host+device-coarse"),
}


def descriptive_oracle(cols, attrs):
    """f64 (s1, s2) of the columns ``attrs`` of the matching rows."""
    mat = np.stack([np.asarray(cols[a], np.float64) for a in attrs], axis=1)
    return mat.sum(axis=0), mat.T @ mat


def assert_same_stat(got, want, oracle=None):
    """Exact, except descriptive s1 / s2: rtol 1e-5 against ``oracle``
    (the f64 sums), and against the JAX package's where those lie within
    1e-5 of the oracle."""
    gl = got.stats if hasattr(got, "stats") else [got]
    wl = want.stats if hasattr(want, "stats") else [want]
    assert [s.kind for s in gl] == [s.kind for s in wl]
    for g, w in zip(gl, wl):
        if g.kind != "descriptive":
            assert _norm(g.value()) == _norm(w.value()), g.kind
            continue
        assert g.count == w.count
        for gs, ws, os_ in zip((g.s1, g.s2), (w.s1, w.s2), oracle or (None, None)):
            if os_ is None:
                np.testing.assert_allclose(gs, ws, rtol=1e-5)
                continue
            np.testing.assert_allclose(gs, os_, rtol=1e-5)
            ok = np.isclose(ws, os_, rtol=1e-5)
            np.testing.assert_allclose(gs[ok], ws[ok], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_device_stats_equal(pair, name):
    j, p, _ = pair
    q, scan = QUERIES[name]
    oracle = _oracle(p, q)
    _, _, jplan = j._plan("t", q)
    want = j.stats("t", DEVICE_SPEC, q)
    got = p.stats("t", DEVICE_SPEC, q)
    assert_same_stat(got, want, oracle)
    path = p._plan("t", q).exec_path
    assert path["scan"] == jplan.exec_path["scan"] == scan
    assert got.stats[0].count > 0


@pytest.mark.parametrize("name", ["z3", "z2", "attr", "polygon"])
def test_device_stats_padded_equal(pair, name):
    """The padded layout reduces to the same stats."""
    j, p, _ = pair
    padded = GeoDataset(n_shards=4, device="cpu")
    padded.attach_store(p._store("t"))
    q = QUERIES[name][0]
    assert_same_stat(padded.stats("t", DEVICE_SPEC, q), j.stats("t", DEVICE_SPEC, q),
                     _oracle(p, q))
    assert padded._plan("t", q).exec_path["scan"] == "device-padded"


def _oracle(p, q):
    """The f64 descriptive sums of DEVICE_SPEC's DescriptiveStats over the
    query's matches (their rows from the port's query, which
    tests/test_torch_query.py holds to the JAX package's)."""
    return descriptive_oracle(p.query("t", q).columns, ["weight", "n"])


@pytest.mark.parametrize("kind", sorted(HOST_SPECS))
@pytest.mark.parametrize("name", ["z3", "z3_band", "id"])
def test_gathered_stats_equal(pair, name, kind):
    j, p, _ = pair
    q = QUERIES[name][0]
    assert_same_stat(p.stats("t", HOST_SPECS[kind], q), j.stats("t", HOST_SPECS[kind], q))


def test_stats_helpers_equal(pair):
    j, p, _ = pair
    q = QUERIES["z2"][0]
    assert p.unique("t", "kind", q) == j.unique("t", "kind", q)
    assert p.top_k("t", "name", 4, q) == j.top_k("t", "name", 4, q)
    assert p.min_max("t", "weight", q) == j.min_max("t", "weight", q)
    assert p.min_max("t", "name", exact=False) == j.min_max("t", "name", exact=False)
    assert p.histogram("t", "weight", 8, query=q).value() == \
        j.histogram("t", "weight", 8, query=q).value()
    assert p.histogram("t", "n", 5, (0, 100), q).value() == \
        j.histogram("t", "n", 5, (0, 100), q).value()
    assert p.frequency("t", "kind", 64, q).value() == j.frequency("t", "kind", 64, q).value()


def test_device_update_equal():
    """``device_update`` in torch against ``stats_scan.device_update`` in
    jitted jnp (as the reference's scan runs it) on the same device
    columns and mask (NaN, nulls, values outside the histogram's range,
    spans whose reciprocal is inexact), then ``absorb_partials`` into the
    sketches."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 6000
    cols = {
        "w": rng.uniform(-0.2, 1.2, n).astype(np.float32),
        "u": rng.uniform(-3, 3, n).astype(np.float32),
        "i": rng.integers(-5, 40, n).astype(np.int32),
        "c": rng.integers(-1, 9, n).astype(np.int32),
        "g__x": rng.uniform(-80, -70, n).astype(np.float32),
        "g__y": rng.uniform(30, 40, n).astype(np.float32),
    }
    cols["w"][:7] = np.nan
    mask = rng.random(n) < 0.6
    spec = ("Count();MinMax(w);MinMax(i);MinMax(g);Histogram(w,12,0,1);Histogram(i,7,0,30);"
            "Histogram(u,10,-2.5,2.2);Histogram(i,6,-3,37);Enumeration(c);TopK(c,3);"
            "DescriptiveStats(u,i)")
    vocab = {"c": 9}
    jstat = jparse_stat(spec)
    want_p = jax.jit(lambda cols, m: jstats_scan.device_update(jstat, cols, m, jnp, vocab))(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(mask))
    got_p = pstats_scan.device_update(parse_stat(spec), {k: torch.from_numpy(v)
                                                        for k, v in cols.items()},
                                      torch.from_numpy(mask), vocab)
    oracle = descriptive_oracle({k: v[mask] for k, v in cols.items()}, ["u", "i"])
    for gp, wp in zip(got_p, want_p):
        assert sorted(gp) == sorted(wp)
        for k in wp:
            g, w = gp[k].numpy(), np.asarray(wp[k])
            if k in ("s1", "s2"):
                np.testing.assert_allclose(g, w, rtol=1e-5)
                np.testing.assert_allclose(g, oracle[k == "s2"], rtol=1e-5)
            else:
                np.testing.assert_array_equal(g, w, k)
    got, want = parse_stat(spec), jparse_stat(spec)
    pstats_scan.absorb_partials(got, got_p, {})
    jstats_scan.absorb_partials(want, want_p, {})
    assert_same_stat(got, want, oracle)


def test_stats_bad_spec_raises(pair):
    _, p, _ = pair
    with pytest.raises(ValueError):
        p.stats("t", "Bogus(weight)", BOX2)


# -- kNN --------------------------------------------------------------------------------------
KN = 8_000


@pytest.fixture(scope="module")
def kpair():
    """Global points (the kNN fuzz test's extent), a Double and a name;
    planted: 12 rows on one spot 0.3 degrees from a query point (ties
    around the k-th distance) and rows hard against the antimeridian."""
    rng = np.random.default_rng(404)
    data = {
        "v": rng.uniform(0, 10, KN),
        "name": list(np.array(["a", "b", "c"])[rng.integers(0, 3, KN)]),
        "geom__x": rng.uniform(-179.5, 179.5, KN),
        "geom__y": rng.uniform(-60, 60, KN),
    }
    data["geom__x"][:12], data["geom__y"][:12] = 10.3, 20.0
    data["geom__x"][12:30] = rng.uniform(179.8, 180.0, 18)
    data["geom__y"][12:30] = rng.uniform(-1, 1, 18)
    fids = np.arange(KN).astype(str)
    spec = "v:Double,name:String:index=true,*geom:Point"
    j = JGeoDataset(n_shards=2)
    j.create_schema("t", spec)
    j.insert("t", data, fids=fids)
    j.flush()
    p = GeoDataset(n_shards=2, device="cpu")
    p.create_schema("t", spec)
    p.insert("t", data, fids=fids)
    p.flush()
    return j, p, data


def check_knn(fids, data, qx, qy, k, match):
    """The distance set of ``fids`` against the f64 brute force over the
    rows ``match`` keeps (rtol 1e-9, boundary pairs allowed within 1e-6 of
    the k-th distance); returns the number of boundary pairs."""
    dist = haversine_m(data["geom__x"], data["geom__y"], qx, qy)
    cand = np.flatnonzero(match)
    want = np.sort(dist[cand])[:k]
    got = np.sort(dist[np.array([int(f) for f in fids], dtype=np.int64)])
    assert len(got) == len(want) == min(k, len(cand))
    if np.allclose(got, want, rtol=1e-9):
        return 0
    off = ~np.isclose(got, want, rtol=1e-9)
    kth = want[-1]
    assert np.allclose(got[off], kth, rtol=1e-6) and np.allclose(want[off], kth, rtol=1e-6)
    return int(off.sum())


KNN_CASES = {
    "plain": (-90.0, 40.0, 10, "INCLUDE"),
    "k1": (3.0, -12.0, 1, "INCLUDE"),
    "k50": (120.0, 30.0, 50, "INCLUDE"),
    "filter": (-20.0, 10.0, 20, "v > 5.5"),
    "attr": (45.0, 5.0, 15, "name = 'b'"),
    "more_than_matches": (0.0, 0.0, 25, "v > 9.997"),
    "antimeridian_east": (179.9, 0.2, 12, "INCLUDE"),
    "antimeridian_west": (-179.95, -0.5, 30, "INCLUDE"),
    "tie_at_k": (10.0, 20.0, 6, "INCLUDE"),
    "tie_big_k": (10.0, 20.0, 40, "INCLUDE"),
    "pole": (0.0, 59.9, 5, "INCLUDE"),
}


@pytest.mark.parametrize("name", sorted(KNN_CASES))
def test_knn_equal(kpair, name):
    """kNN of the port against the f64 brute force and the JAX package:
    the filter, k above the matches, both sides of the antimeridian, and
    the planted tie straddling the k-th distance (the port picks the same
    tied rows as the reference: the lowest table positions)."""
    j, p, data = kpair
    qx, qy, k, q = KNN_CASES[name]
    got, want = p.knn("t", qx, qy, k, q), j.knn("t", qx, qy, k, q)
    match = np.ones(KN, bool)
    if q.startswith("v >"):
        match = data["v"] > float(q.split(">")[1])
    elif q.startswith("name"):
        match = np.asarray(data["name"]) == "b"
    check_knn(got.fids, data, qx, qy, k, match)
    check_knn(want.fids, data, qx, qy, k, match)
    if name.startswith("tie"):
        assert got.fids == want.fids
        dist = haversine_m(data["geom__x"], data["geom__y"], qx, qy)
        kth = np.sort(dist)[k - 1]
        if name == "tie_at_k":  # the 12 tied rows straddle the k-th
            assert (dist == kth).sum() == 12 and (dist < kth).sum() < k
        else:
            assert {str(i) for i in range(12)} <= set(got.fids)
    else:
        same = set(got.fids) == set(want.fids)
        assert same or check_knn(got.fids, data, qx, qy, k, match) > 0
    assert list(got.to_dict()) == list(want.to_dict())
    assert np.array_equal(got.columns["v"], want.columns["v"]) or set(got.fids) != set(want.fids)


def test_knn_empty_and_zero_k(kpair):
    _, p, _ = kpair
    assert len(p.knn("t", 0.0, 0.0, 0)) == 0
    assert len(p.knn("t", 0.0, 0.0, 5, "v > 11")) == 0


def test_knn_indices_equal():
    """``knn_indices`` against the JAX package's (jitted, as its scan runs
    it) on one padded layout:
    the same rows, ties included (the lowest flat index wins), for k on
    both sides of 32; distances at f32 within 1e-5 relative."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    x = rng.uniform(-10, 10, (4, 512)).astype(np.float32)
    y = rng.uniform(-10, 10, (4, 512)).astype(np.float32)
    x[1, 5:60], y[1, 5:60] = 1.0, 1.0
    x[3, :40], y[3, :40] = 1.0, 1.0
    m = rng.random((4, 512)) < 0.8
    for k in (1, 7, 32, 33, 80):
        gi, gd = pknn.knn_indices(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(m), np.float32(0.5), np.float32(0.5), k)
        wi, wd = jax.jit(lambda x, y, m, qx, qy: jknn.knn_indices(x, y, m, qx, qy, k, jnp))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), np.float32(0.5), np.float32(0.5))
        assert np.array_equal(gi.numpy(), np.asarray(wi)), k
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5)


def test_lowest_k_picks_lowest_index_ties():
    d = torch.tensor([3.0, 1.0, 2.0, 1.0, 2.0, 2.0, float("inf"), 0.5])
    assert pknn.lowest_k(d, 4).tolist() == [7, 1, 3, 2]
    assert pknn.lowest_k(d, 8).tolist() == [7, 1, 3, 2, 4, 5, 0, 6]
    assert pknn.lowest_k(d, 20).tolist() == [7, 1, 3, 2, 4, 5, 0, 6]


def test_haversine_equal():
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-180, 180, 500), rng.uniform(-90, 90, 500)
    assert np.array_equal(haversine_m(x, y, 10.5, -3.0), jhaversine(x, y, 10.5, -3.0))
