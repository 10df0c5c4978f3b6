"""PyTorch port vs the JAX package: ``density_curve`` and its batches
(``density_curve_batch``, ``density_curve_filter_batch``) on flat and
time-partitioned point stores.

Both packages ingest the same rows made from a NumPy seed; a few rows sit
on the query box's f32 bounds, so some scans hold f32 band rows (and run
on the host, as the reference's curve does). The JAX side runs with one
device (``geomesa.mesh.devices`` 1: its 8 virtual CPU devices would take
the sharded partition scan) and its Pallas kernels in interpret mode.

Tolerances: unweighted grids exact, against the JAX package and against
an f64 oracle binning each row by its z2 normalization
(tests/test_density_curve.py:30). A weighted block is the difference of
two f32 prefix sums, and the packages add them in different orders (XLA's
scan on the CPU, PyTorch's sequential one), so weighted grids are held to
rtol 1e-4 (tests/test_density_curve.py:94) plus an atol of
:data:`ULPS` f32 ulps of the largest prefix the scan reaches (the total
weight of its matches). Batch members equal their serial calls bit for
bit.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch.curves.zorder import Z2SFC
from geomesa_tpu_torch.filter.ecql import parse_iso_ms

SPEC = "name:String,code:Long,weight:Float,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 4000
BOX = (-100.0, 30.0, -80.0, 45.0)
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-18T00:00:00Z"
B = f"BBOX(geom, {BOX[0]}, {BOX[1]}, {BOX[2]}, {BOX[3]}) AND {DURING}"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
#: ECQL -> what it exercises
QUERIES = {
    "include": "INCLUDE",
    "b": B,  # f32 band rows: the host path
    "clean": "BBOX(geom, -110.3, 27.1, -71.7, 46.9) AND weight < 0.7",
    "polygon": f"INTERSECTS(geom, {TRI}) AND {DURING}",
    "long": "code > 500000000000",  # host refinement beyond 2^24
    "empty": "dtg DURING 2021-01-01T00:00:00Z/2021-01-02T00:00:00Z",
}
#: f32 ulps of the largest prefix allowed in a weighted block
ULPS = 8


def make_data(n=N, seed=23):
    rng = np.random.default_rng(seed)
    # three weekly partitions: the JAX side compiles per partition
    lo, hi = parse_iso_ms("2020-01-04"), parse_iso_ms("2020-01-20")
    data = {
        "name": [f"a{i % 9}" for i in range(n)],
        "code": rng.integers(0, 1 << 40, n),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-125, -66, n),
        "geom__y": rng.uniform(24, 49, n),
    }
    # on the box's f32 bounds, inside B's interval
    data["geom__x"][:6] = BOX[0]
    data["geom__y"][6:10] = BOX[3]
    data["dtg"][:10] = np.datetime64("2020-01-08T12:00:00", "ms")
    return data


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores (ten times slower beside seven busy processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"flat": (JAX, port), "partitioned": (JAX, port)} and the data."""
    data = make_data()
    fids = np.arange(N).astype(str)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.MESH_DEVICES.set(1)
        try:
            out = {}
            for kind, spec in (("flat", SPEC), ("partitioned", PSPEC)):
                pair = []
                for ds in (JGeoDataset(n_shards=4), GeoDataset(n_shards=4, device="cpu")):
                    ds.create_schema("t", spec)
                    if kind == "partitioned":
                        st = ds._store("t")
                        st.max_resident = 2
                        st._spill_dir = str(tmp_path_factory.mktemp("spill"))
                    ds.insert("t", data, fids=fids)
                    ds.flush("t")
                    pair.append(ds)
                out[kind] = tuple(pair)
            yield out, data
        finally:
            jconfig.MESH_DEVICES.set(None)


def oracle(data, level, window, mask=None, weight=None):
    """f64 grid of the rows of ``mask`` binned by the top ``level`` bits
    of their z2 normalization."""
    sfc = Z2SFC()
    ix = (sfc.lon.normalize(data["geom__x"]) >> np.uint64(31 - level)).astype(np.int64)
    iy = (sfc.lat.normalize(data["geom__y"]) >> np.uint64(31 - level)).astype(np.int64)
    ix0, iy0, ix1, iy1 = window
    m = (ix >= ix0) & (ix <= ix1) & (iy >= iy0) & (iy <= iy1)
    if mask is not None:
        m &= mask
    w = data[weight].astype(np.float64) if weight else np.ones(len(ix))
    grid = np.zeros((iy1 - iy0 + 1, ix1 - ix0 + 1), np.float64)
    np.add.at(grid, (iy[m] - iy0, ix[m] - ix0), w[m])
    return grid


def row_mask(data, key):
    """The rows ``QUERIES[key]`` matches, by NumPy (f64 predicates)."""
    x, y = data["geom__x"], data["geom__y"]
    t = data["dtg"].astype(np.int64)
    during = (t >= parse_iso_ms("2020-01-05")) & (t <= parse_iso_ms("2020-01-18"))
    if key == "include":
        return np.ones(N, bool)
    if key == "b":
        return (x >= BOX[0]) & (x <= BOX[2]) & (y >= BOX[1]) & (y <= BOX[3]) & during
    if key == "clean":
        return ((x >= -110.3) & (x <= -71.7) & (y >= 27.1) & (y <= 46.9)
                & (data["weight"] < np.float32(0.7)))
    if key == "long":
        return data["code"] > 500000000000
    if key == "empty":
        return np.zeros(N, bool)
    raise KeyError(key)


def window_of(bbox, level):
    return GeoDataset._snap_blocks(bbox, level)[0]


def assert_weighted_close(got, want, total):
    """rtol 1e-4 plus ULPS f32 ulps of the largest prefix (``total``)."""
    atol = ULPS * float(np.spacing(np.float32(max(total, 1.0))))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("bbox", [
    (-180, -90, 180, 90), (-100, 30, -80, 45), (-100.0001, 29.99, -80.5, 45.7),
    (10, 10, 10, 10), (-200, -100, 200, 100), (179.99, 89.99, 180, 90),
])
@pytest.mark.parametrize("level", [1, 6, 12, 15])
def test_snap_blocks_equals_jax(bbox, level):
    assert GeoDataset._snap_blocks(bbox, level) == JGeoDataset._snap_blocks(bbox, level)


@pytest.mark.parametrize("level", [0, 16, -1])
def test_level_bounds_raise(stores, level):
    (pairs, _) = stores
    j, p = pairs["flat"]
    for ds in (j, p):
        with pytest.raises(ValueError, match="level"):
            ds.density_curve("t", "INCLUDE", level=level)
        with pytest.raises(ValueError, match="level"):
            ds.density_curve_batch("t", "INCLUDE", level=level, bboxes=[BOX])
        with pytest.raises(ValueError, match="level"):
            ds.density_curve_filter_batch("t", [B], level=level)


#: (level, bbox) of the unweighted cases; the partitioned store takes the
#: finest only for the banded and polygon filters
LEVELS = [(4, None), (9, BOX), (12, (-91.3, 36.2, -88.9, 38.05))]


@pytest.mark.parametrize("kind,key,level,bbox", [
    (kind, key, level, bbox) for kind in ("flat", "partitioned") for key in sorted(QUERIES)
    for level, bbox in LEVELS
    if kind == "flat" or (level == 9 or key in ("b", "polygon"))
])
def test_curve_unweighted_equals_jax(stores, kind, key, level, bbox):
    (pairs, data) = stores
    j, p = pairs[kind]
    q = QUERIES[key]
    got, snapped = p.density_curve("t", q, level=level, bbox=bbox)
    want, jsnapped = j.density_curve("t", q, level=level, bbox=bbox)
    assert snapped == jsnapped
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if key != "polygon":
        window = window_of(bbox or p.bounds("t"), level)
        np.testing.assert_array_equal(got, oracle(data, level, window, row_mask(data, key)))
    plan = p._plan("t", Query(q, index="z2"))
    assert plan.index_name == "z2"
    if kind == "flat" and key == "b":
        assert plan.exec_path["scan"].startswith("host") and plan.exec_path["band_rows"] > 0


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("key", ["include", "b", "clean"])
@pytest.mark.parametrize("level", [3, 9])
def test_curve_weighted_close_to_jax_and_f64(stores, kind, key, level):
    (pairs, data) = stores
    j, p = pairs[kind]
    q = QUERIES[key]
    got, _ = p.density_curve("t", q, level=level, bbox=BOX, weight="weight")
    want, _ = j.density_curve("t", q, level=level, bbox=BOX, weight="weight")
    m = row_mask(data, key)
    total = float(data["weight"][m].astype(np.float64).sum())
    assert_weighted_close(got, want, total)
    assert_weighted_close(got, oracle(data, level, window_of(BOX, level), m, "weight"), total)


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
def test_curve_region_equals_jax(stores, kind):
    (pairs, _) = stores
    j, p = pairs[kind]
    got, s = p.density_curve("t", DURING, level=10, bbox=BOX, region=TRI)
    want, js = j.density_curve("t", DURING, level=10, bbox=BOX, region=TRI)
    assert s == js
    np.testing.assert_array_equal(got, want)
    assert got.sum() == p.count("t", f"{DURING} AND INTERSECTS(geom, {TRI})") > 0
    assert np.array_equal(
        got, p.density_curve("t", f"{DURING} AND INTERSECTS(geom, {TRI})", level=10,
                             bbox=BOX)[0])


def test_curve_of_query_object_and_default_bbox(stores):
    (pairs, _) = stores
    j, p = pairs["flat"]
    got, s = p.density_curve("t", Query(B, index="z3"), level=7)
    want, js = j.density_curve("t", B, level=7)
    assert s == js
    np.testing.assert_array_equal(got, want)


def test_coarse_z2_shift_raises(stores):
    """Keys quantized coarser than the level's blocks cannot give exact
    block ranges: both packages refuse."""
    (pairs, _) = stores
    j, p = pairs["flat"]
    for ds in (j, p):
        table = ds._store("t").tables["z2"]
        saved = table.key_shifts
        table.key_shifts = {"__z2": 40}
        try:
            with pytest.raises(ValueError, match="quantized below level 15"):
                ds.density_curve("t", "INCLUDE", level=15, bbox=(-91, 36, -90.9, 36.1))
            # level 11's blocks (shift 40 bits) are still exact ranges
            assert ds.density_curve("t", "INCLUDE", level=11, bbox=BOX)[0].shape
        finally:
            table.key_shifts = saved


def _crops(rng, m, w=6.0, h=4.0):
    out = []
    for _ in range(m):
        x0 = float(rng.uniform(-124, -72))
        y0 = float(rng.uniform(25, 44))
        out.append((x0, y0, x0 + w, y0 + h))
    return out


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("m", [2, 5, 8])
def test_curve_batch_equals_serial_and_jax(stores, kind, m):
    (pairs, _) = stores
    j, p = pairs[kind]
    crops = _crops(np.random.default_rng(40 + m), m)
    if m == 5:
        crops[3] = None  # the data's bounds
    q = QUERIES["clean"]
    got = p.density_curve_batch("t", q, level=11, bboxes=crops)
    want = j.density_curve_batch("t", q, level=11, bboxes=crops)
    assert len(got) == m
    for bb, (g, s), (jg, js) in zip(crops, got, want):
        sg, ss = p.density_curve("t", q, level=11, bbox=bb)
        assert s == ss == js
        assert np.array_equal(g, sg)
        np.testing.assert_array_equal(g, jg)
    wgot = p.density_curve_batch("t", q, level=8, bboxes=crops, weight="weight")
    for bb, (g, _) in zip(crops, wgot):
        assert np.array_equal(g, p.density_curve("t", q, level=8, bbox=bb, weight="weight")[0])


def _filter_batch(rng, m):
    """m distinct bbox + 3-day DURING members and their crops."""
    crops = _crops(rng, m, 9.0, 7.0)
    qs = []
    for i, (x0, y0, x1, y1) in enumerate(crops):
        d0 = 4 + (2 * i) % 13
        qs.append(f"BBOX(geom, {x0}, {y0}, {x1}, {y1}) AND dtg DURING "
                  f"2020-01-{d0:02d}T00:00:00Z/2020-01-{d0 + 3:02d}T00:00:00Z")
    return qs, crops


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("m", [2, 5, 8])
def test_curve_filter_batch_equals_serial_and_jax(stores, kind, m):
    (pairs, data) = stores
    j, p = pairs[kind]
    qs, crops = _filter_batch(np.random.default_rng(70 + m), m)
    got = p.density_curve_filter_batch("t", qs, level=10, bboxes=crops)
    want = j.density_curve_filter_batch("t", qs, level=10, bboxes=crops)
    assert got is not None and want is not None and len(got) == m
    if kind == "flat":
        plan = p._plan("t", Query(qs[0], index="z2"))
        assert plan.exec_path["scan"] == "device-batch" and plan.exec_path["batch"] == m
    for q, bb, (g, s), (jg, js) in zip(qs, crops, got, want):
        sg, ss = p.density_curve("t", q, level=10, bbox=bb)
        assert s == ss == js
        assert np.array_equal(g, sg)
        np.testing.assert_array_equal(g, jg)
    wgot = p.density_curve_filter_batch("t", qs, level=7, bboxes=crops, weight="weight")
    wwant = j.density_curve_filter_batch("t", qs, level=7, bboxes=crops, weight="weight")
    for q, bb, (g, _), (jg, _) in zip(qs, crops, wgot, wwant):
        assert np.array_equal(g, p.density_curve("t", q, level=7, bbox=bb, weight="weight")[0])
        assert_weighted_close(g, jg, float(data["weight"].astype(np.float64).sum()))


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
def test_curve_filter_batch_none_cases(stores, kind):
    """None where the JAX package gives None: no shared template, and a
    member whose scan holds f32 band rows (flat; on a partitioned store
    that partition runs its members' serial curves, as the reference)."""
    (pairs, _) = stores
    j, p = pairs[kind]
    other = [B, "BBOX(geom, -100, 30, -80, 45) AND weight < 0.5"]
    assert p.density_curve_filter_batch("t", other, level=9) is None
    assert j.density_curve_filter_batch("t", other, level=9) is None
    banded = [B, "BBOX(geom, -120, 26, -101, 40) AND " + DURING]
    got = p.density_curve_filter_batch("t", banded, level=9, bboxes=[BOX, BOX])
    want = j.density_curve_filter_batch("t", banded, level=9, bboxes=[BOX, BOX])
    assert (got is None) == (want is None) == (kind == "flat")
    if got is not None:
        for q, (g, _), (jg, _) in zip(banded, got, want):
            np.testing.assert_array_equal(g, jg)
            assert np.array_equal(g, p.density_curve("t", q, level=9, bbox=BOX)[0])
    assert p.density_curve_filter_batch("t", [], level=9) == []
    with pytest.raises(ValueError, match="align"):
        p.density_curve_filter_batch("t", [B], level=9, bboxes=[BOX, BOX])
    with pytest.raises(ValueError, match="align"):
        p.density_curve_filter_batch("t", [B], level=9, members=[{}, {}])
