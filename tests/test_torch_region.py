"""PyTorch port vs the JAX package: ``region=`` on ``count``, ``density``
and ``stats``, on flat and time-partitioned point stores and on a polygon
store.

A region folds into the query as one ``INTERSECTS`` conjunct, which the
port answers through its point-in-polygon kernel (``csrc/pip.cu``; its
plain version here) and the density kernel's plain version. Both packages
ingest the same rows made from a NumPy seed, with rows planted on the
regions' vertices and edges; the JAX side runs its Pallas kernels in
interpret mode with compaction forced and one device. Counts, unweighted
grids and stats are exact; weighted grids within rtol 1e-4
(tests/test_density_pallas.py:103)."""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.utils import geometry as jgeo
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.utils import geometry as geo

SPEC = "name:String,weight:Float,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 8_000
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-25T00:00:00Z"
BBOX = (-100.0, 30.0, -80.0, 45.0)
REGIONS = {
    "holed": ("POLYGON ((-98 31, -84 32, -82 43, -97 44, -98 31), "
              "(-93 36, -88 36, -88 40, -93 40, -93 36))"),
    "multi": ("MULTIPOLYGON (((-99 31, -92 31, -92 38, -99 38, -99 31), "
              "(-97 33, -94 33, -94 36, -97 36, -97 33)), "
              "((-90 35, -83 35, -86 44, -90 35)))"),
    "rectangle": "POLYGON ((-95 33, -85 33, -85 41, -95 41, -95 33))",
}
QUERIES = {"include": "INCLUDE", "during": DURING, "name": f"name = 'a3' AND {DURING}"}
STATS = "Count();MinMax(weight);Histogram(weight,16,0,1);Enumeration(name)"


def make_data(n=N, seed=21):
    rng = np.random.default_rng(seed)
    data = {
        "name": [f"a{i % 7}" for i in range(n)],
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"),
                            n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-102, -78, n),
        "geom__y": rng.uniform(28, 47, n),
    }
    # vertices, edge points and the hole's corners of the regions
    pts = [(-98, 31), (-84, 32), (-93, 36), (-88, 40), (-91, 33.5), (-99, 31), (-92, 38),
           (-97, 33), (-94, 36), (-90, 35), (-86, 44), (-95, 33), (-85, 41), (-90, 33)]
    for i, (x, y) in enumerate(pts):
        data["geom__x"][i], data["geom__y"][i] = x, y
        data["dtg"][i] = np.datetime64("2020-01-10T00:00:00", "ms")
    return data


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"flat": (JAX, port), "partitioned": (JAX, port)}."""
    data = make_data()
    fids = np.arange(N).astype(str)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.MESH_DEVICES.set(1)
        try:
            out = {}
            for kind, spec in (("flat", SPEC), ("partitioned", PSPEC)):
                pair = []
                for ds in (JGeoDataset(n_shards=4),
                           GeoDataset(n_shards=4, device="cpu", compact_min_rows=1)):
                    ds.create_schema("t", spec)
                    if kind == "partitioned":
                        st = ds._store("t")
                        st.max_resident = 3
                        st._spill_dir = str(tmp_path_factory.mktemp("spill"))
                    ds.insert("t", data, fids=fids)
                    ds.flush("t")
                    pair.append(ds)
                out[kind] = tuple(pair)
            yield out
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.MESH_DEVICES.set(None)


def _by_hand(query, wkt):
    conj = f"INTERSECTS(geom, {wkt})"
    return conj if query == "INCLUDE" else f"({query}) AND {conj}"


#: the JAX partitioned store answers in seconds a call here, so the
#: partitioned cases take the interval and the two non-rectangular regions
FLAT_OR_PART = [("flat", r) for r in sorted(REGIONS)] + [
    ("partitioned", "holed"), ("partitioned", "multi")]


@pytest.mark.parametrize("kind,region,query", [
    (k, r, q) for k, r in [("flat", r) for r in sorted(REGIONS)] for q in sorted(QUERIES)
] + [("partitioned", r, "during") for r in sorted(REGIONS)])
def test_region_count_equals_jax(stores, kind, region, query):
    j, p = stores[kind]
    q, wkt = QUERIES[query], REGIONS[region]
    got = p.count("t", q, region=wkt)
    assert got == j.count("t", q, region=wkt) > 0
    assert got == p.count("t", _by_hand(q, wkt))
    if kind == "flat":
        assert p.count("t", q, region=geo.parse_wkt(wkt)) == got
        assert j.count("t", q, region=jgeo.parse_wkt(wkt)) == got
        assert p.count("t", Query(ecql=q), region=wkt) == got


@pytest.mark.parametrize("kind,region", FLAT_OR_PART)
@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
def test_region_density_equals_jax(stores, kind, region, weight):
    j, p = stores[kind]
    wkt = REGIONS[region]
    got = p.density("t", DURING, bbox=BBOX, width=64, height=48, weight=weight, region=wkt)
    want = j.density("t", DURING, bbox=BBOX, width=64, height=48, weight=weight, region=wkt)
    assert got.shape == want.shape == (48, 64)
    if weight is None:
        assert np.array_equal(got, want) and got.sum() > 0
        assert int(got.sum()) == p.count("t", DURING, region=wkt)
    else:
        assert np.allclose(got, want, rtol=1e-4, atol=1e-4)
    hand = p.density("t", _by_hand(DURING, wkt), bbox=BBOX, width=64, height=48, weight=weight)
    assert np.array_equal(got, hand)


@pytest.mark.parametrize("kind,region", FLAT_OR_PART)
def test_region_stats_equal_jax(stores, kind, region):
    j, p = stores[kind]
    wkt = REGIONS[region]
    got = p.stats("t", STATS, DURING, region=wkt)
    want = j.stats("t", STATS, DURING, region=wkt)
    hand = p.stats("t", STATS, _by_hand(DURING, wkt))
    for a, b, c in zip(got.stats, want.stats, hand.stats):
        assert a.value() == b.value() == c.value() if not hasattr(a, "counts") else (
            np.array_equal(a.counts, b.counts) and np.array_equal(a.counts, c.counts))
    assert got.stats[0].value() == p.count("t", DURING, region=wkt) > 0


def test_region_validation_equals_jax(stores):
    j, p = stores["flat"]
    for ds in (j, p):
        with pytest.raises(Exception):
            ds.count("t", region="POLYGON ((0 0, 1 0")
    assert p._with_region("t", "INCLUDE", None) == "INCLUDE"
    assert p._with_region("t", DURING, REGIONS["rectangle"]) == \
        j._with_region("t", DURING, REGIONS["rectangle"])
    q = p._with_region("t", Query(ecql="INCLUDE"), REGIONS["rectangle"])
    assert isinstance(q, Query) and q.ecql == f"INTERSECTS(geom, {REGIONS['rectangle']})"


def test_region_on_a_polygon_schema_equals_jax():
    polys = [
        "POLYGON ((-96 34, -95 34, -95 35, -96 35, -96 34))",
        "POLYGON ((-90 37, -89 37, -89.5 38, -90 37))",
        "POLYGON ((-70 10, -69 10, -69 11, -70 10))",
        "MULTIPOLYGON (((-84 40, -83 40, -83 41, -84 40)), ((-60 0, -59 0, -59 1, -60 0)))",
    ]
    data = {"dtg": np.full(len(polys), np.datetime64("2020-01-10", "ms")),
            "geom": np.array(polys, object)}
    fids = [f"g{i}" for i in range(len(polys))]
    out = []
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("g", "dtg:Date,*geom:Polygon")
        ds.insert("g", data, fids=fids)
        ds.flush("g")
        out.append(ds)
    j, p = out
    for wkt in REGIONS.values():
        assert p.count("g", DURING, region=wkt) == j.count("g", DURING, region=wkt)
        assert p.stats("g", "Count()", region=wkt).value() == \
            j.stats("g", "Count()", region=wkt).value()
