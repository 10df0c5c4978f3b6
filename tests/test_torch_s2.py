"""The S2 cell curve and the s2 / s3 key spaces of the port against the JAX
package's.

* ``curves/s2.py``: leaf ids of 100k seeded points, with the poles, the
  antimeridian and the cube's face edges, bit for bit; the cell hierarchy
  (levels, parents, children, ranges), tokens and the bbox covers.
* ``S2KeySpace`` / ``S3KeySpace``: key plans, sorted tables and per-shard
  windows; count, density, query and polygon count through s2 and s3 tables
  (flat and time-partitioned), each equal to the JAX package's; the
  decider's choice among z3 / z2 / s3 / s2.
* State carried across: roots the JAX package saved with an ``s2,id`` and an
  ``s3`` index list load in the port and answer alike.

Counts, unweighted grids and polygon counts are bit-identical; weighted
grids within the reference's rtol 1e-4. Most answers are held against the
JAX package's host runner (``prefer_device=False``, the same exact answers
with no XLA compile per query); the layout notes against its device path."""

import contextlib

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu.curves import s2 as js2
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch import config as pconfig
from geomesa_tpu_torch.curves import s2 as ps2
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms

N = 6_000
BASE = "weight:Float,dtg:Date,*geom:Point"
SPECS = {
    "s2": BASE + ";geomesa.indices='s2,id'",
    "s3": BASE + ";geomesa.indices='s3,id'",
    "all": BASE + ";geomesa.indices='z3,z2,s3,s2,id'",
}
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
POLY = ("POLYGON ((-100 30, -80 30, -80 45, -92 38, -100 45, -100 30), "
        "(-90 33, -86 33, -86 36, -90 36, -90 33))")
QUERIES = {
    "bbox_during": f"BBOX(geom, -100, 30, -80, 45) AND {DURING}",
    "bbox": "BBOX(geom, -100, 30, -80, 45)",
    "polygon_during": f"INTERSECTS(geom, {POLY}) AND {DURING}",
    "antimeridian": f"BBOX(geom, 170, -20, 180, 10) AND {DURING}",
    "polar": f"BBOX(geom, -180, 80, 180, 90) AND {DURING}",
    "weight": f"BBOX(geom, -120, 25, -60, 50) AND weight > 0.5 AND {DURING}",
    "ids": "IN ('3', '17', '4242')",
}
GRID = dict(bbox=(-100.0, 30.0, -80.0, 45.0), width=96, height=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def both(**knobs):
    with contextlib.ExitStack() as stack:
        for name, v in knobs.items():
            stack.enter_context(getattr(jconfig, name).scoped(v))
            stack.enter_context(getattr(pconfig, name).scoped(v))
        yield


def make_data(n=N, seed=29):
    """Half over CONUS, half over the globe (poles and the antimeridian
    included)."""
    rng = np.random.default_rng(seed)
    h = n // 2
    x = np.concatenate([rng.uniform(-120, -70, h), rng.uniform(-180, 180, n - h)])
    y = np.concatenate([rng.uniform(25, 50, h), rng.uniform(-90, 90, n - h)])
    x[:4], y[:4] = [180.0, -180.0, 0.0, 45.0], [90.0, -90.0, 89.999, 0.0]
    lo = parse_iso_ms("2020-01-01")
    return {
        "geom__x": x, "geom__y": y,
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }


def make(cls, kind, data, **kw):
    ds = cls(n_shards=3, **kw)
    ds.create_schema("t", SPECS[kind])
    ds.insert("t", data, fids=np.arange(len(data["dtg"])).astype(str))
    ds.flush("t")
    return ds


@pytest.fixture(scope="module")
def stores():
    """kind -> (JAX on its device path, the port, JAX on its host runner)."""
    data = make_data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        yield {k: (make(JGeoDataset, k, data), make(GeoDataset, k, data, device="cpu"),
                   make(JGeoDataset, k, data, prefer_device=False))
               for k in SPECS}


# -- the curve ----------------------------------------------------------------------------
def curve_points():
    rng = np.random.default_rng(101)
    x = rng.uniform(-180, 180, 100_000)
    y = np.degrees(np.arcsin(rng.uniform(-1, 1, 100_000)))
    # poles, the antimeridian, the cube's face edges and corners
    edge = np.degrees(np.arctan(1 / np.sqrt(2)))
    sx = [-180, 180, 0, 0, 45, -45, 135, -135, 90, -90, 45, 45, -135, 180, -180, 0]
    sy = [0, 0, 90, -90, 0, 0, 0, 0, 45, -45, edge, -edge, edge, 89.9999999, -89.9999999, 0]
    ulp = np.nextafter(np.asarray(sx, np.float64), np.inf)
    return (np.concatenate([x, sx, ulp, np.full(64, 180.0), np.linspace(-180, 180, 64)]),
            np.concatenate([y, sy, sy, np.linspace(-90, 90, 64), np.full(64, 90.0)]))


def test_lnglat_to_id_bit_equal():
    x, y = curve_points()
    got, want = ps2.lnglat_to_id(x, y), js2.lnglat_to_id(x, y)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)
    assert np.array_equal(ps2.S2SFC().index(x, y), want)
    with pytest.raises(ValueError):
        ps2.S2SFC().index([0.0], [91.0])
    for a, b in zip(ps2.id_to_face_ij(got[:5000]), js2.id_to_face_ij(want[:5000])):
        assert np.array_equal(a, b)
    for a, b in zip(ps2.id_to_lnglat(got[:5000]), js2.id_to_lnglat(want[:5000])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("level", [0, 9, 30])
def test_hierarchy_and_tokens_equal(level):
    x, y = curve_points()
    ids = js2.lnglat_to_id(x[:2000], y[:2000])
    par = ps2.parent(ids, level)
    assert np.array_equal(par, js2.parent(ids, level))
    assert np.array_equal(ps2.level_of(par), js2.level_of(par))
    assert np.array_equal(ps2.range_min(par), js2.range_min(par))
    assert np.array_equal(ps2.range_max(par), js2.range_max(par))
    assert np.array_equal(ps2.contains(par, ids), js2.contains(par, ids))
    for c in par[:16].tolist():
        assert ps2.children(c) == js2.children(c)
        tok = ps2.token(c)
        assert tok == js2.token(c) and ps2.from_token(tok) == js2.from_token(tok) == c
        assert np.array_equal(ps2.cell_corners(c), js2.cell_corners(c))


@pytest.mark.parametrize("box,cells", [
    ((-100, 30, -80, 45), 8), ((170, -20, 180, 10), 8), ((-180, 80, 180, 90), 8),
    ((-180, -90, 180, 90), 8), ((0.1, 0.1, 0.2, 0.2), 8), ((-45.5, -1, -44.5, 1), 8),
    ((-100, 30, -80, 45), 64), ((170, -20, 180, 10), 64), ((-45.5, -1, -44.5, 1), 64),
], ids=str)
def test_ranges_equal(box, cells):
    got = ps2.S2SFC(max_cells=cells).ranges(*box)
    want = js2.S2SFC(max_cells=cells).ranges(*box)
    assert [(r.lo, r.hi) for r in got] == [(r.lo, r.hi) for r in want]


# -- the key spaces -------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["s2", "s3"])
def test_tables_and_windows_equal(stores, kind):
    _, p, j = stores[kind]
    jst, pst = j._store("t"), p._store("t")
    assert list(pst.tables) == list(jst.tables) == [kind, "id"]
    jt, pt = jst.tables[kind], pst.tables[kind]
    assert np.array_equal(pt.order, jt.order)
    assert np.array_equal(pt.shard_bounds, jt.shard_bounds)
    assert (pt.key_shifts or {}) == (jt.key_shifts or {})
    for k in jt.key_columns:
        assert np.array_equal(pt.key_columns[k], jt.key_columns[k]), k
    for name in ("bbox_during", "polygon_during", "antimeridian", "ids"):
        q = QUERIES[name]
        jkp = jt.keyspace.plan(jst.ft, jparse(q))
        pkp = pt.keyspace.plan(pst.ft, parse_ecql(q))
        if jkp is None:
            assert pkp is None, q
            continue
        assert [(r.lo, r.hi) for r in pkp.ranges] == [(r.lo, r.hi) for r in jkp.ranges]
        assert pkp.coverage == jkp.coverage and pkp.disjoint == jkp.disjoint
        assert pkp.full_scan == jkp.full_scan
        assert (pkp.bins is None) == (jkp.bins is None)
        if jkp.bins is not None:
            assert np.array_equal(pkp.bins, jkp.bins)
        ws, we = pt.windows(pkp)
        jws, jwe = jt.windows(jkp)
        for s in range(pt.n_shards):
            a = [(int(u), int(v)) for u, v in zip(ws[s], we[s]) if v > u]
            b = [(int(u), int(v)) for u, v in zip(jws[s], jwe[s]) if v > u]
            assert a == b, (q, s)


def run_both(j, p, q, fn):
    jplan = j._plan("t", q)[2]
    want = fn(j)
    got = fn(p)
    return got, want, p._plan("t", q), jplan


@pytest.mark.parametrize("kind,name", [
    ("s2", "bbox"), ("s2", "polygon_during"), ("s2", "antimeridian"),
    ("s3", "bbox_during"), ("s3", "polar"), ("s3", "weight"),
    ("all", "bbox_during"), ("all", "ids"),
])
def test_count_and_index_equal(stores, kind, name):
    _, p, j = stores[kind]
    q = QUERIES[name]
    with both(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=1e9):
        got, want, pplan, jplan = run_both(j, p, q, lambda ds: ds.count("t", q))
    assert got == want
    assert pplan.index_name == jplan.index_name


@pytest.mark.parametrize("kind,name", [("s2", "bbox"), ("s3", "bbox_during")])
def test_device_layout_equal(stores, kind, name):
    """The compacted layout and its chunk size on the JAX device path."""
    j, p, _ = stores[kind]
    q = QUERIES[name]
    with both(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=1e9):
        got, want, pplan, jplan = run_both(j, p, q, lambda ds: ds.count("t", q))
    assert got == want
    assert pplan.exec_path["scan"] == jplan.exec_path["scan"] == "device-compact"
    assert pplan.exec_path["B"] == jplan.exec_path["B"]


@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
@pytest.mark.parametrize("kind", ["s2", "s3"])
def test_density_equal(stores, kind, weight):
    """s2 / s3 scans scatter, as the reference's: neither rung has a
    schedule for their keys."""
    j, p, _ = stores[kind]
    q = QUERIES["bbox_during" if kind == "s3" else "bbox"]
    with both(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=1e9):
        g, w, pplan, jplan = run_both(j, p, q, lambda ds: ds.density("t", q, weight=weight,
                                                                      **GRID))
    assert pplan.exec_path["scan"] == jplan.exec_path["scan"] == "device-compact"
    assert pplan.exec_path["density_kernel"] == jplan.exec_path["density_kernel"] == "scatter"
    if weight is None:
        assert np.array_equal(g, w) and g.sum() > 0
    else:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["s2", "s3"])
def test_query_and_polygon_equal(stores, kind):
    _, p, j = stores[kind]
    q = QUERIES["polygon_during"]
    fj = j.query("t", JQuery(ecql=q, sort_by=[("weight", False)]))
    fp = p.query("t", Query(ecql=q, sort_by=[("weight", False)]))
    assert list(fp.fids) == list(fj.fids) and len(fp.fids) > 0
    assert np.array_equal(np.asarray(fp.columns["weight"]), np.asarray(fj.columns["weight"]))
    assert p.count("t", q) == j.count("t", q) == len(fp.fids)


@pytest.mark.parametrize("name", ["bbox_during", "bbox"])
def test_explain_chooses_alike(stores, name):
    _, p, j = stores["all"]
    q = QUERIES[name]
    pt, jt = p.explain("t", q), j.explain("t", q)
    pick = [ln.strip() for ln in pt.splitlines() if "Chosen index" in ln]
    assert pick == [ln.strip() for ln in jt.splitlines() if "Chosen index" in ln]
    assert len(pick) == 1


# -- time-partitioned stores ----------------------------------------------------------------
def test_partitioned_s3_equal(tmp_path):
    """A time-partitioned schema on an s3 index: its children build the s3
    table, and every answer equals the JAX package's and the flat port's."""
    data = make_data(2_000, seed=3)
    spec = SPECS["s3"].replace(";", ";geomesa.partition='time',", 1)
    # one device on the JAX side: the serial partition stream, as on one card
    with both(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=1e9), jconfig.MESH_DEVICES.scoped(1), \
            jconfig.SPILL_DIR.scoped(str(tmp_path / "j")), \
            pconfig.SPILL_DIR.scoped(str(tmp_path / "p")):
        j = JGeoDataset(n_shards=2, prefer_device=False)
        p = GeoDataset(n_shards=2, device="cpu")
        for ds in (j, p):
            ds.create_schema("t", spec)
            ds._store("t").max_resident = 1
            ds.insert("t", data, fids=np.arange(2_000).astype(str))
            ds.flush("t")
        flat = make(GeoDataset, "s3", data, device="cpu")
        ps = p._store("t")
        assert len(ps.partition_bins()) > 1
        for q in (QUERIES["bbox_during"], QUERIES["polygon_during"]):
            got, want, pplan, jplan = run_both(j, p, q, lambda ds: ds.count("t", q))
            assert got == want == flat.count("t", q)
            assert pplan.index_name == jplan.index_name == "s3"
            g, w, _, _ = run_both(j, p, q, lambda ds: ds.density("t", q, **GRID))
            assert np.array_equal(g, w)
            assert np.array_equal(g, flat.density("t", q, **GRID))


# -- roots carried across ---------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["s2", "s3"])
def test_jax_root_loads_in_the_port(stores, kind, tmp_path):
    _, p, j = stores[kind]
    root = str(tmp_path / "root")
    j.save(root)
    loaded = GeoDataset.load(root, device="cpu")
    lst = loaded._store("t")
    assert list(lst.tables) == [kind, "id"]
    jt = j._store("t").tables[kind]
    assert np.array_equal(lst.tables[kind].key_columns[f"__{kind}"], jt.key_columns[f"__{kind}"])
    for name in ("bbox_during", "polygon_during", "ids"):
        q = QUERIES[name]
        assert loaded.count("t", q) == j.count("t", q), name
        assert loaded._plan("t", q).index_name == j._plan("t", q)[2].index_name
    q = QUERIES["bbox_during"]
    assert np.array_equal(loaded.density("t", q, **GRID), j.density("t", q, **GRID))
