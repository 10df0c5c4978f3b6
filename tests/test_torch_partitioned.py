"""PyTorch port vs the JAX package: time-partitioned, out-of-core stores.

Both packages create ``...;geomesa.partition='time'`` and ingest the same
rows made from a NumPy seed (two months of ``dtg``, so about nine weekly
partitions) with ``max_resident`` 1, so every query over several
partitions streams them and reloads spilled ones. Both spill in the
default lake layout (``geomesa.lake.enabled``), so a reloaded partition
holds its rows in the same primary order on both sides; one test spills
the port's npz layout instead. The JAX side runs its Pallas kernels in
interpret mode with compaction forced (``geomesa.compact.min.rows`` 1,
``geomesa.compact.fraction`` 2.0); the port runs on the CPU with its
kernels' plain versions and the same thresholds. Rows are planted on the
query box's f32 bounds in some partitions only, so their scans take
another path than the others'.

Tolerances: none, except weighted density (rtol 1e-4, the kernel's float
atomics) and the stats' descriptive sums (rtol 1e-5 of f64, as
``tests/test_torch_stats.py``). Store state, plans, counts, unweighted
grids, rows and their order, sorted results, stats and kNN sets are equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu.planning.executor import Executor as JExecutor
from geomesa_tpu.parallel import devices as jdevices
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.api.dataset import Query
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch import config as pconfig
from geomesa_tpu_torch.index.partitioned import (
    PartitionedFeatureStore, is_partitioned_schema,
)
from geomesa_tpu_torch.lake.snapshot import SNAPSHOT_FILE, PartitionSnapshot
from geomesa_tpu_torch.parallel.devices import TreeReducer, tree_merge
from geomesa_tpu_torch.planning.executor import Executor
from geomesa_tpu_torch.schema.feature_type import FeatureType

SPEC = "name:String:index=true,code:Long,weight:Float,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 6000
BOX = "BBOX(geom, -100, 30, -80, 45)"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-25T00:00:00Z"
B = f"{BOX} AND {DURING}"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
BBOX = (-100.0, 30.0, -80.0, 45.0)

#: ECQL -> what it exercises
QUERIES = {
    "include": "INCLUDE",
    "b": B,
    "box": BOX,
    "name": "name = 'a7'",
    "name_time": f"name = 'a3' AND {DURING}",
    "weight": "weight < 0.25",
    "polygon_time": f"INTERSECTS(geom, {TRI}) AND {DURING}",
    "long_time": f"code > 500000000000 AND {DURING}",
    "fids": "IN ('17', '4242', '5999', 'nope')",
    "after": "dtg > 2020-02-10T00:00:00Z",
    "empty": "dtg DURING 2021-01-01T00:00:00Z/2021-01-02T00:00:00Z",
}


def make_data(n=N, seed=11):
    rng = np.random.default_rng(seed)
    lo, hi = parse_iso_ms("2020-01-01"), parse_iso_ms("2020-03-01")
    data = {
        "name": [f"a{i % 20}" for i in range(n)],
        "code": rng.integers(0, 1 << 40, n),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
    }
    # on the box's f32 bound, inside the box and in the first weeks of B:
    # those partitions' non-additive scans take the host path
    data["geom__x"][:12] = -100.0
    data["geom__y"][:12] = 40.0
    data["dtg"][:12] = np.datetime64("2020-01-06T12:00:00", "ms")
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
def trio(tmp_path_factory):
    """(JAX partitioned, port partitioned, port flat, data)."""
    data = make_data()
    fids = np.arange(N).astype(str)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        # one device: the serial partition stream, as on the one card
        config.MESH_DEVICES.set(1)
        try:
            j = JGeoDataset(n_shards=2)
            j.create_schema("t", PSPEC)
            js = j._store("t")
            js.max_resident = 1
            js._spill_dir = str(tmp_path_factory.mktemp("jspill"))
            j.insert("t", data, fids=fids)
            j.flush("t")
            p = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            p.create_schema("t", PSPEC)
            ps = p._store("t")
            ps.max_resident = 1
            ps._spill_dir = str(tmp_path_factory.mktemp("pspill"))
            p.insert("t", data, fids=fids)
            p.flush("t")
            f = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            f.create_schema("t", SPEC)
            f.insert("t", data, fids=fids)
            f.flush("t")
            yield j, p, f, data
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)
            config.MESH_DEVICES.set(None)


def _jq(q):
    return JQuery(**{k: v for k, v in vars(q).items()}) if isinstance(q, Query) else q


def _fid_list(fc):
    return list(fc.fids)


def assert_same_features(got, want):
    """Same rows in the same order, the same decoded attributes."""
    assert _fid_list(got) == _fid_list(want)
    gd, wd = got.to_dict(), want.to_dict()
    assert list(gd) == list(wd)
    for k, v in wd.items():
        assert list(gd[k]) == list(v), k


# -- the schema and the store ---------------------------------------------------------
@pytest.mark.parametrize("spec, want", [
    (PSPEC, True), (SPEC + ";geomesa.partition='true'", True),
    (SPEC + ";geomesa.partition='false'", False), (SPEC, False),
])
def test_is_partitioned_schema(spec, want):
    assert is_partitioned_schema(FeatureType.from_spec("t", spec)) is want


def test_partitioning_needs_a_date():
    with pytest.raises(ValueError, match="date attribute"):
        GeoDataset(device="cpu").create_schema("u", "*geom:Point;geomesa.partition='time'")


def test_store_state_after_ingest(trio):
    j, p, _, _ = trio
    js, ps = j._store("t"), p._store("t")
    assert isinstance(ps, PartitionedFeatureStore)
    assert ps.partition_bins() == js.partition_bins()
    assert len(ps.partition_bins()) >= 8
    assert ps.part_counts == js.part_counts
    assert list(ps.partitions) == list(js.partitions)
    assert sorted(ps.spilled) == sorted(js.spilled)
    assert ps.count == js.count == N
    assert ps.partition_period == js.partition_period == "week"


def test_merged_stats_equal(trio):
    j, p, _, _ = trio
    jstats, pstats = j._store("t").stats, p._store("t").stats
    # the port keeps the sketches the decider and bounds() read (a subset)
    assert set(pstats) <= set(jstats) and "z3-histogram" in pstats
    for k in pstats:
        assert json.loads(pstats[k].to_json()) == json.loads(jstats[k].to_json()), k


def test_children_order_keys_and_shifts_equal(trio):
    """Per partition and index: the rows in table order (by fid), the
    permutation itself (both packages' lake snapshots store master rows in
    the primary order, so a reloaded child's permutation is the same), the
    key columns, key shifts, shard bounds and padded shard length."""
    j, p, _, _ = trio
    js, ps = j._store("t"), p._store("t")
    for b in ps.partition_bins():
        jc, pc = js.child(b), ps.child(b)
        assert pc.count == jc.count
        for name, jt in jc.tables.items():
            pt = pc.tables[name]
            assert pt.shard_len == jt.shard_len == 65536
            np.testing.assert_array_equal(pt.shard_bounds, jt.shard_bounds)
            np.testing.assert_array_equal(pt.col_sorted("__fid__"), jt.col_sorted("__fid__"))
            np.testing.assert_array_equal(pt.order, jt.order)
            assert pt.key_shifts == jt.key_shifts
            assert sorted(pt.key_columns) == sorted(jt.key_columns)
            for k, v in jt.key_columns.items():
                np.testing.assert_array_equal(pt.key_columns[k], v, err_msg=f"{b} {name} {k}")
    assert len(ps.partitions) == ps.max_resident == 1
    assert list(ps.partitions) == list(js.partitions)


def test_spill_and_reload_counters(trio):
    _, p, _, _ = trio
    ps = p._store("t")
    spilled_before = ps.spill_all()
    assert len(ps.partitions) == 0 and len(ps.spilled) == len(ps.partition_bins())
    loads = ps.loads
    assert p.count("t", "INCLUDE") == N
    assert ps.loads == loads + len(ps.partition_bins())
    assert len(ps.partitions) == 1
    # a clean reload spills without rewriting its snapshot
    spills = ps.spills
    ps.spill_all()
    assert ps.spills == spills and spilled_before


# -- plans -----------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(QUERIES))
def test_plans_equal(trio, key):
    j, p, _, _ = trio
    q = QUERIES[key]
    _, _, jplan = j._plan("t", q)
    pplan = p._plan("t", q)
    assert pplan.index_name == jplan.index_name
    assert pplan.est_count == pytest.approx(jplan.est_count, rel=0, abs=0)
    jpex = j._executor(j._store("t"))
    assert p._executor("t").prune(pplan) == jpex.prune(jplan)
    assert p.count("t", q, exact=False) == j.count("t", q, exact=False)


# -- additive answers ------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(QUERIES))
def test_count_equal(trio, key):
    j, p, f, _ = trio
    q = QUERIES[key]
    want = j.count("t", q)
    assert p.count("t", q) == want == f.count("t", q)
    path = p._plan("t", q).exec_path
    assert path["partitions_scanned"] + path["partitions_pruned"] == len(
        p._store("t").partition_bins())


@pytest.mark.parametrize("key", ["b", "box", "name_time", "include", "empty"])
@pytest.mark.parametrize("weight", [None, "weight"])
def test_density_equal(trio, key, weight):
    j, p, f, _ = trio
    q = QUERIES[key]
    kw = dict(bbox=BBOX, width=64, height=48, weight=weight)
    want = j.density("t", q, **kw)
    got = p.density("t", q, **kw)
    flat = f.density("t", q, **kw)
    assert got.shape == (48, 64) and got.dtype == np.float32
    if weight is None:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, flat)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, flat, rtol=1e-4, atol=1e-5)


def test_per_partition_paths_equal(trio):
    """Each pruned partition's density scan takes the reference's path:
    the same compaction choice, chunk size and band rows, and the grouped
    rung where the reference's grouped kernel serves."""
    j, p, _, _ = trio
    js, ps = j._store("t"), p._store("t")
    _, _, jplan = j._plan("t", B)
    pplan = p._plan("t", B)
    band_parts = 0
    for b in p._executor("t").prune(pplan):
        jex = JExecutor(js.child(b), version_source=js)
        jplan.__dict__["exec_path"] = {}
        jg = jex.density(jplan, BBOX, 64, 48)
        jpath = dict(jplan.exec_path)
        pex = Executor(ps.child(b), compact_min_rows=1, compact_fraction=2.0,
                       version_source=ps)
        pplan.__dict__["exec_path"] = {}
        pg = pex.density(pplan, BBOX, 64, 48)
        np.testing.assert_array_equal(pg, jg)
        for k in ("scan", "B", "band_rows"):
            assert pplan.exec_path.get(k) == jpath.get(k), (b, k, pplan.exec_path, jpath)
        assert (pplan.exec_path.get("density_kernel") == "grouped") == (
            "pallas" in str(jpath.get("density", ""))), (b, pplan.exec_path, jpath)
        band_parts += bool(pplan.exec_path.get("band_rows"))
    assert band_parts == 1


# -- features ----------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["b", "box", "name_time", "polygon_time", "long_time",
                                 "fids", "after", "empty"])
def test_query_rows_and_order_equal(trio, key):
    j, p, _, _ = trio
    q = QUERIES[key]
    assert_same_features(p.query("t", q), j.query("t", q))


SORTED = {
    "desc_10": Query(B, sort_by=[("weight", True)], max_features=10),
    "asc_1000": Query(B, sort_by=[("weight", False)], max_features=1000),
    "name_weight_50": Query(B, sort_by=[("name", False), ("weight", True)], max_features=50),
    "projected": Query(B, properties=["name", "weight"], sort_by=[("weight", True)],
                       max_features=25),
    "code_desc_20": Query(DURING, sort_by=[("code", True)], max_features=20),
    "limit_only": Query(DURING, max_features=333),
    "projection_only": Query(QUERIES["name_time"], properties=["weight"]),
    "sampled": Query(B, sampling=5),
    "sampled_by_name": Query(DURING, sampling=4, sample_by="name"),
}


@pytest.mark.parametrize("key", sorted(SORTED))
def test_sorted_limited_projected_equal(trio, key):
    j, p, f, _ = trio
    q = SORTED[key]
    _, _, jplan = j._plan("t", _jq(q))
    want = j.query("t", _jq(q))
    got = p.query("t", q)
    assert_same_features(got, want)
    assert ("sort" in p._plan("t", q).exec_path) == ("sort" in jplan.__dict__["exec_path"])
    if q.sort_by:
        assert _fid_list(f.query("t", q)) == _fid_list(got)


@pytest.mark.parametrize("key", ["b", "include", "projection_only"])
def test_query_batches_partition_at_a_time(trio, key):
    j, p, _, _ = trio
    q = SORTED.get(key) or Query(QUERIES[key])
    want = list(j.query_batches("t", _jq(q), batch_rows=100))
    got = list(p.query_batches("t", q, batch_rows=100))
    assert [b.n for b in got] == [b.n for b in want]
    for gb, wb in zip(got, want):
        assert set(gb.columns) <= set(wb.columns)
        np.testing.assert_array_equal(gb.columns["__fid__"], wb.columns["__fid__"])
    # partition at a time: no chunk spans two partitions
    dtg = {f: t for f, t in zip(np.arange(N).astype(str), trio[3]["dtg"].astype(np.int64))}
    bins = p._store("t").binned
    for gb in got:
        t = [dtg[f] for f in np.char.decode(gb.columns["__fid__"])]
        assert len(np.unique(bins.to_bin_and_offset(np.asarray(t))[0])) == 1


# -- stats and kNN ------------------------------------------------------------------------
STATS = ("Count();MinMax(weight);Histogram(weight,16,0,1);Enumeration(name);"
         "TopK(name,5);DescriptiveStats(weight)")


@pytest.mark.parametrize("key", ["b", "include", "long_time", "empty"])
def test_stats_equal(trio, key):
    j, p, f, data = trio
    q = QUERIES[key]
    want = j.stats("t", STATS, q)
    got = p.stats("t", STATS, q)
    flat = f.stats("t", STATS, q)
    for i in range(5):
        assert got.stats[i].value() == want.stats[i].value() == flat.stats[i].value(), i
    gd, wd = got.stats[5], want.stats[5]
    assert gd.count == wd.count
    if gd.count:
        np.testing.assert_allclose(gd.s1, wd.s1, rtol=1e-5)
        np.testing.assert_allclose(gd.s2, wd.s2, rtol=1e-5)
    freq = "Frequency(name,64)"
    np.testing.assert_array_equal(p.stats("t", freq, q).counts, j.stats("t", freq, q).counts)


@pytest.mark.parametrize("query, k", [("INCLUDE", 7), (DURING, 25), ("name = 'a3'", 10)])
def test_knn_sets_equal(trio, query, k):
    j, p, f, _ = trio
    want = j.knn("t", -90.0, 38.0, k, query)
    got = p.knn("t", -90.0, 38.0, k, query)
    assert len(got) == len(want) == k
    assert sorted(got.fids) == sorted(want.fids) == sorted(f.knn("t", -90.0, 38.0, k, query).fids)


def test_helpers_read_merged_stats(trio):
    j, p, _, _ = trio
    assert p.bounds("t") == j.bounds("t")
    assert p.min_max("t", "weight", exact=False) == j.min_max("t", "weight", exact=False)
    assert p.unique("t", "name", B) == j.unique("t", "name", B)


# -- invariants ----------------------------------------------------------------------------
@pytest.mark.parametrize("call", ["count", "density", "weighted", "query", "sorted",
                                  "stats", "knn", "batches"])
def test_prefetch_on_equals_off(trio, call):
    _, p, _, _ = trio
    ex = p._executor("t")
    run = {
        "count": lambda: p.count("t", QUERIES["name"]),
        "density": lambda: p.density("t", QUERIES["include"], bbox=BBOX, width=32, height=32),
        "weighted": lambda: p.density("t", B, bbox=BBOX, width=32, height=32,
                                      weight="weight"),
        "query": lambda: _fid_list(p.query("t", QUERIES["after"])),
        "sorted": lambda: _fid_list(p.query("t", SORTED["asc_1000"])),
        "stats": lambda: p.stats("t", STATS, DURING).to_json(),
        "knn": lambda: sorted(p.knn("t", -90.0, 38.0, 25, DURING).fids),
        "batches": lambda: [list(b.columns["__fid__"])
                            for b in p.query_batches("t", "INCLUDE", batch_rows=500)],
    }[call]
    assert ex.prefetch
    on = run()
    ex.prefetch = False
    try:
        off = run()
    finally:
        ex.prefetch = True
    if isinstance(on, np.ndarray):
        np.testing.assert_array_equal(on, off)
    else:
        assert on == off


def test_pipeline_early_exit_joins_the_worker(trio):
    """A consumer that stops after the first partition joins the worker
    and frees what it staged for the partition it prefetched."""
    import threading

    _, p, _, _ = trio
    ex = p._executor("t")
    ps = p._store("t")
    plan = p._fresh_plan("t", "INCLUDE")
    p.count("t", "INCLUDE")  # needed_cols known: the worker stages
    gen = ex._pipeline(plan, ps.partition_bins())
    b0, child = next(gen)
    assert child is ps.partitions[b0] or child.count
    gen.close()
    assert not any(t.name == "geomesa-part-prefetch" for t in threading.enumerate())
    for st in ps.partitions.values():
        assert not st.tables[plan.index_name]._host_stage


@pytest.mark.parametrize("n", range(1, 12))
def test_tree_reducer_matches_tree_merge_and_the_reference(n):
    parts = [np.float32(1.0 + 1e-7 * i) * (10.0 ** (i % 5)) for i in range(n)]
    record = []

    def combine(a, b):
        record.append((a, b))
        return np.float32(a + b)

    red = TreeReducer(combine)
    for v in parts:
        red.push(v)
    got = red.result()
    assert got == tree_merge(parts, combine)
    jred = jdevices.TreeReducer(lambda a, b: np.float32(a + b))
    for v in parts:
        jred.push(v)
    assert got == jred.result() == jdevices.tree_merge(parts, lambda a, b: np.float32(a + b))


# -- extent geometries on a partitioned store -------------------------------------------
POLY_PSPEC = "name:String,height:Float,dtg:Date,*geom:Polygon;geomesa.partition='time'"
LIT = "POLYGON ((-2 -2, 4 -1, 5 4, -1 5, -3 1, -2 -2))"
POLY_QUERIES = {
    "intersects": f"INTERSECTS(geom, {LIT})",
    "intersects_time": f"INTERSECTS(geom, {LIT}) AND {DURING}",
    "bbox_time": f"BBOX(geom, -2, -2, 3, 3) AND {DURING}",
    "not_bbox": "NOT BBOX(geom, -2, -2, 3, 3)",
    "within": "WITHIN(geom, POLYGON ((-6 -6, 6 -6, 6 6, -6 6, -6 -6)))",
    "touches": f"TOUCHES(geom, {LIT})",
    "dwithin": "DWITHIN(geom, LINESTRING (-8 -8, 0 0, 3 6), 30, kilometers)",
    "expr": f"height * 2 > 40 AND {DURING}",
    "st_area": "st_area(geom) > 1.0 AND BBOX(geom, -5, -5, 5, 5)",
}


def _poly_wkts(n, seed=19):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cx, cy = rng.uniform(-10, 10, 2)
        k = int(rng.integers(3, 7))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.3, 1.6, k)
        ring = [(cx + a * np.cos(t), cy + a * np.sin(t)) for t, a in zip(ang, r)]
        body = ", ".join(f"{x} {y}" for x, y in ring + ring[:1])
        if i % 10 == 3:
            hole = ", ".join(f"{cx + 0.3 * (x - cx)} {cy + 0.3 * (y - cy)}"
                             for x, y in ring + ring[:1])
            out.append(f"POLYGON (({body}), ({hole}))")
        else:
            out.append(f"POLYGON (({body}))")
    return out


@pytest.fixture(scope="module")
def poly_trio(tmp_path_factory):
    """(JAX partitioned, port partitioned, port flat) polygon stores with
    max_resident 1: every query streams spilled partitions back."""
    n = 1500
    rng = np.random.default_rng(23)
    lo, hi = parse_iso_ms("2020-01-01"), parse_iso_ms("2020-03-01")
    data = {"name": [f"a{i % 20}" for i in range(n)],
            "height": rng.uniform(0, 40, n).astype(np.float32),
            "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"),
            "geom": _poly_wkts(n)}
    fids = np.char.add("g", np.arange(n).astype(str))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        config.MESH_DEVICES.set(1)
        try:
            j = JGeoDataset(n_shards=2)
            j.create_schema("t", POLY_PSPEC)
            js = j._store("t")
            js.max_resident = 1
            js._spill_dir = str(tmp_path_factory.mktemp("jpoly"))
            j.insert("t", data, fids=fids)
            j.flush("t")
            p = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            p.create_schema("t", POLY_PSPEC)
            ps = p._store("t")
            ps.max_resident = 1
            ps._spill_dir = str(tmp_path_factory.mktemp("ppoly"))
            p.insert("t", data, fids=fids)
            p.flush("t")
            f = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            f.create_schema("t", POLY_PSPEC.split(";")[0])
            f.insert("t", data, fids=fids)
            f.flush("t")
            yield j, p, f
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)
            config.MESH_DEVICES.set(None)


def test_polygon_partitions_spill_as_unicode(poly_trio):
    """Spilled extent partitions keep their WKT as a unicode array (no
    pickle) in the lake snapshot; a reload serves it back to the
    refinement."""
    _, p, _ = poly_trio
    ps = p._store("t")
    assert len(ps.partitions) == 1 and len(ps.spilled) >= 8
    d = next(iter(ps.spilled.values()))
    snap = PartitionSnapshot(d)
    assert snap.read_column("c/geom__wkt").dtype.kind == "U"
    assert snap.primary is None  # no z2 / z3: no row re-order, no pushdown
    assert list(ps.partitions.values())[0].tables.keys() == {"xz3", "xz2", "id"}


def test_npz_layout_spills_and_reloads(trio, tmp_path):
    """With ``geomesa.lake.enabled`` false the port spills the npz layout
    (the reference's other branch); it reloads to the same answers, and a
    pushdown request over it loads whole partitions and says so."""
    j, _, _, data = trio
    with pconfig.LAKE_ENABLED.scoped(False):
        p = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1, compact_fraction=2.0)
        p.create_schema("t", PSPEC)
        ps = p._store("t")
        ps.max_resident = 1
        ps._spill_dir = str(tmp_path)
        p.insert("t", data, fids=np.arange(N).astype(str))
        p.flush("t")
    d = next(iter(ps.spilled.values()))
    assert os.path.exists(os.path.join(d, "data.npz"))
    assert not os.path.exists(os.path.join(d, SNAPSHOT_FILE))
    for key in ("b", "name_time", "include"):
        q = QUERIES[key]
        assert p.count("t", q) == j.count("t", q)
        np.testing.assert_array_equal(
            p.density("t", q, bbox=BBOX, width=32, height=32),
            j.density("t", q, bbox=BBOX, width=32, height=32))
        assert sorted(p.query("t", q).fids) == sorted(j.query("t", q).fids)
    ps.spill_all()
    p.count("t", B)
    assert "legacy-snapshot" in p._plan("t", B).exec_path["lake_fallback"]


@pytest.mark.parametrize("key", sorted(POLY_QUERIES))
def test_polygon_partitioned_equal(poly_trio, key):
    """Counts and fids equal the JAX partitioned store's and the port's
    flat store's, with spilled partitions reloaded on the way."""
    j, p, f = poly_trio
    q = POLY_QUERIES[key]
    ps = p._store("t")
    loads = ps.loads
    want = j.count("t", q)
    assert p.count("t", q) == want == f.count("t", q)
    got_fids = sorted(p.query("t", q).fids)
    assert got_fids == sorted(j.query("t", q).fids) == sorted(f.query("t", q).fids)
    assert ps.loads > loads
    bbox = (-12.0, -12.0, 12.0, 12.0)
    assert np.array_equal(p.density("t", q, bbox=bbox, width=32, height=32),
                          j.density("t", q, bbox=bbox, width=32, height=32))


def test_polygon_partitioned_features_are_wkt(poly_trio):
    j, p, _ = poly_trio
    q = POLY_QUERIES["intersects_time"]
    got, want = p.query("t", q).to_dict(), j.query("t", q).to_dict()
    assert dict(zip(got["__fid__"], got["geom"])) == dict(zip(want["__fid__"], want["geom"]))
    assert all(isinstance(w, str) for w in got["geom"])
