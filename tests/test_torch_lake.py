"""PyTorch port vs the JAX package: the lake snapshot tier.

The codecs over the reference's property walk (``tests/test_lake.py``),
with payload bytes equal to the JAX package's; the container's round trip
and its corruption checks; the ``part.lake`` and ``meta.json`` the port
spills for a partition, byte-equal to the JAX package's, each package's
``PartitionSnapshot`` reading the other's file; and the pushdown scans:
count, unweighted density, unweighted ``density_curve``, stats and
``features_pushdown`` with ``geomesa.lake.pushdown`` on equal to it off,
to the npz layout and to the JAX package, with ``exec_path["lake"]``,
``lake_acct`` and the fallback notes equal to the reference's.

Both packages ingest the same clustered rows (a NumPy seed) into
``geomesa.partition='time'`` stores with 384-row row groups and spill
every partition. The JAX side runs its Pallas kernels in interpret mode
with compaction forced and one mesh device; the port runs on the CPU with
the kernels' plain versions. No tolerance: every answer is exact (the
stats checked are counts, min / max and histograms).
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu.lake import format as jformat
from geomesa_tpu.lake.snapshot import PartitionSnapshot as JSnapshot
from geomesa_tpu.planning.partitioned_exec import _coalesce_boxes as j_coalesce
from geomesa_tpu.stats.parser import parse_stat as jparse_stat
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch import config
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.lake import format as pformat
from geomesa_tpu_torch.lake.residency import GroupResidencyCache
from geomesa_tpu_torch.lake.snapshot import SNAPSHOT_FILE, PartitionSnapshot
from geomesa_tpu_torch.planning.partitioned_exec import _coalesce_boxes
from geomesa_tpu_torch.stats.parser import parse_stat

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 12_000
ROWGROUP = 384
BBOX = (-120.0, 25.0, -70.0, 50.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=N, seed=11):
    """Rows around ten hotspots: a box around one prunes most row groups."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-115, -75, 10)
    cy = rng.uniform(28, 47, 10)
    k = rng.integers(0, 10, n)
    return {
        "name": [f"actor{i % 20}" for i in range(n)],
        "weight": rng.uniform(0, 10, n),
        "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"),
                            n).astype("datetime64[ms]"),
        "geom__x": np.clip(cx[k] + rng.normal(0, 0.25, n), -120, -70),
        "geom__y": np.clip(cy[k] + rng.normal(0, 0.25, n), 25, 50),
    }


def _hot_box(pad=0.4):
    d = _data()
    hx, hy = d["geom__x"][0], d["geom__y"][0]
    return f"BBOX(geom, {hx - pad}, {hy - pad}, {hx + pad}, {hy + pad})"


def _build(cls, path, lake=True, **kw):
    with config.LAKE_ENABLED.scoped(str(lake).lower()), \
            config.LAKE_ROWGROUP_ROWS.scoped(ROWGROUP), \
            jconfig.LAKE_ENABLED.scoped(str(lake).lower()), \
            jconfig.LAKE_ROWGROUP_ROWS.scoped(ROWGROUP):
        ds = cls(n_shards=2, **kw)
        ds.create_schema("t", PSPEC)
        st = ds._store("t")
        st.max_resident = 1
        st._spill_dir = str(path)
        ds.insert("t", _data(), fids=np.arange(N).astype(str))
        ds.flush("t")
        st.spill_all()
    return ds


PORT = dict(device="cpu", compact_min_rows=1, compact_fraction=2.0)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"jax": JAX lake, "jax_npz": JAX npz, "port": port lake,
    "port_npz": port npz}, every partition spilled."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            yield {
                "jax": _build(JGeoDataset, tmp_path_factory.mktemp("jlake")),
                "jax_npz": _build(JGeoDataset, tmp_path_factory.mktemp("jnpz"), lake=False),
                "port": _build(GeoDataset, tmp_path_factory.mktemp("plake"), **PORT),
                "port_npz": _build(GeoDataset, tmp_path_factory.mktemp("pnpz"),
                                   lake=False, **PORT),
            }
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


# -- codecs and the container -----------------------------------------------------
def _walk(n, rng):
    """The reference's property walk (tests/test_lake.py) at one length."""
    return [
        np.sort(rng.integers(-(2**62), 2**62, n)),
        rng.integers(0, 2**31, n).astype(np.int32),
        rng.integers(0, 255, n).astype(np.uint8),
        rng.uniform(-1e9, 1e9, n),
        np.sort(rng.uniform(-180, 180, n)).astype(np.float32),
        rng.uniform(0, 1, n) < 0.5,
        rng.integers(0, 10**12, n).astype("datetime64[ms]"),
        np.asarray([f"s{i % 13}" for i in range(n)]),
        np.full(n, 42, np.int64),
    ]


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4099])
def test_codecs_bytes_equal_the_reference(n):
    rng = np.random.default_rng(3 + n)
    cases = _walk(n, rng)
    cases.append(np.asarray([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-300]))
    for a in cases:
        meta, payload = pformat.encode_array(a)
        jmeta, jpayload = jformat.encode_array(a)
        assert meta == jmeta and payload == jpayload, (a.dtype, meta)
        for dec in (pformat.decode_array, jformat.decode_array):
            b = dec(meta, payload)
            assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), meta


@pytest.mark.parametrize("width", [0, 1, 3, 8, 13, 31, 32, 33, 47, 63, 64])
def test_bit_packing_equals_the_reference(width):
    rng = np.random.default_rng(width)
    for n in (0, 1, 63, 64, 65, 130, 1000):
        v = rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2) \
            + rng.integers(0, 2, n, dtype=np.uint64)
        v = v & np.uint64((1 << width) - 1) if width < 64 else v
        buf = pformat._pack_u64(v, width)
        assert buf == jformat._pack_u64(v, width), (width, n)
        np.testing.assert_array_equal(pformat._unpack_u64(buf, width, n),
                                      jformat._unpack_u64(buf, width, n))
        if width:
            np.testing.assert_array_equal(pformat._unpack_u64(buf, width, n), v)


def test_container_round_trip_and_corruption(tmp_path):
    p = str(tmp_path / "x.lake")
    w = pformat.LakeWriter(p)
    refs = [w.add_array(np.arange(100, dtype=np.int64) * k) for k in (1, 3, 7)]
    w.finish({"kind": "test"})
    f = pformat.LakeFile(p)
    jf = jformat.LakeFile(p)
    for k, r in zip((1, 3, 7), refs):
        np.testing.assert_array_equal(f.read_array(r), np.arange(100) * k)
        np.testing.assert_array_equal(jf.read_array(r), np.arange(100) * k)
    f.close()
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[: len(raw) // 2])  # lost tail
    with pytest.raises(pformat.LakeCorruptError):
        pformat.LakeFile(p)
    open(p, "wb").write(raw[:1] + b"X" + raw[2:])  # head magic
    with pytest.raises(pformat.LakeCorruptError):
        pformat.LakeFile(p)
    off = len(pformat.MAGIC) + 5  # a payload byte: opens, then fails its crc
    open(p, "wb").write(raw[:off] + bytes([raw[off] ^ 0xFF]) + raw[off + 1:])
    f = pformat.LakeFile(p)
    with pytest.raises(pformat.LakeCorruptError, match="crc"):
        f.read_array(refs[0])


# -- the snapshot files -------------------------------------------------------------
def test_snapshot_files_byte_equal_the_reference(stores):
    js, ps = stores["jax"]._store("t"), stores["port"]._store("t")
    assert sorted(ps.spilled) == sorted(js.spilled) and len(ps.spilled) >= 4
    for b in ps.spilled:
        for f in (SNAPSHOT_FILE, "meta.json"):
            assert filecmp.cmp(os.path.join(ps.spilled[b], f),
                               os.path.join(js.spilled[b], f), shallow=False), (b, f)


def test_each_package_reads_the_others_snapshot(stores):
    js, ps = stores["jax"]._store("t"), stores["port"]._store("t")
    for b in ps.spilled:
        mine, theirs = PartitionSnapshot(js.spilled[b]), JSnapshot(ps.spilled[b])
        assert mine.columns == theirs.columns and mine.primary == theirs.primary == "z2"
        assert len(mine.groups) == len(theirs.groups) > 1
        for c in mine.columns:
            np.testing.assert_array_equal(mine.read_column(c), theirs.read_column(c))
            np.testing.assert_array_equal(mine.read_column(c, [1]),
                                          theirs.read_column(c, [1]))
        for name in mine.tables:
            o1, o2 = mine.table_order(name), theirs.table_order(name)
            assert (o1 is None) == (o2 is None) and (o1 is None or np.array_equal(o1, o2))
            k1, k2 = mine.table_keys(name, [0]), theirs.table_keys(name, [0])
            assert k1.keys() == k2.keys()
            for k in k1:
                np.testing.assert_array_equal(k1[k], k2[k])
        g = [0, len(mine.groups) - 1]
        assert mine.account(g) == theirs.account(g)
        box = [(-100.0, 30.0, -95.0, 35.0)]
        assert mine.prune(box, None) == theirs.prune(box, None)


def test_npz_layout_still_written_and_loaded(stores):
    st = stores["port_npz"]._store("t")
    d = next(iter(st.spilled.values()))
    assert os.path.exists(os.path.join(d, "data.npz"))
    assert not os.path.exists(os.path.join(d, SNAPSHOT_FILE))
    assert stores["port_npz"].count("t", "INCLUDE") == N


# -- pushdown answers ---------------------------------------------------------------
QUERIES = {
    "hot": _hot_box(),
    "hot_time": _hot_box(1.0) + " AND dtg DURING 2020-01-05T00:00:00Z/2020-01-20T00:00:00Z",
    "hot_name": _hot_box(1.0) + " AND name = 'actor3'",
    "two_boxes": "BBOX(geom, -101, 30, -99, 32) OR BBOX(geom, -80, 44, -76, 47)",
    "polygon": "INTERSECTS(geom, POLYGON((-110 30, -95 30, -100 42, -110 30)))",
    "time_only": "dtg DURING 2020-01-12T00:00:00Z/2020-01-14T00:00:00Z",
    "disjoint": "BBOX(geom, 100, 80, 101, 81)",
}
STATS = "Count();MinMax(weight);Histogram(weight,16,0,10);Enumeration(name)"


def _jax_run(j, q, op, *args):
    """The JAX executor's answer, exec_path and lake_acct for one fresh
    execution of ``q``'s plan."""
    j._plan_cache_clear("t")
    st, _, plan = j._plan("t", q)
    r = getattr(j._executor(st), op)(plan, *args)
    return r, plan.__dict__.get("exec_path", {}), plan.__dict__.get("lake_acct")


def _port_run(p, q, op, *args):
    plan = p._fresh_plan("t", q)
    r = getattr(p._executor("t"), op)(plan, *args)
    return r, plan.exec_path, plan.__dict__.get("lake_acct")


def _run(ds, q, op, jax):
    """(answer, exec_path, lake_acct) of ``op`` on ``q``, in a form both
    packages give alike."""
    ds._store("t").spill_all()  # a cold store: every partition on disk
    run = _jax_run if jax else _port_run
    mkq = JQuery if jax else Query
    if op == "count":
        r, path, acct = run(ds, q, "count")
        return int(r), path, acct
    if op == "density":
        r, path, acct = run(ds, q, "density", BBOX, 64, 48)
        return np.asarray(r), path, acct
    if op == "curve":
        window, _ = ds._snap_blocks(BBOX, 7)
        r, path, acct = run(ds, mkq(ecql=q, index="z2"), "density_curve", 7, window)
        return np.asarray(r), path, acct
    if op == "stats":
        stat = (jparse_stat if jax else parse_stat)(STATS)
        r, path, acct = run(ds, q, "stats", stat)
        return [s.value() for s in r.stats], path, acct
    r, path, acct = run(ds, q, "features_pushdown")
    return list(r.columns.get("__fid__", [])), path, acct


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("key", sorted(QUERIES))
@pytest.mark.parametrize("op", ["count", "density", "curve", "stats", "features"])
def test_pushdown_answers_and_accounts_equal(stores, op, key):
    q = QUERIES[key]
    p = stores["port"]
    got, path, acct = _run(p, q, op, jax=False)
    want, jpath, jacct = _run(stores["jax"], q, op, jax=True)
    assert _equal(got, want)
    assert path.get("lake") == jpath.get("lake") and acct == jacct
    assert path.get("lake_fallback") is None is jpath.get("lake_fallback")
    if key in ("hot", "hot_time", "polygon"):
        assert acct["groups_pruned"] > 0 and acct["bytes_skipped"] > 0
    with config.LAKE_PUSHDOWN.scoped(False):
        off, off_path, off_acct = _run(p, q, op, jax=False)
    npz, npz_path, _ = _run(stores["port_npz"], q, op, jax=False)
    if op == "features":  # pruned children rebuild their order: compare sets
        assert sorted(got) == sorted(off) == sorted(npz)
    else:
        assert _equal(got, off) and _equal(got, npz)
    assert "lake" not in off_path and off_acct is None
    jnpz, jnpz_path, _ = _run(stores["jax_npz"], q, op, jax=True)
    assert npz_path.get("lake_fallback") == jnpz_path.get("lake_fallback")
    if op != "features":
        assert _equal(npz, jnpz)


@pytest.mark.parametrize("op", ["density", "curve"])
def test_weighted_scans_load_whole_partitions(stores, op):
    p, ps = stores["port"], stores["port"]._store("t")
    ps.spill_all()
    loads = ps.loads
    q = QUERIES["hot"]
    if op == "density":
        plan = p._fresh_plan("t", q)
        p._executor("t").density(plan, BBOX, 64, 48, "weight")
    else:
        p.density_curve("t", q, level=7, bbox=BBOX, weight="weight")
        plan = p._plan("t", Query(q, index="z2"))
    assert "lake" not in plan.exec_path and ps.loads > loads


def test_pruned_child_is_ephemeral_and_freed(stores, monkeypatch):
    p, ps = stores["port"], stores["port"]._store("t")
    ps.spill_all()
    seen = []
    scan_child = ps.scan_child

    def spy(b, window=None):
        child = scan_child(b, window)
        seen.append(child)
        return child

    monkeypatch.setattr(ps, "scan_child", spy)
    loads = ps.loads
    n = p.count("t", QUERIES["hot"])
    pruned = [c for c in seen if c is not None and c.lake_note is not None]
    assert pruned and ps.loads == loads
    assert not any(c is r for c in pruned for r in ps.partitions.values())
    for c in pruned:
        assert c.device_state == {} and all(not t._device_cache and not t._host_stage
                                            for t in c.tables.values())
    monkeypatch.undo()
    assert p.count("t", "INCLUDE") == N
    assert p.count("t", QUERIES["hot"]) == n


def test_fully_pruned_non_primary_child_is_empty(stores):
    ps = stores["port"]._store("t")
    ps.spill_all()
    b = next(iter(ps.spilled))
    child = ps.scan_child(b, {"index": "attr:name", "boxes": [(100.0, 80.0, 101.0, 81.0)],
                              "times": None})
    assert child is not None and child.count == 0
    assert child.lake_note["groups_loaded"] == 0 and child.lake_note["bytes_skipped"] > 0
    assert b in ps.spilled and b not in ps.partitions


def test_fallback_reasons_are_recorded(stores):
    ps = stores["port"]._store("t")
    ps.spill_all()
    b = next(iter(ps.spilled))
    w = {"index": "bogus-keyspace", "boxes": [(-116.0, 27.0, -112.0, 31.0)], "times": None}
    assert ps.scan_child(b, w) is ps.partitions[b]  # a full load serves the scan
    assert w["fallbacks"] == [(int(b), "unknown-keyspace")]
    nps = stores["port_npz"]._store("t")
    nps.spill_all()
    w = {"index": "z2", "boxes": [(-116.0, 27.0, -112.0, 31.0)], "times": None}
    b = next(iter(nps.spilled))
    nps.scan_child(b, w)
    assert w["fallbacks"] == [(int(b), "legacy-snapshot")]


def test_coalesce_boxes_equal_the_reference():
    def prev(v):
        return float(np.nextafter(v, -np.inf))

    cells = [(ix * 11.25, iy * 11.25, prev(ix * 11.25 + 11.25), prev(iy * 11.25 + 11.25))
             for iy in range(2) for ix in range(4)]
    for boxes in (cells, [(0, 0, 1, 1), (5, 5, 6, 6)], cells[:1], cells[::3]):
        assert _coalesce_boxes(list(boxes)) == j_coalesce(list(boxes))
    assert len(_coalesce_boxes(list(cells))) == 1


def test_residency_cache_hits_evicts_and_is_read_only(tmp_path):
    p = str(tmp_path / "x.lake")
    w = pformat.LakeWriter(p)
    refs = [w.add_array(np.arange(1000, dtype=np.int64) * k) for k in (1, 2, 3)]
    w.finish({"kind": "test"})
    f = pformat.LakeFile(p)
    cache = GroupResidencyCache(2 * 8000)
    a = cache.fetch("d", "c/x", 0, refs[0], f)
    assert cache.fetch("d", "c/x", 0, refs[0], f) is a
    assert cache.hits == 1 and cache.bytes_saved == f.blob_nbytes(refs[0])
    with pytest.raises(ValueError):
        a[0] = 5
    cache.fetch("d", "c/x", 1, refs[1], f)
    cache.fetch("d", "c/x", 2, refs[2], f)
    assert cache.evictions == 1 and cache.held_bytes <= cache.budget
    with config.JOIN_PUSHDOWN_RESIDENCY_MB.scoped(0):
        assert GroupResidencyCache.from_config() is None
    assert GroupResidencyCache.from_config().budget == 64 << 20


# -- round trips -----------------------------------------------------------------------
def test_empty_partition_round_trips(tmp_path):
    ds = _build(GeoDataset, tmp_path / "p", **PORT)
    jds = _build(JGeoDataset, tmp_path / "j")
    for d in (ds, jds):
        assert d.delete_features("t", "dtg < 2020-01-13T00:00:00Z") > 0
        d._store("t").spill_all()
    for b, path in ds._store("t").spilled.items():
        mine, theirs = PartitionSnapshot(path), JSnapshot(jds._store("t").spilled[b])
        assert (mine.n, mine.primary, mine.columns, mine.meta) == \
            (theirs.n, theirs.primary, theirs.columns, theirs.meta), b
        assert [g["stats"] for g in mine.groups] == [g["stats"] for g in theirs.groups]
        for c in mine.columns:
            np.testing.assert_array_equal(mine.read_column(c), theirs.read_column(c))
        for name in mine.tables:
            for k, v in mine.table_keys(name).items():
                np.testing.assert_array_equal(v, theirs.table_keys(name)[k])
    empty = [b for b, c in ds._store("t").part_counts.items() if c == 0]
    assert empty
    assert ds.count("t", "INCLUDE") == jds.count("t", "INCLUDE")
    assert ds.query("t", "dtg < 2020-01-06T00:00:00Z").batch.n == 0


def test_new_attribute_null_fills_on_lake_load(tmp_path):
    ds = _build(GeoDataset, tmp_path / "p", **PORT)
    ds.update_schema("t", "speed:Double,tag:String")
    fc = ds.query("t", Query("INCLUDE", properties=["name", "speed", "tag"]))
    assert len(fc.columns["speed"]) == N and np.isnan(fc.columns["speed"]).all()
    assert set(fc.to_dict()["tag"]) == {None}
    st = ds._store("t")
    st.spill_all()
    n = ds.count("t", QUERIES["hot"] + " AND speed IS NULL")
    assert n == ds.count("t", QUERIES["hot"]) > 0
    assert "lake" in ds._plan("t", QUERIES["hot"] + " AND speed IS NULL").exec_path


def test_open_snapshot_survives_a_respill(tmp_path):
    """Blob reads go through the handle the footer was read from, so a
    re-spill that replaces the directory does not change what an open
    snapshot reads."""
    ps = _build(GeoDataset, tmp_path / "p", **PORT)._store("t")
    d = next(iter(ps.spilled.values()))
    snap = PartitionSnapshot(d)
    want = {c: snap.read_column(c, [0]) for c in snap.columns[:2]}
    shutil.rmtree(d)
    os.makedirs(d)
    with open(os.path.join(d, SNAPSHOT_FILE), "wb") as fh:
        fh.write(b"GMLAKE01" + b"\x00" * 64)
    for c, v in want.items():
        np.testing.assert_array_equal(snap.read_column(c, [0]), v)
