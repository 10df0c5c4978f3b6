"""PyTorch port vs the JAX package: the schema and data lifecycle.

``update_schema``, ``add_attribute_index`` / ``remove_attribute_index``
(with and without an explicit ``geomesa.indices``), ``delete_features``
(point and polygon schemas), ``age_off`` (epoch-ms, datetime64 and ISO
cutoffs), ``delete_schema``, ``describe``, ``get_schema``,
``list_schemas`` and ``z3_histogram``, on a flat store, a partitioned
store with resident partitions, and a partitioned store whose partitions
are all spilled to lake snapshots before the call (so they upgrade or
rewrite when they load). After each call the stores' state (rows in
table order by fid, key columns, key shifts and shard bounds of every
table), the sketches (as JSON), the decider's ``index_name``, and the
answers (counts, density grids, rows in order) equal the JAX package's.

Both packages ingest the same rows made from a NumPy seed; the JAX side
runs its Pallas kernels in interpret mode with compaction forced and one
mesh device, the port on the CPU with the kernels' plain versions. No
tolerance: every compared value is exact.
"""

import json

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.filter.ecql import parse_iso_ms

SPEC = "name:String:index=true,code:Long,weight:Float,dtg:Date,*geom:Point"
N = 3000
BBOX = (-120.0, 25.0, -70.0, 50.0)
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-25T00:00:00Z"
QUERIES = [
    "INCLUDE",
    f"BBOX(geom, -100, 30, -85, 42) AND {DURING}",
    "name = 'a3'",
    "code > 500000000000",
    "weight < 0.3 AND dtg > 2020-02-01T00:00:00Z",
    "INTERSECTS(geom, POLYGON((-95 32, -85 32, -90 40, -95 32)))",
]
KINDS = ["flat", "partitioned", "spilled"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            yield
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


def _data(n=N, seed=7):
    rng = np.random.default_rng(seed)
    lo, hi = parse_iso_ms("2020-01-01"), parse_iso_ms("2020-03-01")
    return {
        "name": [f"a{i % 12}" for i in range(n)],
        "code": rng.integers(0, 1 << 40, n),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
    }


def _pair(kind, tmp_path, spec=SPEC, data=None, fids=None):
    """(JAX, port) datasets holding schema "t" of ``kind``."""
    data = _data() if data is None else data
    n = len(next(iter(data.values())))
    fids = np.arange(n).astype(str) if fids is None else fids
    if kind != "flat":
        spec += ("," if ";" in spec else ";") + "geomesa.partition='time'"
    out = []
    for ds in (JGeoDataset(n_shards=2),
               GeoDataset(n_shards=2, device="cpu", compact_min_rows=1,
                          compact_fraction=2.0)):
        ds.create_schema("t", spec)
        if kind != "flat":
            st = ds._store("t")
            st.max_resident = 2
            st._spill_dir = str(tmp_path / type(ds).__module__.split(".")[0])
        ds.insert("t", data, fids=fids)
        ds.flush("t")
        if kind == "spilled":
            ds._store("t").spill_all()
        out.append(ds)
    return out


def _children(ds):
    st = ds._store("t")
    if hasattr(st, "partition_bins"):
        return [(b, st.child(b)) for b in st.partition_bins()]
    return [(None, st)]


def assert_state_equal(j, p):
    """Every table of every partition: rows in table order (by fid), key
    columns, key shifts and shard bounds; and the merged sketches."""
    jc, pc = _children(j), _children(p)
    assert [b for b, _ in pc] == [b for b, _ in jc]
    for (b, jst), (_, pst) in zip(jc, pc):
        assert pst.count == jst.count, b
        assert sorted(pst.tables) == sorted(jst.tables), b
        for name, jt in jst.tables.items():
            pt = pst.tables[name]
            assert pt.n == jt.n, (b, name)
            np.testing.assert_array_equal(pt.shard_bounds, jt.shard_bounds)
            assert pt.key_shifts == jt.key_shifts, (b, name)
            if not jt.n:
                continue
            np.testing.assert_array_equal(pt.col_sorted("__fid__"), jt.col_sorted("__fid__"),
                                          err_msg=f"{b} {name}")
            assert sorted(pt.key_columns) == sorted(jt.key_columns)
            for k, v in jt.key_columns.items():
                np.testing.assert_array_equal(pt.key_columns[k], v, err_msg=f"{b} {name} {k}")
    jstats, pstats = j._store("t").stats, p._store("t").stats
    assert set(pstats) == set(jstats)
    for k in pstats:
        assert json.loads(pstats[k].to_json()) == json.loads(jstats[k].to_json()), k


def assert_answers_equal(j, p, queries=QUERIES):
    for q in queries:
        assert p._plan("t", q).index_name == j._plan("t", q)[2].index_name, q
        assert p.count("t", q) == j.count("t", q), q
        np.testing.assert_array_equal(p.density("t", q, bbox=BBOX, width=32, height=24),
                                      j.density("t", q, bbox=BBOX, width=32, height=24))
        assert p.query("t", q).fids == j.query("t", q).fids, q


# -- update_schema -----------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_update_schema(kind, tmp_path):
    j, p = _pair(kind, tmp_path)
    jft = j.update_schema("t", "speed:Double,tag:String,seen:Date,ok:Boolean")
    pft = p.update_schema("t", "speed:Double,tag:String,seen:Date,ok:Boolean")
    assert pft.spec() == jft.spec() == p.get_schema("t").spec()
    assert p.describe("t") == j.describe("t")
    nulls = ["speed IS NULL", "tag IS NULL", "ok = false", "seen < 2000-01-01T00:00:00Z"]
    assert_answers_equal(j, p, QUERIES[:2] + nulls)
    fresh = _data(200, seed=9)
    fresh.update(speed=np.linspace(0, 10, 200), tag=[f"t{i % 3}" for i in range(200)],
                 seen=fresh["dtg"], ok=np.arange(200) % 2 == 0)
    for ds in (j, p):
        ds.insert("t", fresh, fids=np.arange(N, N + 200).astype(str))
        ds.flush("t")
    assert_state_equal(j, p)
    assert_answers_equal(j, p, ["speed > 5", "tag = 't1'", "ok = true"] + nulls)
    got = p.query("t", "speed > 9").to_dict()
    want = j.query("t", "speed > 9").to_dict()
    for k in ("__fid__", "speed", "tag", "ok"):
        assert list(got[k]) == list(want[k]), k
    with pytest.raises(ValueError, match="geometry"):
        p.update_schema("t", "g2:Point")


# -- attribute indices --------------------------------------------------------------------
@pytest.mark.parametrize("explicit", [None, "z3,z2,id"])
@pytest.mark.parametrize("kind", KINDS)
def test_add_and_remove_attribute_index(kind, explicit, tmp_path):
    spec = SPEC if explicit is None else f"{SPEC};geomesa.indices='{explicit}'"
    j, p = _pair(kind, tmp_path, spec=spec)
    q = ["code > 1000000000000", "code BETWEEN 1 AND 200000000000", "name = 'a3'"]
    for ds in (j, p):
        ds.add_attribute_index("t", "code")
    assert p.get_schema("t").spec() == j.get_schema("t").spec()
    assert ("attr:code" in p.describe("t")) and p.describe("t") == j.describe("t")
    assert_state_equal(j, p)
    assert_answers_equal(j, p, q)
    assert p._plan("t", q[0]).index_name == "attr:code"
    if kind != "flat":  # partitions made after the change carry the index
        extra = _data(100, seed=13)
        extra["dtg"] = np.full(100, np.datetime64("2020-06-01T00:00:00", "ms"))
        for ds in (j, p):
            ds.insert("t", extra, fids=np.arange(N, N + 100).astype(str))
            ds.flush("t")
        assert_state_equal(j, p)
    for ds in (j, p):
        ds.remove_attribute_index("t", "code")
    assert p.get_schema("t").spec() == j.get_schema("t").spec()
    assert_state_equal(j, p)
    assert_answers_equal(j, p, q)
    assert p._plan("t", q[0]).index_name != "attr:code"
    with pytest.raises(KeyError):
        p.remove_attribute_index("t", "code")
    with pytest.raises(ValueError):
        p.add_attribute_index("t", "geom")


# -- deletes ----------------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_delete_features(kind, tmp_path):
    j, p = _pair(kind, tmp_path)
    for ecql in (f"BBOX(geom, -100, 30, -90, 40) AND {DURING}", "name = 'a5'",
                 "IN ('3', '17', '2999', 'nope')", "EXCLUDE"):
        assert p.delete_features("t", ecql) == j.delete_features("t", ecql)
        assert_state_equal(j, p)
        assert_answers_equal(j, p, QUERIES[:3])
    assert p.count("t", "name = 'a5'") == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p.delete_features("t", "INCLUDE", auths=["admin"])


@pytest.mark.parametrize("form", ["ms", "datetime64", "iso"])
@pytest.mark.parametrize("kind", KINDS)
def test_age_off(kind, form, tmp_path):
    j, p = _pair(kind, tmp_path)
    cutoff = {"ms": parse_iso_ms("2020-01-20T06:00:00Z"),
              "datetime64": np.datetime64("2020-01-20T06:00:00", "ms"),
              "iso": "2020-01-20T06:00:00Z"}[form]
    assert p.age_off("t", cutoff) == j.age_off("t", cutoff) > 0
    assert p.count("t", "dtg < 2020-01-20T06:00:00Z") == 0
    assert_state_equal(j, p)
    assert_answers_equal(j, p)
    if kind != "flat":  # the aged-off partitions stay, empty
        st = p._store("t")
        assert st.partition_bins() == j._store("t").partition_bins()
        assert min(st.part_counts.values()) == 0
    with pytest.raises(ValueError, match="date"):
        g = GeoDataset(device="cpu")
        g.create_schema("u", "*geom:Point")
        g.age_off("u", 0)


POLY_SPEC = "name:String,dtg:Date,*geom:Polygon"


def _poly_data(n=600, seed=19):
    rng = np.random.default_rng(seed)
    wkts = []
    for _ in range(n):
        cx, cy = rng.uniform(-10, 10, 2)
        k = int(rng.integers(3, 7))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.3, 1.6, k)
        ring = [(cx + a * np.cos(t), cy + a * np.sin(t)) for t, a in zip(ang, r)]
        wkts.append("POLYGON ((" + ", ".join(f"{x} {y}" for x, y in ring + ring[:1]) + "))")
    lo, hi = parse_iso_ms("2020-01-01"), parse_iso_ms("2020-03-01")
    return {"name": [f"a{i % 7}" for i in range(n)],
            "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"), "geom": wkts}


@pytest.mark.parametrize("kind", KINDS)
def test_delete_features_refines_polygons(kind, tmp_path):
    """A polygon schema deletes by the exact relation, never by the
    envelope superset."""
    data = _poly_data()
    j, p = _pair(kind, tmp_path, spec=POLY_SPEC, data=data,
                 fids=np.char.add("g", np.arange(600).astype(str)))
    lit = "POLYGON ((-2 -2, 4 -1, 5 4, -1 5, -3 1, -2 -2))"
    loose = p.count("t", "BBOX(geom, -3, -2, 5, 5)")
    n = p.delete_features("t", f"INTERSECTS(geom, {lit})")
    assert n == j.delete_features("t", f"INTERSECTS(geom, {lit})") > 0
    assert p.count("t", f"INTERSECTS(geom, {lit})") == 0 < p.count("t", "BBOX(geom, -3, -2, 5, 5)")
    assert n < loose
    assert_state_equal(j, p)
    for q in ("INCLUDE", "BBOX(geom, -5, -5, 5, 5)", "name = 'a2'"):
        assert p.count("t", q) == j.count("t", q)
        assert sorted(p.query("t", q).fids) == sorted(j.query("t", q).fids)


# -- the schema catalog ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_schema_catalog_and_z3_histogram(kind, tmp_path):
    j, p = _pair(kind, tmp_path)
    for ds in (j, p):
        ds.create_schema("u", "name:String,*geom:Point")
    assert p.list_schemas() == j.list_schemas() == ["t", "u"]
    assert p.get_schema("t").spec() == j.get_schema("t").spec()
    assert p.describe("t") == j.describe("t")
    assert p.describe("u") == j.describe("u")
    assert json.loads(p.z3_histogram("t").to_json()) == json.loads(j.z3_histogram("t").to_json())
    assert p.z3_histogram("u") is None is j.z3_histogram("u")
    p.count("t", "INCLUDE")
    for ds in (j, p):
        ds.delete_schema("t")
    assert p.list_schemas() == j.list_schemas() == ["u"]
    assert not any(k[0] == "t" for k in p._plans) and "t" not in p._executors
    with pytest.raises(KeyError):
        p.get_schema("t")
    with pytest.raises(KeyError):
        p.delete_schema("t")
