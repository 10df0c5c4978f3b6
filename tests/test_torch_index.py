"""PyTorch port vs the JAX package: the z2, id and attribute index tables,
dictionaries, sketches, feature-id hashes, scan windows and the cost-based
index choice.

Both packages ingest the same 40k rows made from a NumPy seed into 4
shards, with explicit feature ids; a Zipf(1.1)-skewed ``name`` over 256
values (GDELT actor-code skew) with a few nulls, a Long ``code`` beyond
2^24, and an indexed Long, Double, Integer and Date on a second schema."""

import numpy as np
import pytest

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config, native
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.index import keyspace as jks
from geomesa_tpu.index import packsort as jpacksort
from geomesa_tpu.curves import zorder as jzorder
from geomesa_tpu.schema.columns import DictionaryEncoder as JDictionaryEncoder
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.convert import store_from_arrays
from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.cover import zcover
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.index import packsort
from geomesa_tpu_torch.schema.columns import DictionaryEncoder

SPEC = "name:String:index=true,code:Long,weight:Float,dtg:Date,*geom:Point"
WIDE = ("name:String:index=true,code:Long:index=true,score:Double:index=true,"
        "n:Integer:index=true,when:Date:index=true,weight:Float,dtg:Date,*geom:Point")
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom, -100, 30, -80, 45)"
NAMES = np.array([f"c{i:03d}" for i in range(256)])


def make_data(n=40_000, seed=13, nulls=True):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    names = NAMES[rng.choice(256, n, p=zipf / zipf.sum())].astype(object)
    if nulls:
        names[rng.random(n) < 0.01] = None
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "name": list(names),
        "code": rng.integers(0, 1 << 40, n),
        "score": rng.normal(0, 100, n),
        "n": rng.integers(-1000, 1000, n).astype(np.int32),
        "when": rng.integers(lo, parse_iso_ms("2021-01-01"), n).astype("datetime64[ms]"),
    }
    data["geom__x"][:40] = -100.0  # rows on the query's f32 bounds
    data["geom__y"][40:80] = 45.0
    return data


def fids_for(n, start=0):
    return np.char.add("e", np.arange(start, start + n).astype(str))


def _both(spec, parts):
    j = JGeoDataset(n_shards=4)
    j.create_schema("t", spec)
    p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    p.create_schema("t", spec)
    start = 0
    for part in parts:
        n = len(part["geom__x"])
        j.insert("t", part, fids=fids_for(n, start))
        j.flush("t")
        p.insert("t", part, fids=fids_for(n, start))
        p.flush("t")
        start += n
    return j, p


@pytest.fixture(scope="module")
def pair():
    return _both(SPEC, [make_data()])


@pytest.fixture(scope="module")
def wide():
    return _both(WIDE, [make_data(seed=17)])


def _assert_tables_equal(jst, pst, name):
    jt, pt = jst.tables[name], pst.tables[name]
    assert jt.key_shifts == pt.key_shifts
    assert np.array_equal(jt.order, pt.order)
    assert np.array_equal(jt.shard_bounds, pt.shard_bounds)
    assert jt.shard_len == pt.shard_len
    assert set(jt.key_columns) == set(pt.key_columns)
    for k, v in jt.key_columns.items():
        assert v.dtype == pt.key_columns[k].dtype, k
        assert np.array_equal(v, pt.key_columns[k]), k


# -- tables ----------------------------------------------------------------------
def test_tables_of_the_schema(pair):
    j, p = pair
    assert list(p._store("t").tables) == list(j._store("t").tables) == \
        ["z3", "z2", "id", "attr:name"]


@pytest.mark.parametrize("name", ["z3", "z2", "id", "attr:name"])
def test_table_state_equal(pair, name):
    j, p = pair
    _assert_tables_equal(j._store("t"), p._store("t"), name)
    jt, pt = j._store("t").tables[name], p._store("t").tables[name]
    for col in ("geom__x", "name", "code", "weight", "__fid__"):
        assert np.array_equal(jt.col_sorted(col), pt.col_sorted(col)), col


@pytest.mark.parametrize("name", ["attr:code", "attr:score", "attr:n", "attr:when"])
def test_numeric_attribute_table_state_equal(wide, name):
    j, p = wide
    _assert_tables_equal(j._store("t"), p._store("t"), name)


@pytest.mark.parametrize("name", ["z3", "z2", "id", "attr:name"])
def test_two_flushes_table_state_equal(name):
    """A second flush appends to z3 / z2 / id under their key shifts and
    rebuilds the attribute table (its dictionary grows: new names), in
    both packages."""
    first = make_data(n=20_000, seed=31)
    more = make_data(n=7_000, seed=32)
    more["name"] = [None if v is None else v.replace("c", "d") if i % 3 == 0 else v
                    for i, v in enumerate(more["name"])]
    j, p = _both(SPEC, [first, more])
    _assert_tables_equal(j._store("t"), p._store("t"), name)
    assert j._store("t").dicts["name"].values == p._store("t").dicts["name"].values


def test_schema_without_a_date():
    spec = "name:String:index=true,weight:Float,*geom:Point"
    data = make_data(n=12_000, seed=5)
    part = {k: data[k] for k in ("name", "weight", "geom__x", "geom__y")}
    j, p = _both(spec, [part])
    assert list(p._store("t").tables) == ["z2", "id", "attr:name"]
    for name in ("z2", "id", "attr:name"):
        _assert_tables_equal(j._store("t"), p._store("t"), name)
    for q in (BOX, "INCLUDE", f"name = 'c003' AND {BOX}", "weight > 0.5"):
        assert p.count("t", q) == j.count("t", q)


# -- dictionaries, sketches, hashes ------------------------------------------------
def test_dictionary_codes_equal(pair):
    j, p = pair
    assert j._store("t").dicts["name"].values == p._store("t").dicts["name"].values
    jm, pm = j._store("t")._all.columns, p._store("t")._all.columns
    assert np.array_equal(jm["name"], pm["name"])
    assert (pm["name"] == -1).sum() > 0  # nulls
    assert np.array_equal(jm["__fid__"], pm["__fid__"])


@pytest.mark.parametrize("seeded", [False, True], ids=["empty", "grown"])
def test_vectorized_dictionary_encode_equals_the_loop(seeded):
    """A numpy unicode column is encoded by np.unique; its codes equal the
    reference's one-value-at-a-time loop, including values already in the
    dictionary."""
    rng = np.random.default_rng(2)
    vals = NAMES[rng.integers(0, 256, 50_000)]
    start = ["c200", "zz", "c007"] if seeded else []
    d, jd = DictionaryEncoder(start), JDictionaryEncoder(start)
    assert np.array_equal(d.encode(vals), jd.encode(list(vals)))
    assert d.values == jd.values
    assert np.array_equal(d.encode(vals[::-1]), jd.encode(list(vals[::-1])))
    assert d.code_of("c000") == jd.code_of("c000") and d.code_of("nope") == -2


def test_sketch_state_equal(pair):
    j, p = pair
    js, ps = j._store("t").stats, p._store("t").stats
    assert set(ps) <= set(js)
    assert js["count"].count == ps["count"].count == 40_000
    k = "bounds"
    assert (js[k].lo, js[k].hi, js[k].count) == (ps[k].lo, ps[k].hi, ps[k].count)
    assert js["enum-name"].counts == ps["enum-name"].counts
    assert np.array_equal(js["z2-histogram"].counts, ps["z2-histogram"].counts)
    jb, pb = js["z3-histogram"].bins, ps["z3-histogram"].bins
    assert set(jb) == set(pb)
    for b in jb:
        assert np.array_equal(jb[b], pb[b])
    assert p.bounds("t") == j.bounds("t")


def test_numeric_minmax_sketches_equal(wide):
    j, p = wide
    for a in ("code", "score", "n", "when"):
        jm, pm = j._store("t").stats[f"minmax-{a}"], p._store("t").stats[f"minmax-{a}"]
        assert (jm.lo, jm.hi, jm.count) == (pm.lo, pm.hi, pm.count)


FIDS = {
    "bytes": np.array([b"e1", b"feature-0042", b"", b"x" * 19], dtype="S19"),
    "unicode": np.array(["e1", "feature-0042", "", "x" * 19]),
    "object": np.array(["e1", "feature-0042", 7, None], dtype=object),
    "non_ascii": np.array(["e1", "café", "地图-3", "plain"]),
}


@pytest.mark.parametrize("kind", sorted(FIDS))
def test_fid_hash_equal(kind):
    fids = FIDS[kind]
    assert np.array_equal(packsort.fid_hash64(fids), jpacksort.fid_hash64(fids))
    for f in fids.tolist():
        s = f.decode() if isinstance(f, bytes) else str(f)
        assert packsort.fid_hash64_one(s) == jpacksort.fid_hash64_one(s)


@pytest.mark.parametrize("kind", sorted(FIDS))
def test_fid_columns_equal(kind):
    """Stored fid columns ('S', or 'U' for non-ASCII) and their unicode
    views equal the JAX package's."""
    from geomesa_tpu.schema.columns import encode_fids as jencode, fid_strs as jstrs
    from geomesa_tpu_torch.schema.columns import encode_fids, fid_strs

    fids = FIDS[kind] if kind != "object" else FIDS[kind][:3]
    got, want = encode_fids(fids, len(fids)), jencode(fids, len(fids))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert fid_strs(got).tolist() == jstrs(want).tolist()
    utf8 = np.array([s.encode("utf-8") for s in ("é1", "plain")])
    assert fid_strs(utf8).tolist() == jstrs(utf8).tolist() == ["é1", "plain"]


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64", "bool"])
def test_ordered_u64_equal(dtype):
    rng = np.random.default_rng(1)
    a = (rng.normal(0, 1e6, 1000)).astype(dtype)
    got, bits = packsort.to_ordered_u64(a)
    want, wbits = jpacksort.to_ordered_u64(a)
    assert bits == wbits and np.array_equal(got, want)
    for v in (-3, 0, 2.5, 1 << 40):
        if dtype != "bool":
            assert packsort.ordered_u64_scalar(v, dtype) == \
                jpacksort.ordered_u64_scalar(v, dtype)


def test_z2_keys_equal():
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-200, 200, 10_000), rng.uniform(-100, 100, 10_000)
    z = zorder.Z2SFC().index(x, y)
    assert np.array_equal(z, jzorder.Z2SFC().index(x, y))
    xi, yi = zorder.deinterleave2(z)
    assert np.array_equal(xi, jzorder._deinterleave2_np(z)[0])
    assert np.array_equal(yi, jzorder._deinterleave2_np(z)[1])


@pytest.mark.parametrize("budget", [64, 2000, 32768])
def test_z2_cover_matches_the_jax_cover(budget):
    from geomesa_tpu.curves.cover import zcover as jzcover

    rng = np.random.default_rng(budget)
    for _ in range(3):
        lo = rng.integers(0, 1 << 30, 2)
        hi = lo + rng.integers(1, 1 << 24, 2)
        want = (native.zcover if native.available() else jzcover)(lo, hi, 31, 2, budget)
        assert [tuple(r) for r in zcover(lo, hi, 31, 2, budget)] == \
            [tuple(r) for r in want]


@pytest.mark.parametrize("dims, bits", [(2, 31), (3, 21)])
@pytest.mark.parametrize("budget", [1, 5, 9, 17, 100, 2000])
def test_cover_matches_the_jax_python_cover(dims, bits, budget):
    """The level-at-a-time cover gives the reference BFS's ranges, budget
    cut-offs included, for boxes from one cell to the whole domain."""
    from geomesa_tpu.curves.cover import zcover as jzcover

    rng = np.random.default_rng(budget * dims)
    for scale in (1, 4, 9, 15, bits - 2, bits):
        lo = rng.integers(0, 1 << (bits - 1), dims)
        hi = np.minimum(lo + rng.integers(0, 1 << scale, dims), (1 << bits) - 1)
        assert [tuple(r) for r in zcover(lo, hi, bits, dims, budget)] == \
            [tuple(r) for r in jzcover(lo, hi, bits, dims, budget)], (scale, lo, hi)
    full = [0] * dims, [(1 << bits) - 1] * dims
    assert [tuple(r) for r in zcover(*full, bits, dims, budget)] == \
        [tuple(r) for r in jzcover(*full, bits, dims, budget)]


# -- windows ----------------------------------------------------------------------------
WINDOWS = {
    "z2_bbox": ("z2", BOX),
    "z2_two_boxes": ("z2", f"{BOX} OR BBOX(geom, -115, 26, -110, 28)"),
    "z2_full_scan": ("z2", "INCLUDE"),
    "z2_dwithin": ("z2", "DWITHIN(geom, POINT(-90 40), 500, kilometers)"),
    "id": ("id", "IN ('e17', 'e4242', 'nope')"),
    "attr_eq": ("attr:name", "name = 'c007'"),
    "attr_in": ("attr:name", "name IN ('c003', 'c100', 'absent')"),
    "attr_range": ("attr:name", "name >= 'c100' AND name < 'c120'"),
    "attr_between": ("attr:name", "name BETWEEN 'c010' AND 'c020'"),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
@pytest.mark.parametrize("cover", [2000, 32768], ids=["planner", "fine"])
def test_windows_equal(pair, name, cover):
    """Scan windows of every key space equal the JAX package's, at the
    planner's range budget and at the compacted path's fine cover."""
    j, p = pair
    index, q = WINDOWS[name]
    jst, pst = j._store("t"), p._store("t")
    jt, pt = jst.tables[index], pst.tables[index]
    cap = max(cover, jks.MAX_SHARD_WINDOWS)
    with config.SCAN_RANGES_TARGET.scoped(cover), jks.window_cap(cap):
        want = jt.windows(jt.keyspace.plan(jst.ft, jparse(q)))
    got = pt.windows(pt.keyspace.plan(pst.ft, parse_ecql(q), cover), cap=cap)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


NUMERIC_WINDOWS = {
    "code": "code BETWEEN 100000000000 AND 300000000000",
    "score": "score > 12.5 AND score <= 80",
    "n": "n IN (-5, 0, 17) OR n < -990",
    "when": "when DURING 2020-03-01T00:00:00Z/2020-04-01T00:00:00Z",
}


@pytest.mark.parametrize("attr", sorted(NUMERIC_WINDOWS))
def test_numeric_attribute_windows_equal(wide, attr):
    j, p = wide
    jst, pst = j._store("t"), p._store("t")
    jt, pt = jst.tables[f"attr:{attr}"], pst.tables[f"attr:{attr}"]
    q = NUMERIC_WINDOWS[attr]
    want = jt.windows(jt.keyspace.plan(jst.ft, jparse(q)))
    got = pt.windows(pt.keyspace.plan(pst.ft, parse_ecql(q)))
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert p.count("t", q) == j.count("t", q)


# -- the cost-based decider ------------------------------------------------------------
DECIDER = [
    BOX,
    "INCLUDE",
    f"name = 'c007' AND {BOX}",
    f"name = 'c000' AND {BOX}",
    f"name = 'c007'",
    "name = 'absent'",
    "IN ('e17', 'e4242')",
    f"IN ('e17') AND {BOX}",
    f"code > 500000000000 AND {BOX} AND {DURING}",
    f"name IN ('c003', 'c010', 'c042') AND weight BETWEEN 0.25 AND 0.75 AND {BOX} AND {DURING}",
    "name LIKE 'c01%' AND DWITHIN(geom, POINT(-90 40), 500, kilometers)",
    f"{BOX} AND {DURING}",
    DURING,
    "weight > 0.5",
    f"name IN ('c000', 'c001') AND {BOX}",
    "name >= 'c100'",
    f"INTERSECTS(geom, POINT(-95.5 33.25)) AND {DURING}",
    f"NOT {BOX}",
    "BBOX(geom, 0, 0, 1, 1) AND BBOX(geom, 5, 5, 6, 6)",
    f"dtg > '2020-01-20T00:00:00Z' AND {BOX}",
    "EXCLUDE",
]


@pytest.mark.parametrize("q", DECIDER, ids=range(len(DECIDER)))
def test_index_choice_equal(pair, q):
    j, p = pair
    _, _, jplan = j._plan("t", q)
    pplan = p._plan("t", q)
    assert pplan.index_name == jplan.index_name
    assert pplan.est_count == jplan.est_count
    assert pplan.key_plan.full_scan == jplan.key_plan.full_scan
    assert pplan.key_plan.disjoint == jplan.key_plan.disjoint


def test_skew_moves_the_choice(pair):
    """The rare name takes the attribute index, the most frequent the z2."""
    _, p = pair
    assert p._plan("t", f"name = 'c007' AND {BOX}").index_name == "attr:name"
    assert p._plan("t", f"name = 'c000' AND {BOX}").index_name == "z2"


# -- carry-across and boundaries -------------------------------------------------------------
def test_store_from_arrays_builds_every_table(pair):
    """z3, z2 and id carried from the JAX store's sorted state, the
    attribute table built here: the tables equal the JAX store's and the
    decider answers as the JAX package does."""
    j, _ = pair
    jst = j._store("t")
    master = {k: v for k, v in jst._all.columns.items() if not k.startswith("__vis")}
    tables = {name: {"order": t.order, "keys": dict(t.key_columns),
                     "shard_bounds": t.shard_bounds, "key_shifts": t.key_shifts}
              for name, t in jst.tables.items() if not name.startswith("attr:")}
    st = store_from_arrays(SPEC, {"master": master, "tables": tables,
                                  "dicts": {"name": jst.dicts["name"].values}},
                           4, device="cpu", name="t")
    for name in jst.tables:
        _assert_tables_equal(jst, st, name)
    p2 = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    p2.attach_store(st)
    for q in DECIDER[:12]:
        assert p2._plan("t", q).index_name == j._plan("t", q)[2].index_name
        assert p2.count("t", q) == j.count("t", q)


@pytest.mark.parametrize("kind", ["s2", "s3"])
def test_other_key_spaces_name_the_roadmap(kind):
    """``geomesa.indices`` naming s2 / s3 (refused before the S2 slice) is
    served: the tables and a count equal the JAX package's."""
    assert _served_pair(f"dtg:Date,*geom:Point;geomesa.indices='{kind},id'") == \
        [kind, "id"]


def _served_pair(spec):
    """A schema made on both sides with 300 lines of one seed: the tables
    it gets and their state, as the JAX package's."""
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-10, 10, (2, 300))
    lo = parse_iso_ms("2020-01-01")
    data = {"dtg": rng.integers(lo, lo + 20 * 86_400_000, 300).astype("datetime64[ms]")}
    if "Point" in spec:
        data.update({"geom__x": x, "geom__y": y})
    else:
        data["geom"] = [f"LINESTRING ({a} {b}, {a + 0.5} {b - 0.25})" for a, b in zip(x, y)]
    j = JGeoDataset(n_shards=4)
    j.create_schema("t", spec)
    p = GeoDataset(n_shards=4, device="cpu")
    p.create_schema("t", spec)
    for ds in (j, p):
        ds.insert("t", data, fids=fids_for(300))
        ds.flush("t")
    jst, pst = j._store("t"), p._store("t")
    assert list(pst.tables) == list(jst.tables)
    for name in jst.tables:
        _assert_tables_equal(jst, pst, name)
    q = "BBOX(geom, -5, -5, 5, 5) AND dtg DURING 2020-01-03T00:00:00Z/2020-01-09T00:00:00Z"
    assert p.count("t", q) == j.count("t", q)
    return list(pst.tables)


@pytest.mark.parametrize("kind", ["xz2", "xz3"])
def test_extent_key_spaces_are_served(kind):
    """``geomesa.indices`` naming an xz index is served: a point schema
    drops it (it indexes extents only) and a line schema builds it, both
    as the JAX package does."""
    assert _served_pair(f"dtg:Date,*geom:Point;geomesa.indices='{kind},id'") == ["id"]
    assert _served_pair(f"dtg:Date,*geom:LineString;geomesa.indices='{kind},id'") == \
        [kind, "id"]


@pytest.mark.parametrize("spec", ["doc:Json,*geom:Point"], ids=["json"])
def test_other_types_name_the_roadmap(spec):
    """A Json attribute (refused before the Json slice) is served: the
    spec round-trips and the tables equal the JAX package's."""
    p = GeoDataset(device="cpu")
    ft = p.create_schema("t", spec)
    assert ft.spec() == JGeoDataset().create_schema("t", spec).spec()
    assert [k.name for k in p._store("t").keyspaces] == ["z2", "id"]


@pytest.mark.parametrize("spec", ["dtg:Date,*geom:LineString"], ids=["extent"])
def test_extent_types_are_served(spec):
    assert _served_pair(spec) == ["xz3", "xz2", "id"]
