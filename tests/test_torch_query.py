"""PyTorch port vs the JAX package: feature queries with ``Query`` objects
(projection, ``max_features``, sorting through the device top-k, sampling,
a forced index), ``query_batches``, ``sample`` and ``count(exact=False)``.

Both packages ingest the same 40k rows made from a NumPy seed into 4
shards with explicit feature ids; the JAX side runs its Pallas kernels in
interpret mode with compaction forced (``geomesa.compact.min.rows`` 1,
``geomesa.compact.fraction`` 2.0 through its config overrides), the port
runs on the CPU with its kernels' plain versions and the same thresholds.
Rows are planted on the box's bounds (f32 band rows, which send features
to the host path), on ties of a sort key (a tie group larger than the
top-k buffer) and with null sort and sampling keys.

Tolerances: none. Rows, their order, ``to_dict()`` and the ``sort``,
``scan``, ``sampling`` and ``band_rows`` entries of ``exec_path`` are
identical wherever the reference records them. The reference's feature
scan records no path; the port's records ``feature_scan``, which the
tests check."""

import numpy as np
import pytest

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch import config as pconfig
from geomesa_tpu_torch.api.dataset import Query
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.planning import executor as pexec

SPEC = ("name:String:index=true,kind:String,code:Long,n:Integer,wide:Integer,"
        "weight:Float,speed:Float,dtg:Date,*geom:Point")
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom, -100, 30, -80, 45)"
#: a box no planted row sits on: its scans stay on the device
BOX2 = "BBOX(geom, -101.3, 31.7, -81.1, 44.3)"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
NAMES = np.array([f"c{i:03d}" for i in range(256)])
KINDS = np.array([f"k{i}" for i in range(12)])
N = 40_000
#: rows planted with one speed value: a tie group wider than k + the slack
TIE_ROWS = 4200


def make_data(n=N, seed=31):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    names = NAMES[rng.choice(256, n, p=zipf / zipf.sum())].astype(object)
    names[rng.random(n) < 0.01] = None
    kinds = KINDS[rng.integers(0, 12, n)].astype(object)
    kinds[rng.random(n) < 0.05] = None
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "speed": np.round(rng.uniform(0, 30, n), 1).astype(np.float32),
        "name": list(names),
        "kind": list(kinds),
        "code": rng.integers(0, 1 << 40, n),
        "n": rng.integers(-50, 150, n).astype(np.int32),
        "wide": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
    }
    x, y = data["geom__x"], data["geom__y"]
    x[:30] = -100.0  # on the box's f32 bounds: the band
    y[30:60] = 45.0
    data["speed"][100:100 + TIE_ROWS] = -1.0  # the lowest speed, tied
    data["speed"][5000:5040] = np.nan  # null Floats
    data["weight"][6000:6010] = 0.5  # ties in the argmin path's key
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


def _jq(q):
    return JQuery(**vars(q)) if isinstance(q, Query) else q


def _run_both(j, p, q, fn):
    """(port result, JAX result, port exec_path, JAX exec_path)."""
    _, _, jplan = j._plan("t", _jq(q))
    want = fn(j, _jq(q))
    got = fn(p, q)
    return got, want, p._plan("t", q).exec_path, dict(jplan.__dict__.get("exec_path", {}))


def assert_same_features(got, want):
    """Same rows in the same order, same decoded values."""
    assert len(got) == len(want)
    assert got.fids == want.fids
    gd, wd = got.to_dict(), want.to_dict()
    assert list(gd) == list(wd)
    for k, v in wd.items():
        np.testing.assert_array_equal(np.asarray(gd[k], dtype=object if isinstance(v, list)
                                                 else None), np.asarray(v, dtype=object
                                                 if isinstance(v, list) else None), k)


def assert_same_path(ppath, jpath):
    """Every ``sort`` / ``scan`` / ``sampling`` / ``band_rows`` entry the
    reference records, the port records the same; ``sort`` on both or
    neither."""
    for key in ("sort", "scan", "sampling", "band_rows"):
        if key in jpath:
            assert ppath.get(key) == jpath[key], (key, ppath, jpath)
    assert ("sort" in ppath) == ("sort" in jpath)


# -- plain queries on every index and scan path ------------------------------------------
#: (ECQL, chosen index, the port's feature scan path)
QUERIES = {
    "z3": (f"{BOX2} AND {DURING}", "z3", "device-compact"),
    "z3_band": (f"{BOX} AND {DURING}", "z3", "host+device-coarse"),
    "z2": (BOX2, "z2", "device-compact"),
    "attr": (f"name = 'c007' AND {BOX2}", "attr:name", "device-compact"),
    "id": ("IN ('e17', 'e4242', 'e39999', 'nope')", "id", "host"),
    "full_scan": ("weight > 0.75", "z2", "device-compact"),
    "include": ("INCLUDE", "z2", "device-compact"),
    "polygon": (f"INTERSECTS(geom, {TRI})", "z2", "device-compact"),
    "polygon_time": (f"INTERSECTS(geom, {TRI}) AND {DURING}", "z3", "device-compact"),
    "long_refine": (f"code > 500000000000 AND {BOX2}", "z2", "host+device-coarse"),
    "empty": (f"{BOX2} AND weight > 2", "z2", "device-compact"),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_equal(pair, name):
    j, p, _ = pair
    q, index, scan = QUERIES[name]
    got, want, ppath, jpath = _run_both(j, p, q, lambda ds, q: ds.query("t", q))
    assert p._plan("t", q).index_name == j._plan("t", q)[2].index_name == index
    assert ppath["feature_scan"] == scan
    assert_same_path(ppath, jpath)
    assert_same_features(got, want)
    if name != "empty":
        assert len(got) > 0


def test_query_padded_layout_equal(pair):
    """Below the compaction threshold the port scans the padded layout:
    the same rows in the same order as the reference's compacted scan."""
    j, p, _ = pair
    padded = GeoDataset(n_shards=4, device="cpu")
    padded.attach_store(p._store("t"))
    for q in (QUERIES["z3"][0], QUERIES["polygon"][0]):
        assert_same_features(padded.query("t", q), j.query("t", q))
        assert padded._plan("t", q).exec_path["feature_scan"] == "device-padded"


@pytest.mark.parametrize("index", ["z3", "z2", "attr:name"])
def test_forced_index_equal(pair, index):
    j, p, _ = pair
    q = Query(f"name = 'c001' AND {BOX2} AND {DURING}", index=index)
    got, want, _, _ = _run_both(j, p, q, lambda ds, q: ds.query("t", q))
    assert p._plan("t", q).index_name == index
    assert_same_features(got, want)


def test_forced_index_that_cannot_serve_raises(pair):
    _, p, _ = pair
    with pytest.raises(ValueError, match="cannot serve"):
        p.query("t", Query(BOX2, index="id"))


# -- sorting, limits and projection ---------------------------------------------------------
Z3 = QUERIES["z3"][0]
#: (Query, the device path top_rows takes: "argmin", "threshold" or None = host sort)
SORTS = {
    "weight_desc_10": (Query(Z3, sort_by=[("weight", True)], max_features=10), "argmin"),
    "weight_asc_25": (Query(BOX2, sort_by=[("weight", False)], max_features=25), "argmin"),
    "weight_ties_32": (Query("INCLUDE", sort_by=[("weight", False)], max_features=32),
                       "argmin"),
    "weight_desc_100": (Query(Z3, sort_by=[("weight", True)], max_features=100),
                        "threshold"),
    "speed_nan_desc_30": (Query(BOX2, sort_by=[("speed", True)], max_features=30),
                          "argmin"),
    "speed_nan_desc_40": (Query(BOX2, sort_by=[("speed", True)], max_features=40),
                          "threshold"),
    "speed_asc_2000": (Query("INCLUDE", sort_by=[("speed", False)], max_features=2000),
                       "threshold"),
    "speed_tie_argmin": (Query("INCLUDE", sort_by=[("speed", False)], max_features=10),
                         "argmin"),
    "speed_tie_overflow": (Query("INCLUDE", sort_by=[("speed", False)], max_features=40),
                           None),
    "code_asc_10": (Query(Z3, sort_by=[("code", False)], max_features=10), "threshold"),
    "n_weight_30": (Query(BOX2, sort_by=[("n", False), ("weight", True)], max_features=30),
                    "threshold"),
    "dtg_desc_12": (Query(Z3, sort_by=[("dtg", True)], max_features=12), "threshold"),
    "name_str_15": (Query(Z3, sort_by=[("name", False)], max_features=15), None),
    "name_weight": (Query(BOX2, sort_by=[("name", True), ("weight", False)],
                          max_features=20), None),
    "underfilled": (Query(f"name = 'c007' AND {BOX2}", sort_by=[("weight", True)],
                          max_features=1000), None),
    "nan_underfilled": (Query("speed IS NULL", sort_by=[("speed", True)], max_features=5),
                        None),
    "no_limit": (Query(QUERIES["attr"][0], sort_by=[("weight", False)]), None),
    "band_host": (Query(QUERIES["z3_band"][0], sort_by=[("weight", True)],
                        max_features=10), "argmin"),
    "refine_host": (Query(QUERIES["long_refine"][0], sort_by=[("weight", True)],
                          max_features=50), "threshold"),
    "polygon_k": (Query(QUERIES["polygon"][0], sort_by=[("weight", True)],
                        max_features=7), "argmin"),
    "projection": (Query(Z3, sort_by=[("weight", True)], max_features=10,
                         properties=["name", "geom"]), "argmin"),
}


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sorted_query_equal(pair, name, monkeypatch):
    """Sorted and limited queries: the same rows in the same order, and the
    same ``exec_path['sort']``; the device selection takes the expected
    path (argmin for k <= 32 on an f32 key with one sort key, the
    threshold search otherwise, None where the host sorts)."""
    j, p, _ = pair
    q, route = SORTS[name]
    taken = []
    ex = p._executor("t")
    real = ex._top_rows_threshold

    def spy(*a, **kw):
        out = real(*a, **kw)
        taken.append("threshold" if out is not None else None)
        return out

    monkeypatch.setattr(ex, "_top_rows_threshold", spy)
    got, want, ppath, jpath = _run_both(j, p, q, lambda ds, q: ds.query("t", q))
    assert_same_path(ppath, jpath)
    assert_same_features(got, want)
    if route is None:
        assert "sort" not in ppath
    else:
        assert ppath["sort"] == f"device-topk(k={q.max_features})"
        assert taken == ([] if route == "argmin" else ["threshold"])
    if q.properties:
        assert sorted(got.columns) == ["__fid__", "geom__x", "geom__y", "name"]


def test_sort_tie_group_overflows_the_buffer(pair):
    """The planted tie group exceeds k + geomesa.topk.tie-slack rows."""
    _, p, data = pair
    assert TIE_ROWS > SORTS["speed_tie_overflow"][0].max_features \
        + pconfig.TOPK_TIE_SLACK.to_int()
    assert (data["speed"] == -1).sum() == TIE_ROWS


@pytest.mark.parametrize("q", [
    Query(Z3, max_features=17),
    Query(BOX2, properties=["name"], max_features=10),
    Query(QUERIES["id"][0], properties=["dtg", "weight"]),
    Query(QUERIES["z3_band"][0], properties=["geom"], max_features=100),
], ids=["limit", "projection", "id_projection", "band_projection"])
def test_limit_and_projection_equal(pair, q):
    j, p, _ = pair
    got, want, ppath, jpath = _run_both(j, p, q, lambda ds, q: ds.query("t", q))
    assert_same_path(ppath, jpath)
    assert_same_features(got, want)
    if q.properties:
        keep = {"__fid__"} | set(q.properties)
        assert all(k in keep or k.split("__")[0] in keep for k in got.columns)


# -- sampling ---------------------------------------------------------------------------------
#: (Query, the port's sampling mode, its scan path)
SAMPLES = {
    "plain": (Query(Z3, sampling=7), None, "device-compact"),
    "plain_include": (Query("INCLUDE", sampling=50), None, "device-compact"),
    "kind_exact": (Query(BOX2, sampling=5, sample_by="kind"), "exact", "device-compact"),
    "name_exact": (Query(Z3, sampling=3, sample_by="name"), "exact", "device-compact"),
    "n_span": (Query(BOX2, sampling=4, sample_by="n"), "exact-span", "device-compact"),
    "wide_hash": (Query(BOX2, sampling=6, sample_by="wide"), "hash", "device-compact"),
    "speed_float_host": (Query(BOX2, sampling=3, sample_by="speed"), None,
                         "host+device-coarse"),
    "code_long_host": (Query(Z3, sampling=2, sample_by="code"), None,
                       "host+device-coarse"),
    "band_plain": (Query(QUERIES["z3_band"][0], sampling=9), None, "host+device-coarse"),
    "band_kind": (Query(QUERIES["z3_band"][0], sampling=4, sample_by="kind"), "exact",
                  "host+device-coarse"),
    "band_hash": (Query(BOX, sampling=4, sample_by="wide"), "hash", "host+device-coarse"),
    "id_kind": (Query("IN ('e1', 'e2', 'e3', 'e4', 'e5', 'e6')", sampling=2,
                      sample_by="kind"), "exact", "host"),
    "sorted": (Query(BOX2, sampling=3, sort_by=[("weight", True)], max_features=20),
               None, "device-padded"),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_sampled_query_equal(pair, name):
    """Sampled queries keep the same rows on every mode and path: the
    1-in-n counter over the padded row order (the compacted chunks keep
    it), per key exactly (dictionary codes, a small int span, nulls as
    their own key), per hash bucket, or on the host after refinement."""
    j, p, _ = pair
    q, mode, scan = SAMPLES[name]
    got, want, ppath, jpath = _run_both(j, p, q, lambda ds, q: ds.query("t", q))
    assert_same_path(ppath, jpath)
    assert_same_features(got, want)
    assert ppath.get("feature_scan", ppath.get("scan")) == scan
    if q.sample_by:
        assert ppath["sampling"] == mode
    assert len(got) > 0


def test_sampling_padded_layout_equal(pair):
    """The padded layout samples the same rows as the compacted one."""
    j, p, _ = pair
    padded = GeoDataset(n_shards=4, device="cpu")
    padded.attach_store(p._store("t"))
    for key in ("plain", "kind_exact", "n_span", "wide_hash"):
        q = SAMPLES[key][0]
        assert_same_features(padded.query("t", q), j.query("t", _jq(q)))
        assert padded._plan("t", q).exec_path["feature_scan"] == "device-padded"


def test_sample_by_counts(pair):
    """Each key keeps ceil(matches_in_key / n) rows, nulls included."""
    _, p, _ = pair
    full = p.query("t", BOX2)
    got = p.query("t", Query(BOX2, sampling=5, sample_by="kind"))
    keys, want = np.unique(full.columns["kind"], return_counts=True)
    gk, gc = np.unique(got.columns["kind"], return_counts=True)
    assert np.array_equal(gk, keys) and -1 in keys
    assert np.array_equal(gc, -(-want // 5))


@pytest.mark.parametrize("q", [
    Query(Z3, sampling=7), Query(BOX2, sampling=5, sample_by="kind"),
    Query(QUERIES["z3_band"][0], sampling=3),
], ids=["count", "count_by_key", "count_band"])
def test_sampled_count_and_density_equal(pair, q):
    j, p, _ = pair
    got, want, ppath, jpath = _run_both(j, p, q, lambda ds, q: ds.count("t", q))
    assert got == want
    assert_same_path(ppath, jpath)
    grid = lambda ds, q: ds.density("t", q, bbox=(-100, 30, -80, 45),  # noqa: E731
                                    width=64, height=48)
    assert np.array_equal(grid(p, q), grid(j, _jq(q)))


def test_sample_by_without_sampling_raises(pair):
    _, p, _ = pair
    with pytest.raises(ValueError, match="sample_by requires sampling"):
        p.query("t", Query(BOX2, sample_by="kind"))


# -- query_batches, sample, estimated counts ------------------------------------------------
@pytest.mark.parametrize("q", [
    Query(Z3), Query(BOX2, properties=["name", "dtg"]), Query(BOX2, max_features=1234),
    Query(Z3, sort_by=[("weight", True)], max_features=50),
], ids=["plain", "projection", "limit", "sorted"])
def test_query_batches_equal(pair, q):
    j, p, _ = pair
    got = list(p.query_batches("t", q, batch_rows=1000))
    want = list(j.query_batches("t", _jq(q), batch_rows=1000))
    assert [b.n for b in got] == [b.n for b in want]
    for gb, wb in zip(got, want):
        for k in ("__fid__", *(q.properties or ["weight", "geom__x"])):
            if k in wb.columns:
                np.testing.assert_array_equal(gb.columns[k], wb.columns[k])
        assert set(gb.columns) <= set(wb.columns) | {"__idhash"}


@pytest.mark.parametrize("q", [Z3, BOX2, QUERIES["z3_band"][0]], ids=["z3", "z2", "band"])
def test_sample_equal(pair, q):
    j, p, _ = pair
    assert_same_features(p.sample("t", 11, q), j.sample("t", 11, q))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_estimated_count_equal(pair, name):
    """``count(exact=False)`` is the planner's estimate: no scan."""
    j, p, _ = pair
    q = QUERIES[name][0]
    assert p.count("t", q, exact=False) == j.count("t", q, exact=False)
    assert not p._plan("t", q).exec_path


@pytest.mark.parametrize("call", ["auths", "srid"])
def test_host_layer_hints_raise(pair, call):
    _, p, _ = pair
    q = Query(BOX2, auths=["admin"]) if call == "auths" else Query(BOX2, srid=3857)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, host layers"):
        p.query("t", q)
    assert p.query("t", Query(BOX2, srid=4326, max_features=3)).srid == 4326
