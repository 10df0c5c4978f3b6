"""PyTorch port vs the JAX package: standing queries.

The same seeded rows and the same mutations go through both packages'
``GeoDataset`` (the port on ``device="cpu"``), with
``geomesa.subscribe.verify`` on in both, so every applied batch re-scans
and asserts the delta-kept result inside each engine. After each step the
port's poll equals the JAX package's, the result and every update record
(version, kind, rows, epoch), and the port's result equals its own fresh
``count`` / ``density`` / ``stats`` through the query path. Roots with
subscriptions, written through the journal and through a checkpoint, load
in the other package with them.
"""

import shutil

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import obs as jobs
from geomesa_tpu.cache import hierarchy as jhier
from geomesa_tpu.subscribe import delta as jdl
from geomesa_tpu.subscribe import make_spec as jmake_spec
from geomesa_tpu_torch import GeoDataset, config, metrics, obs
from geomesa_tpu_torch.cache import hierarchy
from geomesa_tpu_torch.serving import fuse
from geomesa_tpu_torch.subscribe import UnknownSubscription, make_spec, route_key_of
from geomesa_tpu_torch.subscribe import delta as dl

SPEC = "name:String,speed:Float,dtg:Date,*geom:Point"
VIEW = (-30.0, -20.0, 10.0, 20.0)
VIEW_ECQL = "BBOX(geom, -30, -20, 10, 20)"
POLY = "POLYGON((-20 -15, 15 -15, 15 12, -20 12, -20 -15))"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (OpenMP workers spin under a
    parallel test runner)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _verify_on():
    with config.SUBSCRIBE_VERIFY.scoped("true"), jconfig.SUBSCRIBE_VERIFY.scoped("true"):
        yield


def _data(n=120, seed=7, lo=-45.0, hi=45.0):
    rng = np.random.default_rng(seed)
    return {
        "name": [f"n{i % 3}" for i in range(n)],
        "speed": rng.uniform(0, 30, n).astype(np.float32),
        "dtg": np.datetime64("2024-05-01", "ms") + rng.integers(0, 86_400_000, n),
        "geom__x": rng.uniform(lo, hi, n),
        "geom__y": rng.uniform(-28, 28, n),
    }


def _make(port: bool):
    if port:
        return GeoDataset(n_shards=1, device="cpu")
    return JGeoDataset(n_shards=1, prefer_device=False)


@pytest.fixture()
def pair():
    out = []
    for port in (False, True):
        ds = _make(port)
        ds.create_schema("t", SPEC)
        ds.insert("t", _data(), fids=[f"f{i}" for i in range(120)])
        out.append(ds)
    return out


def both(pair, fn):
    """``fn(ds)`` on both datasets, JAX first."""
    return [fn(ds) for ds in pair]


def _dl(ds):
    return dl if isinstance(ds, GeoDataset) else jdl


def _result(ds, sub_id, cursor=0):
    got = ds.subscription_poll(sub_id, cursor)
    spec = ds.standing._groups[got["schema"]][ds.standing._subs[sub_id][1]].spec
    return got, _dl(ds).decode_result(spec, got["result"])


def _same(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if hasattr(a, "to_json"):
        return a.to_json() == b.to_json()
    return a == b


def subscribe(pair, *args, **kw):
    """One subscription under the same id in both packages."""
    j, p = pair
    sid = j.subscribe(*args, **kw)
    assert p.subscribe(*args, sub_id=sid, **kw) == sid
    return sid


def assert_polls_equal(pair, sid, cursor=0):
    """The port's poll equals the JAX package's: every key but the encoded
    result, which compares decoded."""
    (jg, jv), (pg, pv) = (_result(ds, sid, cursor) for ds in pair)
    assert {k: v for k, v in pg.items() if k != "result"} == \
        {k: v for k, v in jg.items() if k != "result"}
    assert _same(pv, jv)
    return pg, pv


def test_count_delta_and_dirty_rescans(pair):
    j, p = pair
    sid = subscribe(pair, "t", "count", bbox=VIEW)
    got, val = assert_polls_equal(pair, sid)
    assert val == p.count("t", VIEW_ECQL) and got["version"] == 1
    both(pair, lambda ds: ds.insert("t", _data(60, seed=11), fids=[f"g{i}" for i in range(60)]))
    got, val = assert_polls_equal(pair, sid)
    assert val == p.count("t", VIEW_ECQL)
    assert [u["kind"] for u in got["updates"]] == ["snapshot", "delta"]
    both(pair, lambda ds: ds.delete_features("t", "speed > 20"))
    got, val = assert_polls_equal(pair, sid)
    assert val == p.count("t", VIEW_ECQL) and got["updates"][-1]["kind"] == "rescan"
    both(pair, lambda ds: ds.age_off("t", "2024-05-01T12:00:00Z"))
    _, val = assert_polls_equal(pair, sid)
    assert val == p.count("t", VIEW_ECQL)


def test_density_grid_bit_identical(pair):
    j, p = pair
    sid = subscribe(pair, "t", "density", bbox=VIEW, width=64, height=64)
    both(pair, lambda ds: ds.insert("t", _data(80, seed=13), fids=[f"h{i}" for i in range(80)]))
    _, grid = assert_polls_equal(pair, sid)
    ref = p.density("t", VIEW_ECQL, bbox=VIEW, width=64, height=64)
    assert grid.dtype == ref.dtype and np.array_equal(grid, ref)
    both(pair, lambda ds: ds.delete_features("t", "BBOX(geom, -10, -10, 0, 0)"))
    _, grid = assert_polls_equal(pair, sid)
    assert np.array_equal(grid, p.density("t", VIEW_ECQL, bbox=VIEW, width=64, height=64))


def test_pyramid_rollup_downsample_chain(pair):
    j, p = pair
    sid = subscribe(pair, "t", "pyramid", bbox=VIEW, levels=5)
    both(pair, lambda ds: ds.insert("t", _data(90, seed=17), fids=[f"p{i}" for i in range(90)]))
    _, grids = assert_polls_equal(pair, sid)
    assert len(grids) == 6 and grids[0].shape == (32, 32) and grids[-1].shape == (1, 1)
    total = p.count("t", VIEW_ECQL)
    for g in grids:
        assert g.dtype == np.float64 and float(g.sum()) == float(total)
    for child, parent in zip(grids, grids[1:]):
        assert np.array_equal(hierarchy.downsample(child), parent)
        assert np.array_equal(jhier.downsample(child), parent)


def test_stats_exact_merge_only(pair):
    j, p = pair
    sid = subscribe(pair, "t", "stats", bbox=VIEW,
                    stat_spec="Count();Enumeration(name);MinMax(speed)")
    both(pair, lambda ds: ds.insert("t", _data(40, seed=19), fids=[f"s{i}" for i in range(40)]))
    _, stat = assert_polls_equal(pair, sid)
    ref = p.stats("t", "Count();Enumeration(name);MinMax(speed)", VIEW_ECQL)
    assert stat.to_json() == ref.to_json()
    msgs = []
    for ds in pair:
        with pytest.raises(ValueError, match=r"\[GM-SUB\]") as ei:
            ds.subscribe("t", "stats", bbox=VIEW, stat_spec="DescriptiveStats(speed)")
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_fusion_one_group_one_dispatch(pair):
    j, p = pair
    sids = [subscribe(pair, "t", "count", bbox=VIEW) for _ in range(10)]
    assert len({p.standing._subs[s][1] for s in sids}) == 1
    assert p.standing.snapshot() == j.standing.snapshot()
    assert p.standing.snapshot()["subscribers"] == 10
    deltas = []
    for ds, mets in zip(pair, (jmetrics, metrics)):
        c = mets.registry().counter(mets.SUBSCRIBE_DISPATCHES)
        fused = mets.registry().counter(mets.SUBSCRIBE_FUSED)
        b0 = c.value
        ds.insert("t", _data(30, seed=23), fids=[f"q{i}" for i in range(30)])
        deltas.append(c.value - b0)
        assert fused.value >= 9
    assert deltas == [1, 1]
    ref = p.count("t", VIEW_ECQL)
    for s in sids:
        _, val = assert_polls_equal(pair, s)
        assert val == ref


def test_dirty_scoping_leaves_disjoint_groups_untouched(pair):
    j, p = pair
    west = subscribe(pair, "t", "count", bbox=(-45.0, -28.0, -1.0, 28.0))
    east = subscribe(pair, "t", "count", bbox=(1.0, -28.0, 45.0, 28.0))
    both(pair, lambda ds: ds.insert("t", _data(40, seed=29, lo=5.0, hi=40.0),
                                    fids=[f"e{i}" for i in range(40)]))
    got_w, _ = assert_polls_equal(pair, west)
    v_west = got_w["version"]
    both(pair, lambda ds: ds.delete_features("t", "BBOX(geom, 5, -28, 45, 28)"))
    got_e, val_e = assert_polls_equal(pair, east)
    assert got_e["updates"][-1]["kind"] == "rescan"
    assert val_e == p.count("t", "BBOX(geom, 1, -28, 45, 28)")
    got_w, val_w = assert_polls_equal(pair, west)
    assert got_w["version"] == v_west
    assert val_w == p.count("t", "BBOX(geom, -45, -28, -1, 28)")


@pytest.mark.parametrize("agg", ["count", "density"])
def test_region_polygon_viewport(pair, agg):
    j, p = pair
    kw = {"width": 32, "height": 32} if agg == "density" else {}
    sid = subscribe(pair, "t", agg, region=POLY, **kw)
    both(pair, lambda ds: ds.insert("t", _data(50, seed=31), fids=[f"r{i}" for i in range(50)]))
    _, val = assert_polls_equal(pair, sid)
    if agg == "count":
        assert val == p.count("t", f"INTERSECTS(geom, {POLY})")
    else:
        bbox = make_spec("t", "density", region=POLY).bbox
        assert np.array_equal(val, p.density("t", f"INTERSECTS(geom, {POLY})", bbox=bbox,
                                             width=32, height=32))


def test_updates_ring_and_cursor(pair):
    j, p = pair
    sid = subscribe(pair, "t", "count", bbox=VIEW)
    with config.SUBSCRIBE_UPDATES_RING.scoped("4"), jconfig.SUBSCRIBE_UPDATES_RING.scoped("4"):
        for i in range(6):
            both(pair, lambda ds: ds.insert(
                "t", {"name": ["x"], "speed": [1.0], "dtg": [np.datetime64("2024-05-02", "ms")],
                      "geom__x": [0.0], "geom__y": [0.0]}, fids=[f"u{i}"]))
    got, _ = assert_polls_equal(pair, sid)
    assert got["version"] == 7 and got["updates"][0]["version"] > 1
    got2, _ = assert_polls_equal(pair, sid, cursor=got["version"])
    assert got2["updates"] == []
    got3, _ = assert_polls_equal(pair, sid, cursor=5)
    assert [u["version"] for u in got3["updates"]] == [6, 7]


def test_unsubscribe_and_unknown(pair):
    sid = subscribe(pair, "t", "count", bbox=VIEW)
    for ds in pair:
        assert ds.unsubscribe(sid) is True
        assert ds.unsubscribe(sid) is False
    with pytest.raises(UnknownSubscription, match=r"\[GM-SUB-UNKNOWN\]"):
        pair[1].subscription_poll(sid)
    with pytest.raises(UnknownSubscription):
        GeoDataset(device="cpu").subscription_poll("t:z3:0:nope")


def test_route_keys_and_specs_equal_the_reference(pair):
    j, p = pair
    sid = p.subscribe("t", "count", bbox=VIEW)
    assert route_key_of(sid) == make_spec("t", "count", bbox=VIEW).route_key(3)
    assert sid.startswith("t:z3:")
    cases = [dict(aggregate="count", bbox=VIEW), dict(aggregate="density", bbox=VIEW, width=8),
             dict(aggregate="pyramid", region=POLY, levels=3),
             dict(aggregate="stats", stat_spec="Count()"), dict(aggregate="count")]
    for kw in cases:
        ps, js = make_spec("t", **kw), jmake_spec("t", **kw)
        assert ps.to_dict() == js.to_dict() and ps.key() == js.key()
        assert fuse.subscription_key(ps) == js.key()
        for lvl in (1, 3, 9):
            assert ps.route_key(lvl) == js.route_key(lvl)
        assert ps.ecql() == js.ecql()
    for bad in (dict(aggregate="nope", bbox=VIEW), dict(aggregate="stats", bbox=VIEW),
                dict(aggregate="count", bbox=(1, 1, 1, 2))):
        with pytest.raises(ValueError, match=r"\[GM-ARG\]"):
            make_spec("t", **bad)


def test_export_import_guard_adopt_and_resync(pair):
    j, p = pair
    sid = subscribe(pair, "t", "count", bbox=VIEW)
    both(pair, lambda ds: ds.insert("t", _data(20, seed=37), fids=[f"x{i}" for i in range(20)]))
    got, ref = assert_polls_equal(pair, sid)
    exported = [ds.standing.export_groups() for ds in pair]
    assert exported[1] == exported[0]
    # the twin holds the same rows: adopted as they are (the port also
    # adopts the JAX package's export, and the other way round)
    for src, twin_port in ((1, True), (0, True), (1, False)):
        twin = _make(twin_port)
        twin.create_schema("t", SPEC)
        twin.insert("t", _data(), fids=[f"f{i}" for i in range(120)])
        twin.insert("t", _data(20, seed=37), fids=[f"x{i}" for i in range(20)])
        assert twin._standing_engine().import_groups(exported[src]) == \
            {"adopted": 1, "resynced": 0}
        got2, val2 = _result(twin, sid)
        assert val2 == ref and got2["version"] == got["version"]
        assert got2["updates"] == got["updates"]
    # a diverged window re-scans and emits a resync
    out = []
    for port in (False, True):
        other = _make(port)
        other.create_schema("t", SPEC)
        other.insert("t", _data(80, seed=41), fids=[f"y{i}" for i in range(80)])
        assert other._standing_engine().import_groups(exported[int(port)]) == \
            {"adopted": 0, "resynced": 1}
        got3, val3 = _result(other, sid)
        assert val3 == other.count("t", VIEW_ECQL)
        assert got3["version"] == got["version"] + 1
        assert got3["updates"][-1]["kind"] == "resync"
        out.append((got3["updates"], val3))
    assert out[1] == out[0]
    for ds in pair:
        assert len(ds.standing.export_groups(remove=True)["groups"]) == 1
        with pytest.raises(Exception, match="GM-SUB-UNKNOWN"):
            ds.subscription_poll(sid)


def test_partitioned_store_rejected():
    msgs = []
    for port in (False, True):
        ds = _make(port)
        ds.create_schema("p", "name:String,dtg:Date,*geom:Point;geomesa.partition='time'")
        with pytest.raises(ValueError, match=r"\[GM-SUB\]") as ei:
            ds.subscribe("p", "count", bbox=VIEW)
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]


def test_delete_schema_drops_its_groups(pair):
    sid = subscribe(pair, "t", "count", bbox=VIEW)
    for ds in pair:
        ds.delete_schema("t")
        assert ds.standing.snapshot() == {"groups": [], "subscribers": 0}
        with pytest.raises(Exception, match="GM-SUB-UNKNOWN"):
            ds.subscription_poll(sid)


def test_debug_queries_exposes_subscriptions(pair):
    subscribe(pair, "t", "count", bbox=VIEW)
    subscribe(pair, "t", "density", bbox=VIEW, width=16, height=16)
    j, p = pair
    dq, jq = obs.debug_queries(p), jobs.debug_queries(j)
    assert dq["subscriptions"] == jq["subscriptions"]
    assert dq["subscriptions"]["subscribers"] == 2
    assert dq["subscriptions"]["groups"][0]["schema"] == "t"
    assert "subscribe_groups" in obs.handle("/metrics", p)[2].decode().replace(".", "_")


def test_verify_catches_a_diverged_result(pair):
    _, p = pair
    sid = p.subscribe("t", "count", bbox=VIEW)
    grp = p.standing._groups["t"][p.standing._subs[sid][1]]
    grp.result += 1  # a corrupted standing result
    with pytest.raises(AssertionError, match=r"\[GM-SUB-VERIFY\]"):
        p.insert("t", _data(5, seed=43), fids=[f"v{i}" for i in range(5)])


# -- durability and interop ------------------------------------------------------------------------
def _build_root(root, port: bool, checkpoint: bool):
    """A root with two live subscriptions and one unsubscribed, written by
    one package; returns the ids and the writer's results."""
    ds = GeoDataset(device="cpu") if port else JGeoDataset(prefer_device=False)
    ds.attach_journal(root)
    ds.create_schema("t", SPEC)
    ds.insert("t", _data(seed=3))
    ds.flush()
    sid = ds.subscribe("t", "count", bbox=VIEW)
    dsid = ds.subscribe("t", "density", bbox=VIEW, width=32, height=32)
    gone = ds.subscribe("t", "count", bbox=(-2.0, -2.0, 2.0, 2.0))
    assert ds.unsubscribe(gone)
    if checkpoint:
        ds.save(root)
    ds.insert("t", _data(n=40, seed=9, lo=-25.0, hi=5.0))
    ds.flush()
    return (sid, dsid, gone), {s: _result(ds, s)[1] for s in (sid, dsid)}


def _load(root, port: bool):
    if port:
        return GeoDataset.load(root, device="cpu")
    return JGeoDataset.load(root, prefer_device=False)


@pytest.mark.parametrize("checkpoint", [False, True], ids=["journal", "checkpoint"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_roots_with_subscriptions_load_both_ways(tmp_path, writer, checkpoint):
    root = str(tmp_path / "root")
    (sid, dsid, gone), want = _build_root(root, writer == "port", checkpoint)
    # each package loads (and then journals into) a copy of its own
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for r in roots:
        shutil.copytree(root, r)
    loaded = [_load(r, port) for r, port in zip(roots, (False, True))]
    for ds in loaded:
        for s in (sid, dsid):
            assert _same(_result(ds, s)[1], want[s])
        with pytest.raises(Exception, match="GM-SUB-UNKNOWN"):
            ds.subscription_poll(gone)
    # the reloaded registrations are live: new rows flow into both alike
    for ds in loaded:
        ds.insert("t", _data(n=30, seed=21, lo=-25.0, hi=5.0))
        ds.flush()
    for s in (sid, dsid):
        assert _same(_result(loaded[1], s)[1], _result(loaded[0], s)[1])
    assert _result(loaded[1], sid)[1] > want[sid]
    assert _result(loaded[1], sid)[1] == loaded[1].count("t", VIEW_ECQL)
    # a second checkpoint cycle in the port keeps carrying them, for both
    loaded[1].save(roots[1])
    again = _load(roots[1], writer == "jax")
    for s in (sid, dsid):
        assert _same(_result(again, s)[1], _result(loaded[1], s)[1])
