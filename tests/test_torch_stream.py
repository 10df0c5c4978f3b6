"""PyTorch port vs the JAX package: the streaming tier.

The same seeded messages go through both packages' ``StreamingDataset`` in
one process (the port on ``device="cpu"``), so the fid-hash partitioner,
whose str hash Python salts per process, puts each fid on the same
partition in both, and the topics' bytes, the poll order and the live
caches' row order agree. Compared: the wire bytes, counts, query rows (fids
and every column), density grids in both ``prefer_device`` modes against
the reference's two pixel mappings bit for bit, stats, quarantine counters,
lag gauges and ``stream.apply`` spans, standing updates, journal roots
recovered in the other package both ways (caches and offsets), Lambda
merges and ``run_persistence`` counts. The reference tests of
``tests/test_stream.py`` and the stream tests of ``test_standing.py``,
``test_resilience.py``, ``test_crash.py``, ``test_serving.py``,
``test_spatial_exact.py`` and ``test_advice_r5.py`` run through both.
"""

import time

import numpy as np
import pytest
import torch

import geomesa_tpu.stream as jstream
from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import audit as jaudit
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import tracing as jtracing
from geomesa_tpu.filter import parse_ecql as jparse_ecql
from geomesa_tpu.resilience import inject_faults as jinject_faults
from geomesa_tpu.stream.live import playback as jplayback
from geomesa_tpu.subscribe import delta as jdl
from geomesa_tpu_torch import GeoDataset, audit, config, metrics, stream, tracing
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.kernels import density as kdensity
from geomesa_tpu_torch.resilience import inject_faults
from geomesa_tpu_torch.schema.columns import fid_strs
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stream.live import playback
from geomesa_tpu_torch.stream.messages import CHANGE, CLEAR, DELETE, GeoMessage
from geomesa_tpu_torch.subscribe import delta as dl
from geomesa_tpu_torch.subscribe import route_key_of

SPEC = "name:String,speed:Double,dtg:Date,*geom:Point"
T0 = parse_iso_ms("2020-01-01")
BOX = "BBOX(geom, -100, 30, -80, 45)"
POLY = "POLYGON ((-110 28, -78 31, -84 47, -104 44, -96 38, -110 28))"
QUERIES = [
    "INCLUDE",
    BOX,
    f"{BOX} AND dtg DURING 2020-01-01T00:00:10Z/2020-01-01T00:03:00Z",
    f"INTERSECTS(geom, {POLY})",
    "name = 'n1'",
    "speed > 15 AND name <> 'n0'",
    "BBOX(geom, -95, 30, -85, 40) OR speed < 3",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (OpenMP workers spin under a
    parallel test runner); the JAX side's stores on one device."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jconfig.MESH_DEVICES.set(1)
    yield
    jconfig.MESH_DEVICES.set(None)
    torch.set_num_threads(n)


def _pair(**kw):
    """The JAX package's StreamingDataset and the port's, same options."""
    pd = kw.pop("prefer_device", True)
    return (jstream.StreamingDataset(prefer_device=pd, **kw),
            stream.StreamingDataset(device="cpu", prefer_device=pd, **kw))


def _both(pair, fn):
    return [fn(ds) for ds in pair]


def _points(n, seed, t0=T0, lo=(-120.0, 25.0), hi=(-70.0, 50.0), fid="f"):
    rng = np.random.default_rng(seed)
    ts = t0 + np.arange(n) * 1000
    data = {
        "name": [f"n{i % 3}" for i in range(n)],
        "speed": rng.uniform(0, 30, n),
        "dtg": ts,
        "geom": [(float(x), float(y)) for x, y in
                 zip(rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n))],
    }
    return data, [f"{fid}{i}" for i in range(n)], ts


def _write(pair, name, data, fids, ts):
    _both(pair, lambda ds: ds.write(name, data, fids, ts_ms=ts))


def _same_batch(jb, pb):
    """Rows (fids, in order) and every column equal, dtypes included. The
    port stores no row visibilities: the JAX package's cold tier returns
    its ``__vis__`` column, which has no counterpart."""
    assert pb.n == jb.n
    jcols = {k: v for k, v in jb.columns.items() if k != "__vis__"}
    assert set(pb.columns) == set(jcols)
    for k, a in jcols.items():
        b = pb.columns[k]
        if k == "__fid__":
            assert fid_strs(b).tolist() == fid_strs(a).tolist()
        elif a.dtype == object:
            assert list(b) == list(a), k
        else:
            assert b.dtype == a.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)


def _same_dicts(j, p, name):
    jd, pd = j.cache(name).dicts, p.cache(name).dicts
    assert sorted(pd) == sorted(jd)
    for k in jd:
        assert pd[k].values == jd[k].values


def _same_state(j, p, name):
    _same_batch(j.cache(name).batch(), p.cache(name).batch())
    _same_dicts(j, p, name)
    assert p._offsets[name] == j._offsets[name]
    assert p.cache(name).epoch == j.cache(name).epoch


def _same_topics(j, p, name):
    """The wire bytes, partition by partition. Deletes and clears carry the
    wall clock of their send: those compare with the timestamp zeroed."""
    jt, pt = j._topics[name], p._topics[name]
    assert pt.partitions == jt.partitions

    def canon(raw):
        if raw[0] in (DELETE, CLEAR):
            return raw[:1] + bytes(8) + raw[9:]
        return raw

    assert [[canon(m) for m in log] for log in pt._logs] == \
        [[canon(m) for m in log] for log in jt._logs]


def _counter(reg, name):
    return reg.counter(name).value


# -- the message layer ------------------------------------------------------------------------

def test_geomessage_wire_round_trip():
    for m in (GeoMessage.change("fid-1", {"name": "x", "speed": 4.5, "geom": [1.0, 2.0]}, 123456),
              GeoMessage.delete("fid-2", 99), GeoMessage.clear(5)):
        assert GeoMessage.deserialize(m.serialize()) == m
        jm = jstream.GeoMessage(m.kind, m.ts_ms, m.fid, m.payload)
        assert m.serialize() == jm.serialize()
        assert jstream.GeoMessage.deserialize(m.serialize()) == jm


def test_topic_partitioning_and_offsets():
    for pkg in (jstream, stream):
        bus = pkg.MessageBus()
        t = bus.create("x", partitions=4)
        for i in range(20):
            t.send(pkg.GeoMessage.change(f"f{i}", {}, i))
        msgs, offs = t.poll([0, 0, 0, 0])
        assert len(msgs) == 20 and sum(offs) == 20
        t2 = bus.create("y", partitions=4)
        t2.send(pkg.GeoMessage.change("abc", {}, 1))
        t2.send(pkg.GeoMessage.change("abc", {}, 2))
        assert sorted(t2.end_offsets()) == [0, 0, 0, 2]
        msgs2, offs2 = t.poll(offs)
        assert msgs2 == [] and offs2 == offs
    # the two packages' partitioners agree within one process
    jt, pt = jstream.Topic("z", 4), stream.Topic("z", 4)
    for i in range(64):
        jt.send(jstream.GeoMessage.change(f"id-{i}", {"a": i}, i % 7))
        pt.send(GeoMessage.change(f"id-{i}", {"a": i}, i % 7))
    assert pt._logs == jt._logs
    jm, joff = jt.poll([0] * 4, max_messages=5)
    pm, poff = pt.poll([0] * 4, max_messages=5)
    assert poff == joff and [m.serialize() for m in pm] == [m.serialize() for m in jm]


# -- the live window, its queries and its grids ----------------------------------------------

@pytest.mark.parametrize("prefer_device", [True, False], ids=["device", "host"])
def test_streaming_dataset_query_count_density(prefer_device):
    pair = _pair(prefer_device=prefer_device)
    _both(pair, lambda ds: ds.create_schema("track", SPEC))
    data, fids, ts = _points(100, 0)
    _write(pair, "track", data, fids, ts)
    j, p = pair
    assert p.count("track") == j.count("track") == 100
    xs = np.array([q[0] for q in data["geom"]])
    ys = np.array([q[1] for q in data["geom"]])
    expect = int(((xs >= -100) & (xs <= -80) & (ys >= 30) & (ys <= 45)).sum())
    assert p.count("track", BOX) == j.count("track", BOX) == expect
    grid = p.density("track", BOX, bbox=(-100, 30, -80, 45), width=32, height=32)
    jgrid = j.density("track", BOX, bbox=(-100, 30, -80, 45), width=32, height=32)
    assert grid.dtype == np.float32 and np.array_equal(grid, np.asarray(jgrid))
    assert float(grid.sum()) == expect
    assert p.count("track", "name = 'n0'") == sum(1 for i in range(100) if i % 3 == 0)
    st, jst = p.stats("track", "Enumeration(name)"), j.stats("track", "Enumeration(name)")
    assert st.value() == jst.value() and set(st.value()) == {"n0", "n1", "n2"}
    _same_topics(j, p, "track")


def _churn(pair, name, n=400, seed=3):
    """Writes, moves (later ts), a stale update, deletes, a null geometry
    and a re-add: the same messages into both packages."""
    data, fids, ts = _points(n, seed)
    _write(pair, name, data, fids, ts)
    _both(pair, lambda ds: ds.poll(name))
    mv, mfids, mts = _points(n // 4, seed + 1, t0=T0 + 1_000_000)
    mfids = fids[: n // 4]
    _write(pair, name, mv, mfids, mts)
    stale, _, _ = _points(3, seed + 2, t0=T0 - 10_000)
    _write(pair, name, stale, fids[-3:], [T0 - 10_000] * 3)
    for f in fids[n // 2: n // 2 + 20]:
        _both(pair, lambda ds: ds.delete(name, f))
    null = {"name": ["nn"], "speed": [1.0], "dtg": [T0], "geom": [None]}
    _write(pair, name, null, ["null-geom"], [T0 + 5])
    _both(pair, lambda ds: ds.poll(name))


@pytest.mark.parametrize("prefer_device", [True, False], ids=["device", "host"])
def test_live_window_answers_equal_the_reference(prefer_device):
    pair = _pair(prefer_device=prefer_device)
    j, p = pair
    _both(pair, lambda ds: ds.create_schema("t", SPEC))
    _churn(pair, "t")
    _same_state(j, p, "t")
    _same_topics(j, p, "t")
    # the stale update was dropped in both
    assert len(p.cache("t")) == len(j.cache("t")) == 400 - 20 + 1
    for q in QUERIES:
        assert p.count("t", q) == j.count("t", q), q
        _same_batch(j.query("t", q), p.query("t", q))
        for bbox, w, h in (((-100, 30, -80, 45), 64, 48), ((-180, -90, 180, 90), 256, 256)):
            got = p.density("t", q, bbox=bbox, width=w, height=h)
            want = np.asarray(j.density("t", q, bbox=bbox, width=w, height=h))
            assert got.dtype == want.dtype and np.array_equal(got, want), q
        spec = "Count();MinMax(speed);Enumeration(name);Histogram(speed,10,0,30)"
        assert p.stats("t", spec, q).to_json() == j.stats("t", spec, q).to_json()
        sd, jsd = p.stats("t", "DescriptiveStats(speed)", q), j.stats("t", "DescriptiveStats(speed)", q)
        np.testing.assert_allclose(np.asarray(sd.value()["mean"], float),
                                   np.asarray(jsd.value()["mean"], float), rtol=1e-5)


def test_device_and_host_grids_follow_their_mappings():
    """``prefer_device`` bins f32 points (the reference's jnp path), the
    host mode f64 ones (its NumPy default): each equals its oracle."""
    pd, ph = stream.StreamingDataset(device="cpu"), \
        stream.StreamingDataset(device="cpu", prefer_device=False)
    for ds in (pd, ph):
        ds.create_schema("t", SPEC)
        data, fids, ts = _points(3000, 9, lo=(-100.0, 30.0), hi=(-80.0, 45.0))
        ds.write("t", data, fids, ts_ms=ts)
        ds.poll("t")
    box = (-99.99, 30.01, -80.03, 44.97)
    xs, ys = pd.cache("t").batch().columns["geom__x"], pd.cache("t").batch().columns["geom__y"]
    ok = np.ones(len(xs), bool)
    f32 = kdensity.density_grid(torch.from_numpy(xs.astype(np.float32)),
                                torch.from_numpy(ys.astype(np.float32)), torch.from_numpy(ok),
                                box, 97, 61).numpy()
    f64 = kdensity.density_grid_np(xs, ys, ok, box, 97, 61)
    assert np.array_equal(pd.density("t", bbox=box, width=97, height=61), f32)
    assert np.array_equal(ph.density("t", bbox=box, width=97, height=61), f64)
    twin = kdensity.density_grid_f64(torch.from_numpy(xs), torch.from_numpy(ys),
                                     torch.from_numpy(ok), box, 97, 61).numpy()
    assert np.array_equal(twin, f64)


def test_live_update_delete_clear_and_events():
    pair = _pair()
    events = ([], [])
    for ds, ev in zip(pair, events):
        ds.create_schema("t", SPEC)
        ds.add_listener("t", lambda m, ev=ev: ev.append(m.kind))
    j, p = pair
    ts = T0

    def _write(*a):
        globals()["_write"](*a)
        _both(pair, lambda ds: ds.poll("t"))

    _write(pair, "t", {"name": ["a"], "speed": [1.0], "dtg": [ts], "geom": [(0.0, 0.0)]},
           ["f1"], [ts])
    assert p.count("t") == j.count("t") == 1
    _write(pair, "t", {"name": ["b"], "speed": [2.0], "dtg": [ts + 1000], "geom": [(1.0, 1.0)]},
           ["f1"], [ts + 1000])
    assert p.count("t") == 1
    assert p.cache("t").dicts["name"].decode(p.query("t").columns["name"]) == ["b"]
    _write(pair, "t", {"name": ["zzz"], "speed": [0.0], "dtg": [ts], "geom": [(9.0, 9.0)]},
           ["f1"], [ts])
    assert p.cache("t").dicts["name"].decode(p.query("t").columns["name"]) == ["b"]
    _same_batch(j.query("t"), p.query("t"))
    _both(pair, lambda ds: ds.delete("t", "f1"))
    assert p.count("t") == j.count("t") == 0
    _write(pair, "t", {"name": ["c"], "speed": [1.0], "dtg": [ts], "geom": [(0.0, 0.0)]},
           ["f2"], [ts])
    _both(pair, lambda ds: ds.clear("t"))
    assert p.count("t") == j.count("t") == 0
    assert events[1] == events[0]
    assert CHANGE in events[1] and DELETE in events[1] and CLEAR in events[1]
    assert p.cache("t").epoch == j.cache("t").epoch


def test_clear_delivered_once():
    pair = _pair()
    for ds in pair:
        events = []
        ds.create_schema("t", SPEC)
        ds.add_listener("t", lambda m, ev=events: ev.append(m.kind))
        ds.clear("t")
        ds.poll()
        assert events.count(CLEAR) == 1


def test_null_geometry_tolerated():
    pair = _pair()
    _both(pair, lambda ds: ds.create_schema("t", SPEC))
    _write(pair, "t", {"name": ["a", "b"], "speed": [1.0, 2.0], "dtg": [T0, T0],
                       "geom": [(1.0, 2.0), None]}, ["f1", "f2"], [T0, T0])
    j, p = pair
    assert p.count("t") == j.count("t") == 1
    assert p.count("t", "speed > 0") == 1
    assert fid_strs(p.query("t").columns["__fid__"]).tolist() == ["f1"]
    _same_batch(j.query("t"), p.query("t"))
    _same_batch(j.cache("t").batch(), p.cache("t").batch())


def test_event_time_expiry():
    caches = (jstream.LiveFeatureCache(jstream.live.FeatureType.from_spec("t", SPEC), 10_000),
              stream.LiveFeatureCache(FeatureType.from_spec("t", SPEC), expiry_ms=10_000))
    for cache in caches:
        cache.put("a", {"geom": [0.0, 0.0]}, 0)
        cache.put("b", {"geom": [0.0, 0.0]}, 95_000)
        assert cache.expire(now_ms=100_000) == 1 and len(cache) == 1
    assert caches[1].epoch == caches[0].epoch


def test_stream_expiry_through_poll_equals_reference():
    """A dataset's event-time expiry runs at every poll: the same window
    ages out in both (timestamps in the far past, so ``now`` expires them;
    the recent ones stay)."""
    now = int(time.time() * 1000)
    pair = _pair(expiry_ms=60_000)
    _both(pair, lambda ds: ds.create_schema("t", SPEC))
    data, fids, _ = _points(50, 4)
    ts = [now - 3_600_000 if i % 2 else now + 3_600_000 for i in range(50)]
    _write(pair, "t", data, fids, ts)
    j, p = pair
    assert p.count("t") == j.count("t") == 25
    _same_state(j, p, "t")


def test_grid_index_pruning_matches_full_scan():
    pair = _pair()
    _both(pair, lambda ds: ds.create_schema("t", SPEC))
    data, fids, ts = _points(300, 5)
    _write(pair, "t", data, fids, ts)
    _both(pair, lambda ds: ds.poll())
    j, p = pair
    q = "BBOX(geom, -95, 30, -85, 40)"
    cand = p.cache("t").candidate_rows(parse_ecql(q))
    assert cand is not None and 0 < len(cand) < 300
    np.testing.assert_array_equal(cand, j.cache("t").candidate_rows(jparse_ecql(q)))
    b = p.cache("t").batch()
    xs, ys = b.columns["geom__x"], b.columns["geom__y"]
    expect = int(((xs >= -95) & (xs <= -85) & (ys >= 30) & (ys <= 40)).sum())
    assert p.count("t", q) == j.count("t", q) == expect
    # the grid stays tied to the snapshot it was built from
    idx = p.cache("t").grid_index(b)
    jidx = j.cache("t").grid_index(j.cache("t").batch())
    assert sorted(idx) == sorted(jidx)
    for c in idx:
        np.testing.assert_array_equal(idx[c], jidx[c])
    assert p.cache("t").grid_index(b) is idx


def test_playback():
    pair = _pair()
    _both(pair, lambda ds: ds.create_schema("t", SPEC))
    n = 30
    ts = T0 + np.arange(n) * 500
    rng = np.random.default_rng(0)
    data = {"name": ["a"] * n, "speed": rng.uniform(0, 1, n), "dtg": ts, "geom": [(0.0, 0.0)] * n}
    fids = [f"f{i}" for i in range(n)]
    jplayback(pair[0], "t", data, fids, ts, sleep=False)
    playback(pair[1], "t", data, fids, ts, sleep=False)
    _same_topics(*pair, "t")
    assert pair[1].count("t") == pair[0].count("t") == n


def test_stream_extent_geometry_query():
    """The grid index buckets extents by their bbox, not their centroid."""
    pair = _pair()
    for ds in pair:
        ds.create_schema("s", "dtg:Date,*geom:Polygon")
        ds.write("s", {"dtg": [np.datetime64("2021-06-01", "ms")],
                       "geom": ["POLYGON ((0 0, 40 0, 40 40, 0 40, 0 0))"]},
                 fids=["big"], ts_ms=[1])
    q = "INTERSECTS(geom, POLYGON ((0.5 0.5, 1.5 0.5, 1.5 1.5, 0.5 1.5, 0.5 0.5)))"
    j, p = pair
    got = p.query("s", q)
    assert fid_strs(got.columns["__fid__"]).tolist() == ["big"]
    _same_batch(j.query("s", q), got)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.StreamingDataset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.LambdaDataset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.LambdaDataset(persistent=GeoDataset(device="cpu"))
    sds = stream.StreamingDataset(device="cpu")
    assert sds.device.type == "cpu" and sds.prefer_device  # bins on its device by default
    lam = stream.LambdaDataset(device="cpu")
    assert lam.persistent.device.type == "cpu" and lam.transient.device.type == "cpu"


# -- quarantine, listeners, lag --------------------------------------------------------------

def _poison_pair():
    pair = _pair()
    for ds in pair:
        ds.create_schema("t", "name:String,*geom:Point")
    return pair


def test_poison_stream_message_quarantined():
    pair = _poison_pair()
    regs = (jmetrics.registry(), metrics.registry())
    before = [_counter(r, "stream.poll.quarantined.t") for r in regs]
    for ds, trail in zip(pair, (jaudit, audit)):
        ds.write("t", {"name": ["a", "b"], "geom": [(0.0, 0.0), (1.0, 1.0)]},
                 fids=["f0", "f1"], ts_ms=[1, 2])
        ds._topics["t"]._logs[0].append(b"\x01\x02 not a geomessage")
        ds.write("t", {"name": ["c"], "geom": [(2.0, 2.0)]}, fids=["f2"], ts_ms=[3])
        trail.degradations.clear()
        assert ds.poll("t") == 3
        assert ds.quarantined["t"] == 1 and len(ds.cache("t")) == 3 and ds.count("t") == 3
        assert any(e.source == "stream.poll.decode" for e in trail.degradations.recent())
        assert ds.poll("t") == 0 and ds.quarantined["t"] == 1
    assert [_counter(r, "stream.poll.quarantined.t") - b for r, b in zip(regs, before)] == [1, 1]
    _same_state(*pair, "t")


def test_unappliable_message_quarantined_not_fatal():
    pair = _poison_pair()
    for ds, pkg in zip(pair, (jstream, stream)):
        ds._topics["t"].send(pkg.GeoMessage.change("bad", {"geom": "not-a-point"}, 1))
        ds.write("t", {"name": ["a"], "geom": [(0.0, 0.0)]}, fids=["f0"], ts_ms=[2])
        assert ds.poll("t") == 1 and ds.quarantined["t"] == 1 and ds.count("t") == 1
    _same_state(*pair, "t")


def test_poison_via_fault_injection_seeded():
    pair = _poison_pair()
    for ds in pair:
        ds.write("t", {"name": list("abcd"), "geom": [(float(i), 0.0) for i in range(4)]},
                 fids=[f"f{i}" for i in range(4)], ts_ms=[1, 2, 3, 4])
    j, p = pair
    with jconfig.FAULT_INJECTION.scoped("true"), jinject_faults(seed=11) as inj:
        inj.fail("stream.poll.decode", times=1)
        assert j.poll("t") == 3
    with config.FAULT_INJECTION.scoped("true"), inject_faults(seed=11) as inj:
        inj.fail("stream.poll.decode", times=1)
        assert p.poll("t") == 3
    assert p.quarantined == j.quarantined == {"t": 1}
    assert p.count("t") == 3
    _same_state(j, p, "t")


def test_throwing_listener_does_not_kill_consumer():
    pair = _poison_pair()
    for ds in pair:
        seen = []
        ds.add_listener("t", lambda m, s=seen: s.append(m.fid))
        ds.add_listener("t", lambda m: 1 / 0)
        ds.write("t", {"name": ["a", "b"], "geom": [(0.0, 0.0), (1.0, 1.0)]},
                 fids=["f0", "f1"], ts_ms=[1, 2])
        assert ds.poll("t") == 2 and len(ds.cache("t")) == 2 and sorted(seen) == ["f0", "f1"]


def test_stream_quarantine_counters_in_registry():
    for ds, reg, pkg in zip(_pair(), (jmetrics.registry(), metrics.registry()), (jstream, stream)):
        ds.create_schema("live", "name:String,*geom:Point")
        total = reg.counter("stream.poll.quarantined").value
        ds.write("live", {"name": ["ok"], "geom": [(1.0, 2.0)]}, ["f1"], ts_ms=[5])
        ds._topics["live"].send(pkg.GeoMessage.change("bad", {"name": "x", "geom": "not-a-point"}, 1))
        assert ds.poll("live") == 1 and ds.quarantined["live"] == 1
        assert reg.counter("stream.poll.quarantined").value == total + 1
        assert reg.counter("stream.poll.quarantined.live").value >= 1
    assert metrics.STREAM_POLL_QUARANTINED == "stream.poll.quarantined"


def _span_names(tree):
    return [c["name"] for c in tree.get("children", ())]


def test_stream_lag_gauge_and_span():
    past = int(time.time() * 1000) - 5_000
    trees = []
    for ds, cfg, tr, reg in zip(_pair(), (jconfig, config), (jtracing, tracing),
                                (jmetrics.registry(), metrics.registry())):
        ds.create_schema("s", "a:Integer,dtg:Date,*geom:Point")
        ds.write("s", {"a": [1], "dtg": [past], "geom": [(1.0, 2.0)]}, ["f1"], ts_ms=[past])
        n0 = reg.timer(metrics.STREAM_APPLY).count
        with cfg.TRACE_ENABLED.scoped("true"):
            with tr.start("poll-test"):
                ds.poll("s")
            trees.append(tr.last_trace().root.to_dict())
        assert "stream.apply" in _span_names(trees[-1])
        assert reg.gauge(metrics.STREAM_LAG).value >= 5_000
        assert reg.gauge("stream.lag.s").value >= 5_000
        assert reg.timer(metrics.STREAM_APPLY).count == n0 + 1
        # an empty poll opens no span and times nothing
        ds.poll("s")
        assert reg.timer(metrics.STREAM_APPLY).count == n0 + 1
        assert reg.gauge(f"{metrics.STREAM_EPOCH}.s").value == ds.cache("s").epoch
    jspan, pspan = (next(c for c in t["children"] if c["name"] == "stream.apply")
                    for t in trees)
    assert sorted(pspan["attrs"]) == sorted(jspan["attrs"])
    assert {k: v for k, v in pspan["attrs"].items() if k != "lag_ms"} == \
        {k: v for k, v in jspan["attrs"].items() if k != "lag_ms"}


def test_metric_names_equal_the_reference():
    for k in ("STREAM_LAG", "STREAM_APPLY", "STREAM_EPOCH", "STREAM_POLL_BATCHES"):
        assert getattr(metrics, k) == getattr(jmetrics, k)


def test_poll_batch_counter_and_epoch_gauge():
    pair = _pair()
    _both(pair, lambda ds: ds.create_schema("e", SPEC))
    regs = (jmetrics.registry(), metrics.registry())
    before = [_counter(r, f"{metrics.STREAM_POLL_BATCHES}.e") for r in regs]
    for k in range(3):
        data, fids, ts = _points(10, 20 + k, t0=T0 + k * 100_000)
        _write(pair, "e", data, fids, ts)
        _both(pair, lambda ds: ds.poll("e"))
    _both(pair, lambda ds: ds.poll("e"))  # empty: no batch
    assert [_counter(r, f"{metrics.STREAM_POLL_BATCHES}.e") - b
            for r, b in zip(regs, before)] == [3, 3]
    assert regs[1].gauge(f"{metrics.STREAM_EPOCH}.e").value == \
        regs[0].gauge(f"{metrics.STREAM_EPOCH}.e").value == pair[1].cache("e").epoch


# -- standing queries over live windows --------------------------------------------------------

@pytest.fixture()
def _verify_on():
    with config.SUBSCRIBE_VERIFY.scoped("true"), jconfig.SUBSCRIBE_VERIFY.scoped("true"):
        yield


def _sw(pair, fids, pts, t0, names=None):
    ts = [t0 + i for i in range(len(fids))]
    _write(pair, "v", {"name": names or ["m"] * len(fids), "speed": [1.0] * len(fids),
                       "dtg": ts, "geom": pts}, fids, ts)


def _sub(pair, *args, **kw):
    j, p = pair
    sid = j.subscribe(*args, **kw)
    assert p.subscribe(*args, sub_id=sid, **kw) == sid
    return sid


def _polls(pair, sid, cursor=0):
    out = []
    for ds, d in zip(pair, (jdl, dl)):
        got = ds.subscription_poll(sid, cursor)
        spec = ds.standing._groups[got["schema"]][ds.standing._subs[sid][1]].spec
        out.append((got, d.decode_result(spec, got["result"])))
    (jg, jv), (pg, pv) = out
    assert {k: v for k, v in pg.items() if k != "result"} == \
        {k: v for k, v in jg.items() if k != "result"}
    if isinstance(jv, np.ndarray):
        assert pv.dtype == jv.dtype and np.array_equal(pv, jv)
    elif isinstance(jv, list):
        assert all(np.array_equal(a, b) for a, b in zip(pv, jv)) and len(pv) == len(jv)
    elif hasattr(jv, "to_json"):
        assert pv.to_json() == jv.to_json()
    else:
        assert pv == jv
    return pg, pv


def test_stream_moves_delta_and_epoch_gauge(_verify_on):
    pair = _pair()
    _both(pair, lambda ds: ds.create_schema("v", SPEC))
    t0 = parse_iso_ms("2024-05-01")
    _sw(pair, [f"f{i}" for i in range(40)], [(float(i - 20), 0.0) for i in range(40)], t0)
    j, p = pair
    sid = _sub(pair, "v", "count", bbox=(-10.0, -5.0, 10.0, 5.0))
    got, v = _polls(pair, sid)
    assert v == p.count("v", "BBOX(geom, -10, -5, 10, 5)")
    _sw(pair, ["f0", "f1"], [(0.5, 0.5), (0.6, 0.6)], t0 + 10_000)
    got, v = _polls(pair, sid, got["version"])
    assert v == p.count("v", "BBOX(geom, -10, -5, 10, 5)")
    assert got["updates"][-1]["kind"] == "delta"
    _both(pair, lambda ds: ds.delete("v", "f0"))
    got, v = _polls(pair, sid, got["version"])
    assert v == p.count("v", "BBOX(geom, -10, -5, 10, 5)")
    assert metrics.registry().gauge(f"{metrics.STREAM_EPOCH}.v").value == p.cache("v").epoch
    assert metrics.registry().counter(f"{metrics.STREAM_POLL_BATCHES}.v").value >= 1


def test_stream_clear_and_fused_stream_subscribers(_verify_on):
    pair = _pair()
    _both(pair, lambda ds: ds.create_schema("v", SPEC))
    t0 = parse_iso_ms("2024-05-01")
    _sw(pair, [f"f{i}" for i in range(30)], [(float(i % 10), float(i % 5)) for i in range(30)], t0)
    a = _sub(pair, "v", "density", bbox=(-1.0, -1.0, 11.0, 6.0), width=32, height=32)
    b = _sub(pair, "v", "density", bbox=(-1.0, -1.0, 11.0, 6.0), width=32, height=32)
    assert route_key_of(a) == route_key_of(b)
    assert len(pair[1].standing._groups["v"]) == 1
    _both(pair, lambda ds: ds.clear("v"))
    _, grid = _polls(pair, a)
    assert float(grid.sum()) == 0.0


@pytest.mark.parametrize("aggregate,kw", [
    ("count", {}), ("density", {"width": 48, "height": 32}), ("pyramid", {"levels": 3}),
    ("stats", {"stat_spec": "Count();MinMax(speed)"}),
], ids=["count", "density", "pyramid", "stats"])
def test_standing_updates_through_moves_deletes_and_expiry(_verify_on, aggregate, kw):
    """Each step's poll equals the reference's, and the port's result
    equals its own fresh call; a move is one delta batch, a delete and an
    expiry re-scan only the groups they touch."""
    now = int(time.time() * 1000)
    pair = _pair(expiry_ms=3_600_000)
    _both(pair, lambda ds: ds.create_schema("v", SPEC))
    view = (-110.0, 30.0, -90.0, 45.0)
    far = (-80.0, 26.0, -72.0, 30.0)
    data, fids, _ = _points(300, 31)
    ts = [now - 7_200_000 if i % 10 == 0 else now - 1000 + i for i in range(300)]
    _write(pair, "v", data, fids, ts)
    sid = _sub(pair, "v", aggregate, bbox=view, **kw)
    sfar = _sub(pair, "v", "count", bbox=far)
    j, p = pair
    got, v = _polls(pair, sid)
    cursor = got["version"]
    ecql = "BBOX(geom, -110, 30, -90, 45)"
    if aggregate == "count":
        assert v == p.count("v", ecql)
    # moves
    mv, _, _ = _points(40, 32)
    _write(pair, "v", mv, fids[1:41], [now + i for i in range(40)])
    got, v = _polls(pair, sid, cursor)
    kinds = [u["kind"] for u in got["updates"]]
    assert kinds[-1] in ("delta", "rescan") and (aggregate == "stats" or kinds == ["delta"])
    cursor = got["version"]
    far_v = _polls(pair, sfar)[0]["version"]
    # deletes inside the view only: the far group keeps its version
    inside = [f for f, (x, y) in zip(fids, data["geom"])
              if view[0] <= x <= view[2] and view[1] <= y <= view[3] and f not in fids[1:41]][:5]
    for f in inside:
        _both(pair, lambda ds: ds.delete("v", f))
    got, v = _polls(pair, sid, cursor)
    assert got["updates"][-1]["kind"] == "rescan"
    assert _polls(pair, sfar)[0]["version"] == far_v
    if aggregate == "count":
        assert v == p.count("v", ecql)
    elif aggregate == "density":
        # the standing grid maps pixels in f64, as the host mode does
        p.prefer_device = False
        assert np.array_equal(v, p.density("v", ecql, bbox=view, width=48, height=32))
        p.prefer_device = True
    assert len(p.cache("v")) == len(j.cache("v"))


def test_standing_unsubscribe_and_unknown():
    from geomesa_tpu_torch.subscribe import UnknownSubscription

    p = stream.StreamingDataset(device="cpu")
    p.create_schema("v", SPEC)
    with pytest.raises(UnknownSubscription):
        p.subscription_poll("v:z3:1:nope")
    sid = p.subscribe("v", "count", bbox=(-1.0, -1.0, 1.0, 1.0))
    assert p.unsubscribe(sid) and not p.unsubscribe(sid)
    with pytest.raises(KeyError):
        p.subscribe("nope", "count", bbox=(-1.0, -1.0, 1.0, 1.0))


# -- durability: journal roots, both ways ------------------------------------------------------

def _journaled(pkg, root, bus, partitions=2, **kw):
    ds = (pkg.StreamingDataset(bus=bus, partitions=partitions, **kw) if pkg is jstream else
          pkg.StreamingDataset(bus=bus, partitions=partitions, device="cpu", **kw))
    ds.attach_journal(root)
    return ds


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stream_journal_resume_exactly_once(tmp_path, writer):
    """The reference's resume test, then the root read by the other package:
    the same cache, the same offsets, and the next poll applies nothing."""
    wpkg, rpkg = (jstream, stream) if writer == "jax" else (stream, jstream)
    root = str(tmp_path)
    wbus = wpkg.MessageBus()
    sds = _journaled(wpkg, root, wbus)
    sds.create_schema("t", SPEC)
    data, fids, ts = _points(60, 40)
    sds.write("t", data, fids, ts_ms=ts)
    assert sds.poll("t") == 60
    mv, _, mts = _points(10, 41, t0=T0 + 500_000)
    sds.write("t", mv, fids[:10], ts_ms=mts)
    sds.delete("t", fids[20])
    sds._topics["t"].send(wpkg.GeoMessage.change("bad", {"geom": "x"}, 3))
    assert sds.poll("t") == 11
    offsets = list(sds._offsets["t"])
    want = sds.cache("t").batch()
    sds._journal.close()

    # the same broker bytes under the reader's bus, then a fresh consumer of
    # each package on the root
    for pkg in (wpkg, rpkg):
        bus = pkg.MessageBus()
        bus.create("geomesa-t", 2)._logs = [list(log) for log in wbus.topic("geomesa-t")._logs]
        ds2 = _journaled(pkg, root, bus)
        assert ds2.recover() >= 3
        assert "t" in ds2._schemas and ds2._offsets["t"] == offsets
        _same_batch(want, ds2.cache("t").batch())
        assert ds2.poll("t") == 0 and len(ds2.cache("t")) == 59
        ds2._journal.close()


def test_stream_journal_replay_skips_a_bad_record(tmp_path):
    from geomesa_tpu_torch import resilience

    root = str(tmp_path)
    bus = stream.MessageBus()
    sds = _journaled(stream, root, bus)
    sds.create_schema("t", SPEC)
    sds.write("t", {"name": ["a"], "speed": [1.0], "dtg": [T0], "geom": [(1.0, 1.0)]},
              ["f1"], ts_ms=[T0])
    sds.poll("t")
    sds._journal.append({"kind": "stream-batch", "schema": "t", "offsets": [0, 0],
                         "msgs": [[CHANGE, "f2", {"geom": [1.0, 2.0]}, "not-an-int"]]})
    sds._journal.close()
    resilience.skipped(clear=True)
    ds2 = _journaled(stream, root, bus)
    assert ds2.recover() == 2
    assert len(ds2.cache("t")) == 1
    assert any(s.phase == "stream" for s in resilience.skipped())
    ds2._journal.close()


def test_journal_off_attaches_nothing(tmp_path):
    with config.JOURNAL_ENABLED.scoped("false"):
        sds = _journaled(stream, str(tmp_path), stream.MessageBus())
    assert sds._journal is None and sds.recover() == 0


# -- the Lambda store -----------------------------------------------------------------------------

def _lambda_pair(persist_age_ms, n_shards=2):
    return (jstream.LambdaDataset(JGeoDataset(n_shards=n_shards),
                                  jstream.StreamingDataset(), persist_age_ms=persist_age_ms),
            stream.LambdaDataset(GeoDataset(n_shards=n_shards, device="cpu"),
                                 stream.StreamingDataset(device="cpu"),
                                 persist_age_ms=persist_age_ms))


def test_lambda_tiering():
    pair = _lambda_pair(60_000)
    _both(pair, lambda lam: lam.create_schema("t", SPEC))
    rng = np.random.default_rng(1)
    for start, base in ((0, T0), (50, T0 + 10_000_000)):
        ts = base + np.arange(50) * 1000
        data = {"name": [f"n{i % 3}" for i in range(50)], "speed": rng.uniform(0, 30, 50),
                "dtg": ts, "geom": [(float(x), float(y)) for x, y in
                                    zip(rng.uniform(-120, -70, 50), rng.uniform(25, 50, 50))]}
        _both(pair, lambda lam: lam.write("t", data, [f"f{start + i}" for i in range(50)],
                                          ts_ms=ts))
    now = T0 + 10_000_000 + 49_000 + 1
    assert _both(pair, lambda lam: lam.run_persistence(now_ms=now)) == [50, 50]
    j, p = pair
    assert len(p.transient.cache("t")) == 50 and p.persistent.count("t") == 50
    assert p.count("t") == j.count("t") == 100
    st, jst = p.stats("t", "Enumeration(name)"), j.stats("t", "Enumeration(name)")
    assert st.value() == jst.value() and sum(st.value().values()) == 100
    grid = p.density("t", bbox=(-120, 25, -70, 50), width=16, height=16)
    assert np.array_equal(grid, j.density("t", bbox=(-120, 25, -70, 50), width=16, height=16))
    assert float(grid.sum()) == 100
    assert _both(pair, lambda lam: lam.run_persistence(now_ms=now)) == [0, 0]


def test_lambda_repersist_update_no_duplicate():
    pair = _lambda_pair(1_000)
    _both(pair, lambda lam: lam.create_schema("t", SPEC))
    row = {"name": ["a"], "speed": [1.0], "dtg": [T0], "geom": [(0.0, 0.0)]}
    _both(pair, lambda lam: lam.write("t", row, ["f1"], ts_ms=[T0]))
    assert _both(pair, lambda lam: lam.run_persistence(now_ms=T0 + 2_000)) == [1, 1]
    row2 = {"name": ["a"], "speed": [2.0], "dtg": [T0 + 5_000], "geom": [(1.0, 1.0)]}
    _both(pair, lambda lam: lam.write("t", row2, ["f1"], ts_ms=[T0 + 5_000]))
    assert _both(pair, lambda lam: lam.run_persistence(now_ms=T0 + 10_000)) == [1, 1]
    j, p = pair
    assert p.persistent.count("t") == 1 and p.count("t") == 1
    assert p.persistent.query("t").to_dict()["speed"][0] == pytest.approx(2.0)
    _same_batch(j.query("t"), p.query("t"))


def test_lambda_persist_null_geometry():
    pair = _lambda_pair(1_000)
    _both(pair, lambda lam: lam.create_schema("t", SPEC))
    _both(pair, lambda lam: lam.write("t", {"name": ["a", "b"], "speed": [1.0, 2.0],
                                            "dtg": [T0, T0], "geom": [None, (3.0, 4.0)]},
                                      ["f1", "f2"], ts_ms=[T0, T0]))
    assert _both(pair, lambda lam: lam.run_persistence(now_ms=T0 + 2_000)) == [2, 2]
    assert _both(pair, lambda lam: lam.persistent.count("t", "BBOX(geom, 0, 0, 10, 10)")) == [1, 1]


def test_lambda_merge_equals_reference_and_oracle():
    """Half the window ages into the cold tier, some cold fids get a newer
    hot copy (hot wins), one is deleted hot: merged count, rows, density
    and stats equal the reference's for every query, polygon included."""
    pair = _lambda_pair(60_000, n_shards=4)
    _both(pair, lambda lam: lam.create_schema("t", SPEC))
    data, fids, _ = _points(600, 50)
    ts = [T0 + (i % 2) * 10_000_000 + i for i in range(600)]
    _both(pair, lambda lam: lam.write("t", data, fids, ts_ms=ts))
    now = T0 + 10_000_000 - 1
    moved = _both(pair, lambda lam: lam.run_persistence(now_ms=now))
    assert moved[0] == moved[1] == 300
    # a newer hot copy of 40 cold fids, at other positions
    cold_fids = fids[0:80:2]
    up, _, _ = _points(40, 51, lo=(-100.0, 30.0), hi=(-80.0, 45.0))
    _both(pair, lambda lam: lam.write("t", up, cold_fids, ts_ms=[now + 5] * 40))
    j, p = pair
    for q in QUERIES:
        jq, pq = j.query("t", q), p.query("t", q)
        _same_batch(jq, pq)
        assert p.count("t", q) == j.count("t", q) == pq.n
        got = p.density("t", q, bbox=(-120, 25, -70, 50), width=64, height=48)
        assert np.array_equal(got, j.density("t", q, bbox=(-120, 25, -70, 50), width=64,
                                                height=48)), q
        assert float(got.sum()) == pq.n
        spec = "Count();MinMax(speed);Enumeration(name)"
        assert p.stats("t", spec, q).to_json() == j.stats("t", spec, q).to_json()
    # hot wins: a cold fid with a hot copy appears once, at the hot position
    merged = p.query("t", "INCLUDE")
    got_fids = fid_strs(merged.columns["__fid__"]).tolist()
    assert len(got_fids) == len(set(got_fids)) == 600
    pos = dict(zip(got_fids, merged.columns["geom__x"]))
    assert [pos[f] for f in cold_fids] == [x for x, _ in up["geom"]]
