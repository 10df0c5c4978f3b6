"""PyTorch port vs the JAX package: the serving scheduler.

Both packages hold the same seeded rows in a flat point store (the JAX side
with its Pallas kernels in interpret mode, compaction forced and
``geomesa.mesh.devices`` 1). Each scenario runs through both schedulers:

* admission: a full queue rejects typed, an expired budget sheds with no
  dispatch, a budget that lapses in the queue sheds at dispatch, the
  estimated-wait shed, continuations past the bound, the inline shed and
  its ``shed`` trace class;
* fair share: a burst user cannot starve an interactive one (order from
  the ledger, asserted without sleeps);
* fusion: 8 identical counts are bit-identical to serial and to the JAX
  package's with at most 2 dispatches; distinct bbox counts, densities and
  stats, curve tiles, a mixed batch, a failing batch, the master switch;
  each member's own audit event, equal to the JAX package's less times;
* speculative ``count`` / ``density`` / ``stats`` with 0 dispatches;
* slot death at width 1: the stranded continuation fails typed and the
  slot respawns; 100 seeded kills in a row each get their respawn;
* ``/debug/queries``' users and serving, the queue-depth gauge.

Every wait has a timeout and every started scheduler stops in a
``finally``.
"""

import threading
import time
from dataclasses import asdict

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import obs as jobs
from geomesa_tpu import resilience as jres
from geomesa_tpu import tracing as jtracing
from geomesa_tpu import tracing_export as jexport
from geomesa_tpu.serving import FuseSpec as JFuseSpec
from geomesa_tpu.serving import QueryScheduler as JQueryScheduler
from geomesa_tpu.serving import fuse as jfuse
from geomesa_tpu_torch import GeoDataset, config, metrics, obs, resilience, tracing, tracing_export
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.parallel import devices as pdev
from geomesa_tpu_torch.serving import FuseSpec, QueryScheduler, fuse

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
N = 4000
ECQL = "BBOX(geom, -100, 30, -85, 42)"
BOXES = [(-110 + 3 * i, 28 + i, -95 + 2 * i, 40 + i) for i in range(8)]
TIMES = ("date", "plan_time_ms", "scan_time_ms")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (OpenMP workers spin under a
    parallel test runner)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=N, seed=17):
    rng = np.random.default_rng(seed)
    return {
        "name": [f"actor{i % 5}" for i in range(n)],
        "weight": rng.uniform(0, 10, n),
        "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-15"),
                            n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
    }


@pytest.fixture(scope="module")
def pair():
    """(JAX, port) datasets with schema ``t`` of the same rows, and ``s``
    (300 points) to join against."""
    data = _data()
    sdata = _data(300, seed=3)
    fids = np.arange(N).astype(str)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            out = []
            for ds in (JGeoDataset(n_shards=4),
                       GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                                  compact_fraction=2.0)):
                ds.create_schema("t", SPEC)
                ds.insert("t", data, fids=fids)
                ds.flush("t")
                ds.create_schema("s", SPEC)
                ds.insert("s", sdata, fids=np.arange(300).astype(str))
                ds.flush("s")
                ds.count("t", ECQL)  # warm: plan and scan
                out.append(ds)
            yield out
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


def _pkg(ds):
    """(config, metrics, resilience, tracing, fuse, FuseSpec) of ``ds``'s
    package."""
    if isinstance(ds, GeoDataset):
        return config, metrics, resilience, tracing, fuse, FuseSpec
    return jconfig, jmetrics, jres, jtracing, jfuse, JFuseSpec


@pytest.fixture()
def scheds(pair):
    """Both datasets' schedulers started, stopped after the test."""
    out = []
    try:
        for ds in pair:
            out.append(ds.serving.start())
        yield out
    finally:
        for s in out:
            s.stop()


def _dispatches(ds) -> int:
    return _pkg(ds)[1].registry().counter(_pkg(ds)[1].EXEC_DEVICE_DISPATCH).value


def _ctr(ds, name) -> int:
    return _pkg(ds)[1].registry().counter(name).value


def _stall(sched, timeout=10.0):
    """Occupy the dispatch thread so later submissions queue; returns once
    the stall ticket runs."""
    gate = threading.Event()
    started = threading.Event()

    def fn():
        started.set()
        return gate.wait(timeout)

    fut = sched.submit(fn, user="stall", op="stall")
    assert started.wait(10), "stall ticket never dispatched"
    return gate, fut


def _run_stalled(sched, submit):
    """Submit through ``submit(sched)`` behind a stall, release it, and
    return the futures' results."""
    gate, fut = _stall(sched)
    try:
        futs = submit(sched)
    finally:
        gate.set()
        fut.result(10)
    return [f.result(30) for f in futs]


def _norm(ev):
    d = asdict(ev)
    for k in TIMES:
        d.pop(k)
    h = dict(d["hints"])
    for k in ("trace_id", "fused_primary", "device_coarse_ms"):
        h.pop(k, None)
    path = h.pop("exec_path", None)
    if path:
        path = {k: "<route>" if k.startswith("kernel:") else v
                for k, v in path.items() if k != "density_kernel"}
        h["exec_path"] = path
    d["hints"] = h
    return d


def _new_events(ds, n0):
    return list(ds.audit.events)[n0:]


# -- admission -----------------------------------------------------------------------------------
def test_queue_full_rejects_typed_with_no_dispatch(pair, scheds):
    msgs = []
    for ds, s in zip(pair, scheds):
        res = _pkg(ds)[2]
        gate, fut = _stall(s)
        d0 = _dispatches(ds)
        try:
            with _pkg(ds)[0].SERVING_QUEUE_DEPTH.scoped(2):
                s.submit(lambda: 1, user="qf", op="x")
                s.submit(lambda: 2, user="qf", op="x")
                with pytest.raises(res.AdmissionRejectedError) as ei:
                    s.submit(lambda: 3, user="qf", op="x")
        finally:
            gate.set()
            fut.result(10)
        msgs.append((str(ei.value), ei.value.depth))
        assert _dispatches(ds) == d0
        assert ds.serving.user_rollups()["qf"]["rejected"] == 1
    assert msgs[1] == msgs[0]
    assert resilience.AdmissionRejectedError.code == "GM-OVERLOADED"


def test_expired_budget_sheds_before_any_device_work(pair, scheds):
    msgs = []
    for ds, s in zip(pair, scheds):
        d0 = _dispatches(ds)
        with pytest.raises(_pkg(ds)[2].DeadlineShedError) as ei:
            s.submit(lambda: ds.count("t", ECQL), user="exp", op="count", budget_s=0.0)
        msgs.append(str(ei.value))
        assert _dispatches(ds) == d0
        assert ds.serving.user_rollups()["exp"]["shed"] == 1
    assert msgs[1] == msgs[0]
    assert issubclass(resilience.DeadlineShedError, resilience.QueryTimeoutError)
    assert resilience.DeadlineShedError.code == "GM-SHED"


def test_budget_lapsing_in_queue_sheds_at_dispatch(pair, scheds):
    for ds, s in zip(pair, scheds):
        cfg = _pkg(ds)[0]
        gate, fut = _stall(s)
        ran = []
        try:
            with cfg.SERVING_SHED_ESTIMATE.scoped("false"):
                f = s.submit(lambda: ran.append(1), user="lapse", op="x", budget_s=0.02)
            # the budget lapses while the ticket waits behind the stall
            deadline = time.monotonic() + 0.05
            while time.monotonic() < deadline:
                time.sleep(0.005)
        finally:
            gate.set()
            fut.result(10)
        with pytest.raises(_pkg(ds)[2].DeadlineShedError, match="no device work"):
            f.result(10)
        assert ran == []


def test_estimated_wait_sheds_at_admission(pair, scheds):
    msgs = []
    for ds, s in zip(pair, scheds):
        s._ewma_all = 5.0  # recent queries "took 5 s"
        gate, fut = _stall(s)
        try:
            s.submit(lambda: 1, user="filler", op="x")  # queue depth > 0
            with pytest.raises(_pkg(ds)[2].DeadlineShedError) as ei:
                s.submit(lambda: 1, user="est", op="x", budget_s=0.5)
            msgs.append(str(ei.value)[:60])
        finally:
            gate.set()
            fut.result(10)
            s._ewma_all = None
    assert msgs[1] == msgs[0] and "estimated queue wait" in msgs[0]


def test_continuations_bypass_the_queue_bound(pair, scheds):
    for ds, s in zip(pair, scheds):
        gate, fut = _stall(s)
        try:
            with _pkg(ds)[0].SERVING_QUEUE_DEPTH.scoped(1):
                s.submit(lambda: 1, user="cb", op="x")
                f = s.submit(lambda: "chunk", user="cb", op="stream", continuation=True)
        finally:
            gate.set()
            fut.result(10)
        assert f.result(10) == "chunk"


def test_inline_admission_sheds_an_expired_deadline_as_a_shed_trace(pair):
    classes = []
    for ds in pair:
        cfg, _, res, tr, _, _ = _pkg(ds)
        exp = tracing_export if isinstance(ds, GeoDataset) else jexport
        d0 = _dispatches(ds)
        with cfg.TRACE_ENABLED.scoped("true"), res.deadline_scope(0.0):
            with pytest.raises(res.DeadlineShedError):
                ds.count("t", ECQL)
        assert _dispatches(ds) == d0
        t = tr.last_trace()
        classes.append((t.shed, t.error, exp.classify(t)))
    assert classes[1] == classes[0] == (True, "DeadlineShedError", "shed")


def test_query_batches_and_batches_admit(pair):
    for ds in pair:
        res = _pkg(ds)[2]
        d0 = _dispatches(ds)
        with res.deadline_scope(0.0):
            with pytest.raises(res.DeadlineShedError):
                ds.query_batches("t", ECQL)
            with pytest.raises(res.DeadlineShedError):
                ds.count_batch("t", [ECQL, "BBOX(geom, -90, 30, -80, 40)"])
            with pytest.raises(res.DeadlineShedError):
                ds.explain("t", ECQL)
        assert _dispatches(ds) == d0


# -- fair share ----------------------------------------------------------------------------------
def test_fair_share_prevents_burst_starvation(pair, scheds):
    for ds, s in zip(pair, scheds):
        done = []
        lock = threading.Lock()

        def work(tag):
            def fn():
                with lock:
                    done.append(tag)
                return tag
            return fn

        def submit(sched):
            futs = [sched.submit(work(f"A{i}"), user="burst", op="w") for i in range(6)]
            return futs + [sched.submit(work(f"B{i}"), user="interactive", op="w")
                           for i in range(2)]

        _run_stalled(s, submit)
        # FIFO would run both B ops after all six A ops; every executed op
        # adds attained service, so the idle user's ops interleave early
        assert done.index("B0") == 1, done
        assert done.index("B1") < done.index("A5"), done


def test_fair_share_off_is_fifo(pair, scheds, monkeypatch):
    # the dispatcher reads the knob on its own thread: set it process-wide
    monkeypatch.setenv("GEOMESA_SERVING_FAIR_SHARE", "false")
    for ds, s in zip(pair, scheds):
        done = []

        def submit(sched):
            futs = [sched.submit(lambda i=i: done.append(f"A{i}"), user="fifo-a", op="w")
                    for i in range(3)]
            return futs + [sched.submit(lambda i=i: done.append(f"B{i}"), user="fifo-b", op="w")
                           for i in range(2)]

        _run_stalled(s, submit)
        assert done == ["A0", "A1", "A2", "B0", "B1"]


# -- fusion --------------------------------------------------------------------------------------
def test_fused_identical_counts_bit_identical_with_two_dispatches(pair, scheds):
    out = []
    for ds, s in zip(pair, scheds):
        _, mets, _, _, fz, _ = _pkg(ds)
        serial = ds.count("t", ECQL)
        opts = {"ecql": ECQL}
        n0 = len(ds.audit.events)
        d0, f0 = _dispatches(ds), _ctr(ds, mets.SERVING_FUSED)

        def submit(sched):
            return [sched.submit(lambda: ds.count("t", ECQL), user=f"u{i % 3}", op="count",
                                 fuse=fz.make_spec(ds, "count", "t", opts),
                                 trace_id=f"member{i:011d}")
                    for i in range(8)]

        results = _run_stalled(s, submit)
        assert results == [serial] * 8
        assert all(type(r) is int for r in results)
        disp = _dispatches(ds) - d0
        assert disp <= 2, disp
        assert _ctr(ds, mets.SERVING_FUSED) - f0 == 8
        evs = _new_events(ds, n0)
        assert {e.hints.get("trace_id") for e in evs} == {f"member{i:011d}" for i in range(8)}
        out.append((results, disp, [_norm(e) for e in evs],
                    {u: r["fused"] for u, r in s.user_rollups().items() if u.startswith("u")}))
    assert out[1] == out[0]


def test_fused_distinct_bbox_counts_ride_one_batch(pair, scheds):
    out = []
    ecqls = [f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})" for b in BOXES]
    for ds, s in zip(pair, scheds):
        _, mets, _, _, fz, _ = _pkg(ds)
        serial = [ds.count("t", e) for e in ecqls]
        n0 = len(ds.audit.events)
        d0, fd0 = _dispatches(ds), _ctr(ds, mets.SERVING_FUSED_DISTINCT)

        def submit(sched):
            return [sched.submit(lambda e=e: ds.count("t", e), user="dist", op="count",
                                 fuse=fz.make_spec(ds, "count", "t", {"ecql": e}),
                                 trace_id=f"distinct{i:09d}")
                    for i, e in enumerate(ecqls)]

        results = _run_stalled(s, submit)
        assert results == serial
        assert _dispatches(ds) - d0 <= 2
        evs = _new_events(ds, n0)
        assert [e.hints["fused_member"] for e in evs] == list(range(8))
        assert all(e.hints["distinct"] and e.hints["fused_batch"] == 8 for e in evs)
        out.append((results, _ctr(ds, mets.SERVING_FUSED_DISTINCT) - fd0,
                    [_norm(e) for e in evs]))
    assert out[1] == out[0]
    assert out[0][1] == 8


def test_fused_distinct_densities_and_stats(pair, scheds):
    ecqls = [f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})" for b in BOXES[:5]]
    out = []
    for ds, s in zip(pair, scheds):
        fz = _pkg(ds)[4]
        sd = [ds.density("t", e, bbox=b, width=24, height=16) for e, b in zip(ecqls, BOXES)]
        ss = [ds.stats("t", "Count();MinMax(weight)", e).to_json() for e in ecqls]

        def submit(sched):
            futs = [sched.submit(lambda e=e, b=b: ds.density("t", e, bbox=b, width=24, height=16),
                                 user="dd", op="density",
                                 fuse=fz.make_spec(ds, "density", "t",
                                                   {"ecql": e, "bbox": list(b), "width": 24,
                                                    "height": 16}))
                    for e, b in zip(ecqls, BOXES)]
            futs += [sched.submit(lambda e=e: ds.stats("t", "Count();MinMax(weight)", e),
                                  user="ds", op="stats",
                                  fuse=fz.make_spec(ds, "stats", "t",
                                                    {"ecql": e, "stat": "Count();MinMax(weight)"}))
                     for e in ecqls]
            return futs

        res = _run_stalled(s, submit)
        grids, stats = res[:5], [r.to_json() for r in res[5:]]
        for g, g0 in zip(grids, sd):
            assert g.dtype == np.float32 and np.array_equal(g, g0)
        assert stats == ss
        out.append((grids, stats))
    for g, gj in zip(out[1][0], out[0][0]):
        assert np.array_equal(g, gj)
    assert out[1][1] == out[0][1]


def test_fused_members_own_their_results(pair, scheds):
    for ds, s in zip(pair, scheds):
        fz = _pkg(ds)[4]
        opts = {"ecql": ECQL, "width": 16, "height": 16, "bbox": [-120, 25, -70, 50]}

        def submit(sched):
            return [sched.submit(lambda: ds.density("t", ECQL, bbox=(-120, 25, -70, 50),
                                                    width=16, height=16),
                                 user="own", op="density",
                                 fuse=fz.make_spec(ds, "density", "t", opts))
                    for _ in range(3)]

        grids = _run_stalled(s, submit)
        ref = grids[2].copy()
        grids[1] *= 0  # a member mutating its grid never touches another's
        assert np.array_equal(grids[2], ref) and np.array_equal(grids[0], ref)
        assert grids[1] is not grids[2] and ref.any()


def test_fused_weighted_density_repeats(pair, scheds):
    out = []
    for ds, s in zip(pair, scheds):
        fz = _pkg(ds)[4]
        kw = dict(bbox=(-120, 25, -70, 50), width=16, height=16, weight="weight")
        serial = ds.density("t", ECQL, **kw)
        opts = {"ecql": ECQL, "width": 16, "height": 16, "bbox": [-120, 25, -70, 50],
                "weight": "weight"}

        def submit(sched):
            return [sched.submit(lambda: ds.density("t", ECQL, **kw), user="w", op="density",
                                 fuse=fz.make_spec(ds, "density", "t", opts))
                    for _ in range(4)]

        grids = _run_stalled(s, submit)
        for g in grids:
            assert np.array_equal(g, serial)
        out.append(serial)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-4)


def test_mixed_batch_degrades_to_per_query(pair, scheds):
    other = "INTERSECTS(geom, POLYGON((-100 30, -85 30, -92 42, -100 30)))"
    out = []
    for ds, s in zip(pair, scheds):
        fz = _pkg(ds)[4]
        n1, n2 = ds.count("t", ECQL), ds.count("t", other)

        def submit(sched):
            futs = []
            for i in range(6):
                e = ECQL if i % 2 == 0 else other
                futs.append(sched.submit(lambda e=e: ds.count("t", e), user="mix", op="count",
                                         fuse=fz.make_spec(ds, "count", "t", {"ecql": e})))
            return futs

        results = _run_stalled(s, submit)
        assert results == [n1, n2] * 3
        out.append(results)
    assert out[1] == out[0]


def test_fused_density_curve_tiles_bit_identical(pair, scheds):
    bboxes = [(-110, 30, -100, 40), (-100, 30, -90, 40), (-95, 35, -80, 45), (-105, 28, -85, 38)]
    out = []
    for ds, s in zip(pair, scheds):
        fz = _pkg(ds)[4]
        serial = [ds.density_curve("t", ECQL, level=6, bbox=b) for b in bboxes]
        d0 = _dispatches(ds)

        def submit(sched):
            return [sched.submit(lambda b=b: ds.density_curve("t", ECQL, level=6, bbox=b),
                                 user="tiles", op="density_curve",
                                 fuse=fz.make_spec(ds, "density_curve", "t",
                                                   {"ecql": ECQL, "level": 6, "bbox": list(b)}))
                    for b in bboxes]

        res = _run_stalled(s, submit)
        assert _dispatches(ds) - d0 <= 2
        for (g, sn), (gs, ss) in zip(res, serial):
            assert np.array_equal(g, gs) and sn == ss
        out.append(res)
    for (g, sn), (gj, sj) in zip(out[1], out[0]):
        assert np.array_equal(g, gj) and tuple(sn) == tuple(sj)


def test_fused_join_count_repeats(pair, scheds):
    out = []
    for ds, s in zip(pair, scheds):
        fz = _pkg(ds)[4]
        kw = dict(predicate="bbox", dx=0.3, dy=0.3)
        serial = ds.join_count("t", "s", left_query=ECQL, **kw)
        opts = {"ecql": ECQL, "right": "s", **kw}
        d0 = _dispatches(ds)

        def submit(sched):
            return [sched.submit(lambda: ds.join_count("t", "s", left_query=ECQL, **kw),
                                 user="jc", op="join_count",
                                 fuse=fz.make_spec(ds, "join_count", "t", opts))
                    for _ in range(4)]

        results = _run_stalled(s, submit)
        assert results == [serial] * 4
        out.append((results, _dispatches(ds) - d0))
    assert out[1] == out[0]


def test_fusion_master_switch(pair, scheds):
    for ds, s in zip(pair, scheds):
        cfg, mets, _, _, fz, _ = _pkg(ds)
        f0 = _ctr(ds, mets.SERVING_FUSED)

        def submit(sched):
            with cfg.SERVING_FUSION.scoped("false"):
                return [sched.submit(lambda: ds.count("t", ECQL), user="sw", op="count",
                                     fuse=fz.make_spec(ds, "count", "t", {"ecql": ECQL}))
                        for _ in range(3)]

        assert len(set(_run_stalled(s, submit))) == 1
        assert _ctr(ds, mets.SERVING_FUSED) == f0


def test_failing_batch_falls_back_to_serial(pair, scheds):
    for ds, s in zip(pair, scheds):
        spec_cls = _pkg(ds)[5]
        calls = []

        def boom(tickets):
            raise RuntimeError("batch exploded")

        def submit(sched):
            return [sched.submit(lambda i=i: calls.append(i) or i, user="fb", op="x",
                                 fuse=spec_cls(key=("k",), batch=boom))
                    for i in range(3)]

        assert _run_stalled(s, submit) == [0, 1, 2]
        assert calls == [0, 1, 2]


def test_fused_member_error_reaches_its_member_alone(pair, scheds):
    for ds, s in zip(pair, scheds):
        spec_cls = _pkg(ds)[5]
        fme = (fuse.FusedMemberError if isinstance(ds, GeoDataset)
               else jfuse.FusedMemberError)

        def batch(tickets):
            return [1, fme(ValueError("member 1 failed")), 3]

        gate, fut = _stall(s)
        try:
            futs = [s.submit(lambda: 0, user="me", op="x", fuse=spec_cls(key=("m",), batch=batch))
                    for _ in range(3)]
        finally:
            gate.set()
            fut.result(10)
        assert futs[0].result(10) == 1 and futs[2].result(10) == 3
        with pytest.raises(ValueError, match="member 1 failed"):
            futs[1].result(10)


def test_fuse_keys_equal_the_reference(pair):
    j, p = pair
    cases = [
        ("count", {"ecql": ECQL}),
        ("count", {"ecql": ECQL, "exact": False}),
        ("count", {"ecql": ECQL, "sampling": 10}),
        ("count", {"ecql": ECQL, "max_features": 5}),
        ("count", {"ecql": ECQL, "unknown": 1}),
        ("density", {"ecql": ECQL, "bbox": [0, 0, 1, 1], "width": 8, "height": 8}),
        ("density", {"ecql": ECQL, "weight": "weight"}),
        ("density_curve", {"ecql": ECQL, "level": 6, "bbox": [0, 0, 1, 1]}),
        ("stats", {"ecql": "INCLUDE", "stat": "Count()"}),
        ("join_count", {"ecql": ECQL, "right": "s", "predicate": "bbox", "dx": 0.1}),
        ("query", {"ecql": ECQL}),
    ]
    for op, opts in cases:
        assert fuse.fuse_key(op, "t", opts, ds=p) == jfuse.fuse_key(op, "t", opts, ds=j), op
        assert fuse.fuse_key(op, "t", opts) == jfuse.fuse_key(op, "t", opts), op


# -- speculative answers -------------------------------------------------------------------------
@pytest.mark.parametrize("cache", ["false", "true"])
def test_speculative_answers_equal_the_reference(pair, cache):
    out = []
    for ds in pair:
        cfg, mets, res, _, _, _ = _pkg(ds)
        with cfg.CACHE_ENABLED.scoped(cache):
            if cache == "true":
                ds.cache.store.invalidate()
                ds.count("t", ECQL)  # resident cells for the density's cover
            n0 = len(ds.audit.events)
            d0, s0 = _dispatches(ds), _ctr(ds, mets.SERVING_SPECULATIVE)
            with res.deadline_scope(0.0):
                c = ds.count("t", ECQL, speculative_ok=True)
                g = ds.density("t", ECQL, bbox=(-120, 25, -70, 50), width=32, height=16,
                               speculative_ok=True)
                st = ds.stats("t", "Count();MinMax(dtg);MinMax(weight)", ECQL,
                              speculative_ok=True)
                sa = ds.stats("t", "Count()", "INCLUDE", speculative_ok=True)
                with pytest.raises(res.DeadlineShedError, match="weighted"):
                    ds.density("t", ECQL, weight="weight", speculative_ok=True)
                with pytest.raises(res.DeadlineShedError):
                    ds.count("t", ECQL)  # not opted in
            assert _dispatches(ds) == d0
            assert _ctr(ds, mets.SERVING_SPECULATIVE) - s0 == 4
            evs = _new_events(ds, n0)
            assert all(e.hints["speculative"] and e.hints["shed"] for e in evs)
            out.append((c, g, st.to_json(), sa.to_json(), [_norm(e) for e in evs]))
    assert out[1][0] == out[0][0]
    assert np.array_equal(out[1][1], out[0][1])
    assert out[1][2:] == out[0][2:]


def test_speculative_fallback_through_the_queue(pair, scheds):
    for ds, s in zip(pair, scheds):
        est = ds.count("t", ECQL, exact=False)
        f = s.submit(lambda: ds.count("t", ECQL), user="spec", op="count", budget_s=0.0,
                     speculative=lambda: ds.count("t", ECQL, exact=False))
        assert f.result(10) == est
        assert s.user_rollups()["spec"]["shed"] == 1


# -- slot death ----------------------------------------------------------------------------------
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_slot_death_strands_the_pinned_continuation_typed(pair):
    out = []
    for ds in pair:
        cfg, mets, res, tr, _, _ = _pkg(ds)
        exp = tracing_export if isinstance(ds, GeoDataset) else jexport
        root = tr.start("stream", trace_id="chaostrace000017", force=True)
        trace = root.trace
        died0 = _ctr(ds, mets.SERVING_SLOT_DIED)
        with cfg.FAULT_INJECTION.scoped("true"), res.inject_faults(seed=17) as inj:
            s = ds.serving.start()
            try:
                with s._cv:
                    gen0, resp0 = s._slot_gen[0], s._respawns
                gate, fut = _stall(s)
                cont = s.submit(lambda: "never runs", user="stream", op="chunk",
                                continuation=True, slot=0, slot_gen=gen0,
                                trace_id="chaostrace000017")
                # the slot dies at its next loop iteration, after the stall
                inj.fail("serving.slot.loop", SystemExit("chaos kill"), times=1)
                gate.set()
                assert fut.result(10) is True
                with pytest.raises(res.DeviceDrainError, match="re-open") as ei:
                    cont.result(30)
                with s._cv:
                    assert s._cv.wait_for(lambda: s._respawns > resp0 and 0 in s._threads
                                          and s._threads[0].is_alive(), 10)
                    gen1 = s._slot_gen[0]
                assert gen1 == gen0 + 1
                # the stream's old generation must re-open; the new one serves
                with pytest.raises(res.DeviceDrainError, match="re-open"):
                    s.submit(lambda: 1, user="stream", op="chunk", continuation=True,
                             slot=0, slot_gen=gen0)
                assert s.submit(lambda: "ok", user="w", op="x").result(10) == "ok"
            finally:
                s.stop()
        root.finish()
        assert trace.slot_died is True and exp.classify(trace) == "slot_died"
        assert "serving.slot.died" in [c.name for c in trace.root.children]
        out.append((str(ei.value), _ctr(ds, mets.SERVING_SLOT_DIED) - died0,
                    s.snapshot()["respawns"] >= 1))
    assert out[1] == out[0]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_repeated_slot_kills_each_respawn():
    """100 seeded kills of the one dispatch slot: every kill gets its
    respawn (awaited on the scheduler's condition, not polled), queued
    queries survive each death, and each stranded continuation fails
    typed. This is the race the reference's supervisor can lose."""
    s = QueryScheduler()
    rng = np.random.default_rng(17)
    died0 = metrics.registry().counter(metrics.SERVING_SLOT_DIED).value
    with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults(seed=17) as inj:
        s.start()
        try:
            for i in range(100):
                with s._cv:
                    gen = s._slot_gen[0]
                pinned = None
                if rng.random() < 0.3:
                    # a stream chunk of this generation, queued behind a stall
                    gate, fut = _stall(s)
                    pinned = s.submit(lambda: "chunk", user="stream", op="chunk",
                                      continuation=True, slot=0, slot_gen=gen)
                    inj.fail("serving.slot.loop", SystemExit(f"kill {i}"), times=1)
                    f = s.submit(lambda i=i: i, user="q", op="x")
                    gate.set()
                    assert fut.result(10) is True
                else:
                    inj.fail("serving.slot.loop", SystemExit(f"kill {i}"), times=1)
                    f = s.submit(lambda i=i: i, user="q", op="x")
                assert s.wait_respawns(i + 1, timeout=10), f"respawn {i + 1} never came"
                assert f.result(10) == i
                if pinned is not None:
                    with pytest.raises(resilience.DeviceDrainError):
                        pinned.result(10)
                with s._cv:
                    assert s._slot_gen[0] == gen + 1
            assert len(inj.fired) == 100
            assert s.snapshot()["respawns"] == 100 and s.snapshot()["executors"] == 1
        finally:
            s.stop()
    assert metrics.registry().counter(metrics.SERVING_SLOT_DIED).value - died0 == 100
    assert not s._threads


def test_pool_clamps_to_one_card():
    assert pdev.healthy_device_count() == 1
    s = QueryScheduler()
    with config.SERVING_EXECUTORS.scoped("4"):
        s.start()
    try:
        assert s.snapshot()["executors"] == 1 and pdev.pool_width() == 1
        assert s.submit(lambda: s.current_slot(), user="c", op="x").result(10) == 0
    finally:
        s.stop()
    assert pdev.pool_width() == 1 and not s._threads


# -- placement, observability --------------------------------------------------------------------
def test_placement_residency_ranking():
    for cls in (JQueryScheduler, QueryScheduler):
        s = cls()
        s._threads = {0: object(), 1: object(), 2: object()}
        s._schema_heat["pts"] = {2: 10.0, 1: 20.0}
        assert s._rank_slot_locked("pts", 0) == 1
        s.set_residency_probe(lambda schema, slot: {2: 1 << 20}.get(slot, 0))
        assert s._rank_slot_locked("pts", 0) == 2
        assert s._rank_slot_locked("pts", 2) is None
        s._threads = {0: object(), 1: object()}
        assert s._rank_slot_locked("pts", 0) == 1

        def boom(schema, slot):
            raise RuntimeError("torn cache walk")

        s.set_residency_probe(boom)
        assert s._rank_slot_locked("pts", 0) == 1
        assert s._rank_slot_locked("other", 0) is None


def test_dataset_wires_its_residency_probe(pair):
    _, p = pair
    assert p.serving._residency_probe is not None
    p.count("t", ECQL)
    assert p._residency_bytes("t", 0) > 0
    assert p._residency_bytes("t", 1) == 0 and p._residency_bytes("nope", 0) == 0


def test_debug_queries_users_and_serving(pair):
    out = []
    for ds in pair:
        o = obs if isinstance(ds, GeoDataset) else jobs
        cfg = _pkg(ds)[0]
        with cfg.USER.scoped("dbg-user"):
            ds.count("t", ECQL)
            ds.density("t", ECQL, width=8, height=8)
        q = o.debug_queries(ds, 10)
        assert q["users"] == ds.serving.user_rollups()
        roll = q["users"]["dbg-user"]
        assert q["queries"][-1]["user"] == "dbg-user"
        sub = o.debug_queries(ds, 10, user="dbg-user")
        assert list(sub["users"]) == ["dbg-user"]
        out.append(({k: roll[k] for k in ("submitted", "completed", "shed", "rejected",
                                           "errors", "fused", "weight")},
                    sorted(q["serving"]), sorted(o.debug_devices(ds)["pool"])))
    assert out[1] == out[0]
    assert out[0][0]["completed"] == 2


def test_queue_depth_gauge_and_serving_metrics(pair, scheds):
    for ds, s in zip(pair, scheds):
        spec_cls = _pkg(ds)[5]
        gate, fut = _stall(s)
        try:
            f1 = s.submit(lambda: 1, user="m", op="x",
                          fuse=spec_cls(key=("prom",), batch=lambda ts: [1] * len(ts)))
            f2 = s.submit(lambda: 1, user="m", op="x",
                          fuse=spec_cls(key=("prom",), batch=lambda ts: [1] * len(ts)))
            text = _pkg(ds)[1].registry().prometheus()
            assert "geomesa_serving_queue_depth 2" in text
        finally:
            gate.set()
            fut.result(10)
        assert f1.result(10) == 1 and f2.result(10) == 1
        text = _pkg(ds)[1].registry().prometheus()
        assert "geomesa_serving_admitted" in text
        assert "geomesa_serving_queue_wait_seconds_bucket" in text
        assert "geomesa_serving_fusion_batch_bucket" in text
        assert "geomesa_serving_fusion_batch_seconds" not in text
    assert "geomesa_serving_queue_depth" in obs.handle("/metrics", pair[1])[2].decode()


def test_user_weight_resolution():
    assert config.USER_WEIGHT_PREFIX == jconfig.USER_WEIGHT_PREFIX
    for v in (None, "4", "0", "-1", "x"):
        for cfg in (config, jconfig):
            if v is None:
                cfg._overrides().pop(cfg.USER_WEIGHT_PREFIX + "alice", None)
            else:
                cfg._overrides()[cfg.USER_WEIGHT_PREFIX + "alice"] = v
        try:
            assert config.user_weight("alice") == jconfig.user_weight("alice")
        finally:
            for cfg in (config, jconfig):
                cfg._overrides().pop(cfg.USER_WEIGHT_PREFIX + "alice", None)
    assert config.user_weight("nobody") == 1.0
