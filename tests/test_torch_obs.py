"""PyTorch port vs the JAX package: breakers, device health, SLO burn,
utilization, the prometheus text and the ``/metrics`` / ``/healthz`` /
debug endpoints.

* The circuit breaker's state machine (``tests/test_resilience.py``) on an
  injected clock: the same transitions and fences in both packages, and
  ``guarded_root_io`` charging on transient ``OSError`` only.
* Device health for one device: breaker-driven ``broken``, cordon by API
  and by ``geomesa.mesh.cordon``, equal snapshots and summaries, and the
  ``device.health.<id>`` gauge.
* SLO burn on injected histograms and an injected clock: equal burn rates,
  ``hot`` flags and ``slo.breaker.<name>`` gauges.
* Utilization on an injected clock: equal busy fractions and snapshots,
  and through the same calls on the same stores one interval per dispatch
  in both packages, with ``device_ms.0`` in the trace ledger where the
  reference's is.
* ``prometheus()`` after the same calls on cleared registries: the same
  lines in the same order, less the values of time metrics and the
  reference's lines of what the port has not yet (its ``query.density`` /
  ``query.scan`` / ``query.stats`` op timers and the serving scheduler's
  ``serving.*`` counters).
* The endpoints (``tests/test_tracing.py``'s ``test_obs_endpoints`` and
  ``test_healthz_degraded_when_breaker_open``) through ``obs.handle`` and
  one ``obs.serve`` on 127.0.0.1: equal status codes and payload keys, 503
  while a non-device breaker is open; the fleet routes answer as the
  reference's with no router.
* The device probe: a probe that hangs reports ``unreachable`` after its
  timeout, and a host with no card reports ``unreachable``, never the CPU.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import obs as jobs
from geomesa_tpu import resilience as jres
from geomesa_tpu import slo as jslo
from geomesa_tpu import tracing as jtracing
from geomesa_tpu import utilization as jutil
from geomesa_tpu.parallel import health as jhealth
from geomesa_tpu_torch import GeoDataset, config, metrics, obs, resilience, slo, tracing
from geomesa_tpu_torch import utilization
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import registry as kreg
from geomesa_tpu_torch.parallel import health

BBOX = "BBOX(geom, -100, 30, -80, 45)"

PORT = dict(config=config, metrics=metrics, res=resilience, slo=slo, util=utilization,
            health=health, obs=obs, tracing=tracing)
REF = dict(config=jconfig, metrics=jmetrics, res=jres, slo=jslo, util=jutil,
           health=jhealth, obs=jobs, tracing=jtracing)
PKGS = (PORT, REF)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def isolated():
    for p in PKGS:
        p["res"].reset_breakers()
        p["health"].reset()
        p["slo"].reset()
        p["util"].reset()
    yield
    for p in PKGS:
        p["res"].reset_breakers()
        p["health"].reset()
        p["slo"].reset()
        p["util"].reset()


@pytest.fixture(scope="module")
def knobs():
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


def _data(n, seed=5):
    rng = np.random.default_rng(seed)
    lo, hi = parse_iso_ms("2020-01-01"), parse_iso_ms("2020-03-01")
    return {
        "name": list(rng.choice(np.array(["a", "b"], object), n)),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"),
    }


def _ds(pkg, n=2000, spec="name:String,weight:Float,dtg:Date,*geom:Point"):
    if pkg is PORT:
        ds = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    else:
        ds = JGeoDataset(n_shards=2)
    ds.create_schema("t", spec)
    ds.insert("t", _data(n), fids=np.arange(n).astype(str))
    ds.flush("t")
    return ds


@pytest.fixture(scope="module")
def pair(knobs):
    return _ds(REF), _ds(PORT)


# -- circuit breakers ---------------------------------------------------------------------
def _drive_breaker(res):
    """The reference's breaker scenarios; the list of observed states and
    fences."""
    out = []
    clock = [0.0]
    Breaker, Open = res.CircuitBreaker, res.CircuitOpenError

    def allow(b):
        try:
            b.allow()
            return "allowed"
        except Open as e:
            return f"fenced {e.retry_after_s:.3f}"

    b = Breaker("t", threshold=3, reset_ms=1000, clock=lambda: clock[0])
    b.record_failure()
    b.record_failure()
    out.append(allow(b))
    b.record_failure()
    out += [allow(b), b.state]
    clock[0] = 1.5
    out += [b.state, allow(b)]
    b.record_failure()
    out.append(allow(b))
    clock[0] = 3.0
    out.append(allow(b))
    b.record_success()
    out.append(b.state)
    # one trial in flight fences the rest
    clock[0] = 0.0
    b1 = Breaker("t1", threshold=1, reset_ms=1000, clock=lambda: clock[0])
    b1.record_failure()
    clock[0] = 1.5
    out += [b1.state, allow(b1), allow(b1)]
    b1.record_success()
    out += [b1.state, allow(b1), allow(b1)]
    # a superseded trial's late success does not close the circuit
    clock[0] = 0.0
    b4 = Breaker("t4", threshold=1, reset_ms=1000, clock=lambda: clock[0])
    b4.record_failure()
    clock[0] = 1.5
    t = threading.Thread(target=b4.allow)
    t.start()
    t.join()
    clock[0] = 2.6
    out.append(allow(b4))
    t = threading.Thread(target=b4.record_success)
    t.start()
    t.join()
    out.append(b4.state)
    b4.record_success()
    out.append(b4.state)
    # a stuck trial does not wedge half-open
    clock[0] = 0.0
    b3 = Breaker("t3", threshold=1, reset_ms=1000, clock=lambda: clock[0])
    b3.record_failure()
    clock[0] = 1.5
    out += [allow(b3), allow(b3)]
    clock[0] = 2.6
    out.append(allow(b3))
    b3.record_success()
    out.append(b3.state)
    # trip forces open whatever the count
    b5 = Breaker("t5", threshold=9, reset_ms=1000, clock=lambda: clock[0])
    b5.trip()
    out += [b5.state, allow(b5)]
    return out


def test_breaker_state_machine_equals_the_reference():
    got = _drive_breaker(resilience)
    assert got == _drive_breaker(jres)
    assert got[:5] == ["allowed", "fenced 1.000", "open", "half-open", "allowed"]


def test_breaker_registry_and_knobs():
    for p in PKGS:
        cfg, res = p["config"], p["res"]
        with cfg.BREAKER_THRESHOLD.scoped("2"), cfg.BREAKER_RESET_MS.scoped("500"):
            b = res.breaker("x")
        assert (b.threshold, b.reset_ms) == (2, 500.0)
        assert res.breaker("x") is b
        b.record_failure()
        b.record_failure()
        assert res.breaker_states() == {"x": "open"}
        res.reset_breakers()
        assert res.breaker_states() == {}


def test_guarded_root_io(tmp_path):
    got = []
    for p in PKGS:
        res = p["res"]
        root = str(tmp_path / "root")
        seen = []

        def run(fn):
            try:
                seen.append(("ok", res.guarded_root_io(root, fn)))
            except res.CircuitOpenError:
                seen.append(("fenced",))
            except OSError as e:
                seen.append((type(e).__name__,))

        def missing():
            raise FileNotFoundError("no such file")

        def flaky():
            raise OSError(5, "I/O error")

        with p["config"].BREAKER_THRESHOLD.scoped("2"):
            run(lambda: 7)
            for _ in range(3):
                run(missing)  # never charges
            run(flaky)
            run(lambda: 8)  # success resets
            run(flaky)
            run(flaky)  # opens
            run(lambda: 9)
        seen.append(sorted(res.breaker_states().items()))
        got.append(seen)
    assert got[0] == got[1]
    assert got[0][-2] == ("fenced",)


# -- device health ---------------------------------------------------------------------
def _drive_health(p):
    cfg, reg = p["config"], p["health"].registry()
    with cfg.DEVICE_BREAKER_THRESHOLD.scoped("2"):
        out = [reg.state(0), reg.summary(1)]
        reg.record_failure(0, RuntimeError("launch failed"))
        out += [reg.state(0)]
        reg.record_failure(0, RuntimeError("launch failed"))
    out += [reg.state(0), reg.summary(1), reg.snapshot()]
    p["res"].reset_breakers()
    reg.record_success(0)
    out.append(reg.state(0))
    reg.cordon(0, reason="maintenance")
    out += [reg.state(0), reg.cordon_reason(0), reg.summary(1), reg.snapshot()]
    out += [reg.uncordon(0), reg.uncordon(0), reg.state(0)]
    with cfg.MESH_CORDON.scoped("0, x"):
        out += [reg.state(0), reg.cordon_reason(0), reg.snapshot(), reg.summary(1)]
    out.append(p["metrics"].registry().gauge("device.health.0").value)
    return out


def test_device_health_equals_the_reference():
    got = _drive_health(PORT)
    assert got == _drive_health(REF)
    assert got[0] == "ok" and "broken" in got
    assert got[-1] == 1.0


# -- SLO burn ----------------------------------------------------------------------------
def _drive_slo(p):
    cfg, met, mod = p["config"], p["metrics"], p["slo"]
    clock = [1000.0]
    mod._clock = lambda: clock[0]
    try:
        met.registry().clear()
        hist = met.registry().histogram("trace.count")
        prop = cfg.SystemProperty("geomesa.slo.count.p99.ms")
        out = []
        with prop.scoped("50"):
            mon = mod.monitor()
            out.append(mon.status())
            for i in range(200):
                hist.observe(0.2 if i % 10 == 0 else 0.01)  # 10% over 50 ms
            clock[0] += 10
            mon.evaluate(force=True)
            out.append(mon.status())
            clock[0] += 400  # past the fast window: that burn ages out
            for i in range(100):
                hist.observe(0.01)
            mon.evaluate(force=True)
            out.append(mon.status())
            out.append(met.registry().gauge("slo.burn.count").value)
            p["res"].breaker("sink", threshold=1).record_failure()
            mod.sync_breaker_gauges()
            out.append(met.registry().gauge("slo.breaker.sink").value)
        cfg._REGISTRY.pop(prop.name, None)
        return out
    finally:
        mod._clock = time.monotonic
        met.registry().clear()


def test_slo_burn_equals_the_reference():
    got = _drive_slo(PORT)
    assert got == _drive_slo(REF)
    # 10% of the window over target against a 1% budget: burn 10
    assert got[1]["count"]["fast_burn"] == 10.0 and got[1]["count"]["slow_burn"] == 10.0
    with config.SLO_BURN_THRESHOLD.scoped("5"), jconfig.SLO_BURN_THRESHOLD.scoped("5"):
        assert _drive_slo(PORT)[1] == _drive_slo(REF)[1]
    assert not got[1]["count"]["hot"] and not got[2]["count"]["hot"]
    assert got[-1] == 1.0


# -- utilization --------------------------------------------------------------------------
def _drive_util(p):
    mod = p["util"]
    clock = [100.0]
    mod._clock = lambda: clock[0]
    try:
        with p["config"].DEVICE_BUSY_WINDOW.scoped("10"):
            mod.record_device(0, 2.0)
            clock[0] += 1
            mod.record_device(0, 1.0)
            mod.record_slot(3, 0.5)
            mod.record_wait(0.25)
            out = [mod.snapshot()]
            clock[0] += 9.5  # the first interval ages out of the window
            out.append(mod.snapshot())
            out.append(p["metrics"].registry().gauge("device.busy.0").value)
        return out
    finally:
        mod._clock = time.monotonic


def test_utilization_equals_the_reference():
    got = _drive_util(PORT)
    assert got == _drive_util(REF)
    assert got[0]["devices"]["0"] == {"busy_s": 3.0, "busy_fraction": 0.3, "intervals": 2}


CALLS = {
    "count": lambda ds: ds.count("t", BBOX),
    "density": lambda ds: ds.density("t", BBOX, width=16, height=16),
    "stats": lambda ds: ds.stats("t", "Count();MinMax(weight)", BBOX),
    "query": lambda ds: ds.query("t", BBOX),
    "knn": lambda ds: ds.knn("t", -90.0, 38.0, k=3),
    "count_batch": lambda ds: ds.count_batch("t", [BBOX, "BBOX(geom, -110, 28, -90, 40)"]),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_one_busy_interval_per_dispatch(pair, call):
    got = []
    for ds, p in zip(pair, (REF, PORT)):
        p["util"].reset()
        d0 = p["metrics"].registry().counter("exec.device.dispatch").value
        with p["config"].TRACE_ENABLED.scoped("true"):
            CALLS[call](ds)
        tr = p["tracing"].last_trace()
        dispatches = p["metrics"].registry().counter("exec.device.dispatch").value - d0
        snap = p["util"].snapshot()["devices"]
        got.append((dispatches, snap.get("0", {}).get("intervals", 0),
                    sorted(k for k in tr.cost if k.startswith("device_ms."))))
    assert got[0] == got[1]
    assert got[1][0] == got[1][1] >= 1 and got[1][2] == ["device_ms.0"]


def test_cuda_event_pairs_resolve_without_a_sync(monkeypatch):
    """On a CUDA device ``device_busy`` keeps an event pair pending,
    ``extend_last`` moves its end past the scan's host copy, and
    ``resolve_pending`` records only completed pairs, with their elapsed
    time, into the trace they were recorded under (fake events here: the
    host has no card)."""
    class FakeEvent:
        t = [0.0]

        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at, self.done = None, False

        def record(self, stream=None):
            FakeEvent.t[0] += 2.5
            self.at = FakeEvent.t[0]

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return other.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    dev = torch.device("cuda", 0)
    with config.TRACE_ENABLED.scoped("true"):
        with tracing.start("count") as root:
            with utilization.device_busy(dev):
                pass
            assert utilization.pending() == 1
            assert utilization.resolve_pending() == 0  # still in flight
            # the scan's host copy: the pair now ends after it
            utilization.extend_last(dev)
            utilization.extend_last(dev)  # once per pair
            utilization._pending[0][2].done = True
            assert utilization.resolve_pending() == 1
    assert utilization.pending() == 0
    assert root.trace.cost["device_ms.0"] == pytest.approx(5.0)
    assert utilization.snapshot()["devices"]["0"]["intervals"] == 1


# -- the prometheus text ------------------------------------------------------------------
#: metrics whose values are times (their lines compare by name only)
_TIME = re.compile(r"(_seconds|_seconds_total|_seconds_max|_sum|device_busy_\d+|"
                   r"slo_burn_\w+)(\{[^}]*\})?$")


#: the reference's metrics of layers the port has not yet
_NOT_PORTED = re.compile(r"^geomesa_(query_(density|scan|stats)|serving)_")


def _prom_shape(text):
    out = []
    for line in text.splitlines():
        name, _, value = line.rpartition(" ")
        if _NOT_PORTED.match(name):
            continue
        if _TIME.search(name) or "_seconds_bucket" in name or "trace_" in name \
                and "_bucket" in name:
            value = "<t>"
        out.append((name, value))
    return out


def test_prometheus_text_equals_the_reference(knobs):
    texts = []
    for p in (REF, PORT):
        ds = _ds(p, n=1500)
        p["metrics"].registry().clear()
        p["util"].reset()
        with p["config"].TRACE_ENABLED.scoped("true"):
            for name in ("count", "density", "count"):
                CALLS[name](ds)
        texts.append(p["metrics"].registry().prometheus())
    ref, port = (_prom_shape(t) for t in texts)
    assert port == ref
    names = [n for n, _ in port]
    assert "geomesa_kernel_recompiles" in names and "geomesa_device_busy_0" in names
    assert any(n.startswith("geomesa_trace_count_seconds_bucket") for n in names)


# -- the endpoints -------------------------------------------------------------------------
def _keys(body):
    return sorted(json.loads(body))


def test_endpoint_status_and_payload_keys(pair):
    j, p = pair
    for ds in pair:
        ds.count("t", BBOX)
    routes = ["/metrics", "/healthz", "/debug/queries?n=5", "/debug/devices",
              "/debug/heat", "/debug/heat?top=x", "/debug/queries?n=abc",
              "/debug/fleet", "/metrics/fleet", "/healthz/fleet", "/nope"]
    for route in routes:
        jr = jobs.handle(route, j)
        pr = obs.handle(route, p)
        if jr is None:
            assert pr is None, route
            continue
        assert pr[0] == jr[0] and pr[1] == jr[1], route
        if jr[1] == "application/json":
            # both carry the serving pool's digest ("pool") since the port
            # has the serving scheduler
            assert _keys(pr[2]) == _keys(jr[2]), route
    om = obs.handle("/metrics", p, accept="application/openmetrics-text")
    assert om[1] == obs.OPENMETRICS_CTYPE and om[2].decode().endswith("# EOF\n")
    h = json.loads(obs.handle("/healthz", p)[2])
    assert sorted(h["mesh"]) == ["broken", "cordoned", "total", "usable"]
    q = json.loads(obs.handle("/debug/queries?n=5", p)[2])
    assert q["queries"] and q["queries"][-1]["type_name"] == "t"


def test_healthz_503_while_a_breaker_is_open_then_200():
    for p in PKGS:
        res, o = p["res"], p["obs"]
        assert o.handle("/healthz")[0] == 200
        b = res.breaker("trace.otlp", threshold=1)
        b.record_failure()
        code, _, body = o.handle("/healthz")
        h = json.loads(body)
        assert code == 503 and h["status"] == "degraded" and not h["soft"]
        assert h["open_breakers"] == ["trace.otlp"] and "breaker_note" in h
        # a device breaker degrades softly
        res.reset_breakers()
        res.breaker("device:0", threshold=1).record_failure()
        code, _, body = o.handle("/healthz")
        assert code == 200 and json.loads(body)["soft"] is True
        res.reset_breakers()
        assert o.handle("/healthz")[0] == 200


def test_debug_queries_trace_lookup(pair):
    _, p = pair
    with config.TRACE_ENABLED.scoped("true"):
        p.count("t", BBOX)
    tid = tracing.last_trace().trace_id
    code, _, body = obs.handle(f"/debug/queries?trace={tid}", p)
    assert code == 200 and json.loads(body)["tree"]["name"] == "count"
    assert obs.handle("/debug/queries?trace=nope", p)[0] == 404


def test_obs_serve_round_trip(pair):
    _, p = pair
    p.count("t", BBOX)
    srv = obs.serve(p, port=0, background=True)
    try:
        port = srv.server_address[1]

        def get(path, **headers):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers)
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read().decode()

        code, ctype, text = get("/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert "geomesa_query_plan_count" in text
        assert "geomesa_kernel_recompile_alert" in text
        assert "_seconds_bucket" in text
        code, _, body = get("/healthz")
        h = json.loads(body)
        assert code == 200 and h["status"] == "ok" and "breakers" in h and "device" in h
        code, _, body = get("/debug/queries?n=5")
        d = json.loads(body)
        assert code == 200 and d["queries"][-1]["type_name"] == "t"
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/debug/queries?n=abc")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/nope")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


# -- the device probe -------------------------------------------------------------------------
def test_probe_timeout_reports_unreachable():
    release = threading.Event()
    t0 = time.perf_counter()
    out = obs._probe_devices(timeout_s=0.2, lister=lambda: release.wait(30) or [])
    release.set()
    assert time.perf_counter() - t0 < 5
    assert out["status"] == "unreachable" and "hung" in out["error"]
    ok = obs._probe_devices(timeout_s=2, lister=lambda: ["NVIDIA H100 80GB HBM3"])
    assert ok == {"status": "ok", "devices": ["NVIDIA H100 80GB HBM3"]}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a host with a card")
def test_no_card_reports_unreachable():
    out = obs._probe_devices(timeout_s=10)
    assert out["status"] == "unreachable" and "devices" not in out
    assert "CUDA" in out["error"]


def test_kernel_registry_alert_in_metrics_text():
    kreg.reset_alert()
    kreg.begin_query_window()
    assert "geomesa_kernel_recompile_alert 0.0" in obs.metrics_text()
