"""PyTorch port vs the JAX package: trace export with tail sampling.

The scenarios of ``tests/test_trace_export.py`` through both packages:

* ``classify`` and the seeded ``sampled_in`` decide alike over 1,000 trace
  ids at three rates and two seeds, and on traces carrying each flag;
* the OTLP batches the file sink writes for the same traced calls on the
  same seeded stores are equal less ids and times: span names, parent
  links, attribute keys and values, keep reasons and cost attributes
  (``device_ms`` values masked);
* the always-keep classes ignore the sample rate, sampled-out traces are
  counted once, a burst larger than one batch drains, a wedged sink drops
  the overflow without blocking the offering thread, injected sink faults
  retry and then open the ``trace.export.file`` breaker, and a late child
  that makes a trace slow exports it;
* a degraded partitioned count is kept at rate 0;
* the HTTP sink posts the same batch to a collector on 127.0.0.1.

The JAX side runs with its Pallas kernels in interpret mode, compaction
forced and ``geomesa.mesh.devices`` 1, as ``tests/test_torch_trace.py``.
"""

import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import geomesa_tpu as jpkg
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu import resilience as jresilience
from geomesa_tpu import tracing as jtracing
from geomesa_tpu import tracing_export as jexport
from geomesa_tpu_torch import GeoDataset, config, metrics, resilience, tracing
from geomesa_tpu_torch import tracing_export as export
from geomesa_tpu_torch.filter.ecql import parse_iso_ms

BBOX = "BBOX(geom, -100, 30, -80, 45)"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"

#: (config, metrics, resilience, tracing, tracing_export) of each package
PORT = (config, metrics, resilience, tracing, export)
REF = (jconfig, jmetrics, jresilience, jtracing, jexport)
PKGS = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "jax"])


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
def isolated_exporters():
    for _, _, res, _, ex in (PORT, REF):
        ex.reset()
        res.reset_breakers()
    yield
    for _, _, res, _, ex in (PORT, REF):
        ex.reset()
        res.reset_breakers()


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


def _ds(pkg, n=3000, partitioned=False):
    spec = "name:String,weight:Float,dtg:Date,*geom:Point"
    if partitioned:
        spec += ";geomesa.partition='time'"
    if pkg is PORT:
        ds = GeoDataset(n_shards=2, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    else:
        ds = jpkg.GeoDataset(n_shards=2)
    ds.create_schema("t", spec)
    ds.insert("t", _data(n), fids=np.arange(n).astype(str))
    ds.flush("t")
    return ds


def _ctr(pkg, name):
    return pkg[1].registry().counter(name).value


def _batches(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()]


def _spans(batch):
    return batch["resourceSpans"][0]["scopeSpans"][0]["spans"]


def _mk_trace(pkg, name="count", trace_id=None, children=("plan",)):
    """A synthetic finished trace (no dataset machinery)."""
    cfg, tr = pkg[0], pkg[3]
    with cfg.TRACE_ENABLED.scoped("true"):
        root = tr.start(name, trace_id=trace_id, schema="t")
        with root:
            for c in children:
                with tr.span(c):
                    pass
        return root.trace


def _sync_exporter(pkg):
    """A flusher-less exporter: ``flush()`` drains on the calling thread,
    where scoped config is visible."""
    ex = pkg[4]
    ex.reset()
    ex._exporter = ex.TraceExporter(autoflush=False)
    return ex._exporter


# -- the sampling policy ---------------------------------------------------------------
def test_sampled_in_equals_the_reference():
    ids = [f"{i * 2654435761 % (1 << 64):016x}" for i in range(1000)]
    for rate in ("0.1", "0.5", "0.9"):
        for seed in ("0", "42"):
            got = []
            for cfg, ex in ((config, export), (jconfig, jexport)):
                with cfg.TRACE_SAMPLE_RATE.scoped(rate), cfg.TRACE_SAMPLE_SEED.scoped(seed):
                    got.append([ex.sampled_in(i) for i in ids])
            assert got[0] == got[1]
            frac = sum(got[0]) / len(ids)
            assert abs(frac - float(rate)) < 0.06
            # the decision is the crc32 of "seed:trace_id" over 2^32
            assert got[0] == [(zlib.crc32(f"{seed}:{i}".encode()) / 2**32) < float(rate)
                              for i in ids]
    for rate, want in (("1.0", True), ("0.0", False)):
        with config.TRACE_SAMPLE_RATE.scoped(rate):
            assert all(export.sampled_in(i) is want for i in ids[:50])


def test_classify_equals_the_reference():
    got = []
    for pkg in (PORT, REF):
        out = []
        for flag in (None, "slot_died", "shed", "error", "degraded", "recompiles",
                     "slow_logged"):
            tr = _mk_trace(pkg)
            if flag == "error":
                tr.error = "ValueError"
            elif flag == "recompiles":
                tr.recompiles = 2
            elif flag is not None:
                setattr(tr, flag, True)
            out.append(pkg[4].classify(tr))
        with pkg[0].TRACE_SLOW_MS.scoped("0"):
            out.append(pkg[4].classify(_mk_trace(pkg)))
        got.append(out)
    assert got[0] == got[1] == [None, "slot_died", "shed", "error", "degraded",
                                "recompile", "slow", "slow"]


# -- the OTLP batches of the same calls --------------------------------------------------
OPS = {
    "count": lambda ds: ds.count("t", BBOX),
    "density": lambda ds: ds.density("t", BBOX, width=16, height=16),
    "count_polygon": lambda ds: ds.count("t", f"INTERSECTS(geom, {TRI})"),
    "query": lambda ds: ds.query("t", BBOX),
    "stats": lambda ds: ds.stats("t", "Count();MinMax(weight)", BBOX),
}


def _shape(spans):
    """A batch's spans less ids and times: (name, parent index, attributes)
    with ``device_ms`` values masked."""
    index = {s["spanId"]: i for i, s in enumerate(spans)}
    out = []
    for s in spans:
        attrs = {}
        for a in s.get("attributes", []):
            k, v = a["key"], a["value"]
            if k.startswith("geomesa.cost.device_ms"):
                v = "<ms>"
            attrs[k] = v
        out.append((s["name"], index.get(s.get("parentSpanId")), s["kind"],
                    sorted(attrs.items(), key=lambda kv: kv[0]), s.get("status")))
    return out


def test_otlp_batches_equal_the_reference(knobs, tmp_path):
    """Cold and warm calls: the first carries the registry's recompile
    events and is kept as ``recompile``; the warm ones as ``sampled``."""
    shapes = []
    for pkg in (PORT, REF):
        cfg = pkg[0]
        ds = _ds(pkg)
        _sync_exporter(pkg)
        path = tmp_path / f"{pkg[4].__name__}.jsonl"
        with cfg.TRACE_ENABLED.scoped("true"), cfg.TRACE_EXPORT_PATH.scoped(str(path)):
            for name in sorted(OPS):
                OPS[name](ds)
                OPS[name](ds)
            pkg[4].flush()
        batches = _batches(path)
        assert len(batches) == 1
        shapes.append(_shape(_spans(batches[0])))
        # the trace id is the 64-bit id twice, every span carries it
        spans = _spans(batches[0])
        roots = [s for s in spans if "parentSpanId" not in s]
        assert len(roots) == 2 * len(OPS)
        for s in spans:
            assert len(s["traceId"]) == 32 and len(s["spanId"]) == 16
            assert int(s["endTimeUnixNano"]) >= int(s["startTimeUnixNano"])
    assert shapes[0] == shapes[1]
    keeps = [dict(attrs)["geomesa.keep"]["stringValue"]
             for name, parent, _, attrs, _ in shapes[0] if parent is None]
    assert keeps[0] == "recompile" and "sampled" in keeps
    costs = [dict(attrs) for name, parent, _, attrs, _ in shapes[0] if parent is None]
    assert all("geomesa.cost.device_ms.0" in c for c in costs[:2])


# -- tail sampling through the exporter --------------------------------------------------
@PKGS
def test_always_keep_classes_ignore_sample_rate(pkg, tmp_path):
    cfg, ex = pkg[0], pkg[4]
    path = tmp_path / "spans.jsonl"
    with cfg.TRACE_EXPORT_PATH.scoped(str(path)), cfg.TRACE_SAMPLE_RATE.scoped("0.0"):
        healthy = _mk_trace(pkg)
        assert not healthy.exported
        with cfg.TRACE_SLOW_MS.scoped("0"):
            assert _mk_trace(pkg).exported
        for flag, val in (("error", "ValueError"), ("degraded", True), ("shed", True),
                          ("recompiles", 2)):
            tr = _mk_trace(pkg)
            setattr(tr, flag, val)
            tr.exported = False
            assert ex.offer(tr)
        ex.flush()
    reasons = {a["value"]["stringValue"] for b in _batches(path) for s in _spans(b)
               for a in s.get("attributes", []) if a["key"] == "geomesa.keep"}
    assert reasons == {"slow", "error", "degraded", "shed", "recompile"}


def test_error_flag_set_by_root_exit():
    for tr in (tracing, jtracing):
        cfg = config if tr is tracing else jconfig
        with cfg.TRACE_ENABLED.scoped("true"):
            root = tr.start("count", schema="t")
            with pytest.raises(ValueError):
                with root:
                    with tr.span("plan"):
                        raise ValueError("boom")
        assert root.trace.error == "ValueError" and not root.trace.shed


@PKGS
def test_sampled_out_traces_counted_once(pkg, tmp_path):
    cfg, ex = pkg[0], pkg[4]
    path = tmp_path / "spans.jsonl"
    before = _ctr(pkg, "trace.export.sampled")
    with cfg.TRACE_EXPORT_PATH.scoped(str(path)), cfg.TRACE_SAMPLE_RATE.scoped("0.0"):
        traces = [_mk_trace(pkg) for _ in range(5)]
        for tr in traces:  # a re-offer counts nothing more
            ex.offer(tr)
    assert _ctr(pkg, "trace.export.sampled") - before == 5
    assert not path.exists()


@PKGS
def test_flusher_drains_bursts_larger_than_one_batch(pkg, tmp_path):
    cfg, ex = pkg[0], pkg[4]
    path = tmp_path / "spans.jsonl"
    with cfg.TRACE_EXPORT_PATH.scoped(str(path)):
        for i in range(70):
            _mk_trace(pkg, trace_id=f"{i:016x}")
        exp = ex.exporter()
        for _ in range(400):
            if not exp._buf:
                break
            time.sleep(0.01)
        assert not exp._buf
        exp.flush()
    batches = _batches(path)
    assert len(batches) >= 2
    roots = [s for b in batches for s in _spans(b) if "parentSpanId" not in s]
    assert len(roots) == 70


@PKGS
def test_wedged_sink_drops_overflow_and_never_blocks(pkg, tmp_path):
    cfg, res, ex = pkg[0], pkg[2], pkg[4]
    path = tmp_path / "spans.jsonl"
    drop0 = _ctr(pkg, "trace.export.dropped")
    with cfg.TRACE_EXPORT_PATH.scoped(str(path)), cfg.TRACE_EXPORT_QUEUE.scoped("2"), \
            cfg.FAULT_INJECTION.scoped("true"):
        with res.inject_faults(seed=3) as inj:
            inj.fail(ex.SINK_FAULT_POINT, times=None, delay_s=0.2)
            _mk_trace(pkg)
            for _ in range(200):
                if inj.fired:
                    break
                time.sleep(0.005)
            assert inj.fired, "flusher never reached the wedged sink"
            t0 = time.perf_counter()
            for _ in range(12):
                _mk_trace(pkg)
            offered_s = time.perf_counter() - t0
            assert offered_s < 0.2, f"offer path blocked ({offered_s:.3f}s)"
            assert _ctr(pkg, "trace.export.dropped") - drop0 >= 8
        ex.reset()


@PKGS
def test_sink_failures_retry_then_succeed(pkg, tmp_path):
    cfg, res, ex = pkg[0], pkg[2], pkg[4]
    _sync_exporter(pkg)
    path = tmp_path / "spans.jsonl"
    fail0 = _ctr(pkg, "trace.export.failed")
    with cfg.TRACE_EXPORT_PATH.scoped(str(path)), cfg.RETRY_BASE_MS.scoped("1"), \
            cfg.FAULT_INJECTION.scoped("true"):
        with res.inject_faults(seed=3) as inj:
            inj.fail(ex.SINK_FAULT_POINT, times=2)
            _mk_trace(pkg)
            ex.flush()
            assert len(inj.fired) == 2
    assert _ctr(pkg, "trace.export.failed") == fail0
    assert _batches(path)


@PKGS
def test_sink_breaker_opens_after_repeated_failures(pkg, tmp_path):
    cfg, res, ex = pkg[0], pkg[2], pkg[4]
    _sync_exporter(pkg)
    path = tmp_path / "spans.jsonl"
    fail0 = _ctr(pkg, "trace.export.failed")
    with cfg.TRACE_EXPORT_PATH.scoped(str(path)), cfg.RETRY_ATTEMPTS.scoped("1"), \
            cfg.RETRY_BASE_MS.scoped("1"), cfg.BREAKER_THRESHOLD.scoped("2"), \
            cfg.FAULT_INJECTION.scoped("true"):
        with res.inject_faults(seed=3) as inj:
            inj.fail(ex.SINK_FAULT_POINT, times=None)
            for _ in range(4):
                _mk_trace(pkg)
                ex.flush()
    assert res.breaker("trace.export.file").state == "open"
    assert _ctr(pkg, "trace.export.failed") - fail0 == 4
    assert len(inj.fired) == 2


@PKGS
def test_late_slow_trace_still_exported(pkg, tmp_path):
    cfg, tr, ex = pkg[0], pkg[3], pkg[4]
    path = tmp_path / "spans.jsonl"
    with cfg.TRACE_ENABLED.scoped("true"), cfg.TRACE_EXPORT_PATH.scoped(str(path)), \
            cfg.TRACE_SAMPLE_RATE.scoped("0.0"), cfg.TRACE_SLOW_MS.scoped("5"):
        root = tr.start("query")
        with root:
            child = tr.span("query_batches")
            child.t0 = time.perf_counter()
        assert not root.trace.exported
        time.sleep(0.02)
        child.finish()
        assert root.trace.exported
        ex.flush()
    reasons = [a["value"]["stringValue"] for b in _batches(path) for s in _spans(b)
               for a in s.get("attributes", []) if a["key"] == "geomesa.keep"]
    assert "slow" in reasons


def test_degraded_partition_marks_trace(knobs, tmp_path):
    kept = []
    for pkg in (PORT, REF):
        cfg, res, tr = pkg[0], pkg[2], pkg[3]
        ds = _ds(pkg, n=6000, partitioned=True)
        with cfg.TRACE_ENABLED.scoped("true"), \
                cfg.TRACE_EXPORT_PATH.scoped(str(tmp_path / f"{tr.__name__}.jsonl")), \
                cfg.TRACE_SAMPLE_RATE.scoped("0.0"), cfg.FAULT_INJECTION.scoped("true"), \
                res.allow_partial():
            with res.inject_faults(seed=7) as inj:
                inj.fail("exec.partition.scan", times=1)
                n = ds.count("t", BBOX)
        last = tr.last_trace()
        kept.append((n, last.degraded, last.exported))
    assert kept[0] == kept[1] and kept[0][1:] == (True, True)


def test_http_sink_posts_the_file_batch(tmp_path):
    """The OTLP/HTTP sink POSTs the same batch the file sink writes, to a
    collector on 127.0.0.1."""
    got = []

    class Collector(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            body = self.rfile.read(int(self.headers["Content-Length"]))
            got.append((self.path, self.headers["Content-Type"], json.loads(body)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    server = ThreadingHTTPServer(("127.0.0.1", 0), Collector)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        _sync_exporter(PORT)
        path = tmp_path / "spans.jsonl"
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/traces"
        with config.TRACE_EXPORT_PATH.scoped(str(path)), \
                config.TRACE_OTLP_ENDPOINT.scoped(url):
            _mk_trace(PORT, children=("plan", "scan.kernel"))
            export.flush()
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=5)
    assert len(got) == 1
    route, ctype, batch = got[0]
    assert route == "/v1/traces" and ctype == "application/json"
    assert batch == _batches(path)[0]
    assert [s["name"] for s in _spans(batch)] == ["count", "plan", "scan.kernel"]
