"""Trace export with tail-based sampling.

Copy of ``geomesa_tpu/tracing_export.py``. Finished traces stream out as
OTLP-shaped JSON span batches, with the sampling decision made when a
trace finishes (tail-based), when its verdict is known:

* always keep: slow (over ``geomesa.trace.slow.ms``), errored, degraded
  (partitions skipped), shed and recompile-carrying traces (a kernel
  registry build inside the call);
* sample the rest at ``geomesa.trace.sample.rate``, decided from
  ``(geomesa.trace.sample.seed, trace_id)`` by a crc32, so a trace id is
  kept or dropped alike in every run and in both packages.

Two sinks, either or both: HTTP OTLP (``geomesa.trace.otlp.endpoint``),
one POST per batch, and a JSONL file (``geomesa.trace.export.path``), one
batch per line. Each write is retried by ``resilience.RetryPolicy`` and
fenced by the ``trace.export.<kind>`` circuit breaker, and passes the
``trace.export.sink`` fault point.

The query thread never blocks: :meth:`TraceExporter.offer` classifies,
samples and appends to a bounded queue (a full queue drops the trace and
counts ``trace.export.dropped``); conversion and sink I/O run on one
background flusher thread. Sink targets are read on the offering thread,
where thread-local config scopes are visible.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional

from geomesa_tpu_torch import config, metrics, resilience

#: fault-point site every sink write passes (chaos tests)
SINK_FAULT_POINT = "trace.export.sink"


# ---------------------------------------------------------------------------
# tail-sampling policy
# ---------------------------------------------------------------------------


def classify(trace) -> Optional[str]:
    """The always-keep class of a completed trace, or None (healthy —
    subject to the sample rate). Flags are set while the query runs
    (tracing.py), so this is a handful of attribute reads."""
    if getattr(trace, "slot_died", False):
        # a serving slot died/drained under this trace's stream — the
        # device-fault post-mortem evidence
        return "slot_died"
    if trace.shed:
        return "shed"
    if trace.error is not None:
        return "error"
    if trace.degraded:
        return "degraded"
    if trace.recompiles:
        return "recompile"
    if trace.slow_logged:
        return "slow"
    root = trace.root
    try:
        thresh = config.TRACE_SLOW_MS.to_float()
    except (TypeError, ValueError):
        thresh = None
    if thresh is not None and root is not None \
            and root.duration_ms >= thresh:
        return "slow"
    return None


def sampled_in(trace_id: str) -> bool:
    """Deterministic keep/drop for a HEALTHY trace: hash (seed, trace_id)
    to [0, 1) and compare against ``geomesa.trace.sample.rate``. Stable
    across runs and processes for a given seed — the property the seeded-
    determinism tests assert."""
    try:
        rate = config.TRACE_SAMPLE_RATE.to_float()
    except (TypeError, ValueError):
        rate = 1.0
    rate = 1.0 if rate is None else rate
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    seed = config.TRACE_SAMPLE_SEED.get() or "0"
    h = zlib.crc32(f"{seed}:{trace_id}".encode()) & 0xFFFFFFFF
    return (h / 2**32) < rate


# ---------------------------------------------------------------------------
# OTLP conversion (the span tree is already shaped like an OTLP batch)
# ---------------------------------------------------------------------------


def _otlp_value(v) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


def _span_id(trace_id: str, idx: int) -> str:
    """Deterministic 8-byte span id from (trace_id, preorder index)."""
    return hashlib.blake2b(
        f"{trace_id}/{idx}".encode(), digest_size=8
    ).hexdigest()


def trace_to_otlp_spans(trace, keep_reason: Optional[str],
                        epoch_offset: float) -> List[Dict[str, Any]]:
    """Flatten one trace's span tree into OTLP/JSON span dicts.
    ``epoch_offset`` maps the monotonic ``perf_counter`` timestamps the
    spans carry onto unix time (computed once per batch). The root span
    additionally carries the sampling verdict, the classification flags,
    and the per-query cost ledger as attributes."""
    out: List[Dict[str, Any]] = []
    tid32 = (trace.trace_id * 2)[:32]  # OTLP wants 16 bytes hex
    counter = [0]

    def walk(span, parent_hex: str) -> None:
        idx = counter[0]
        counter[0] += 1
        with trace.lock:
            attrs = dict(span.attrs)
            children = list(span.children)
        start_ns = int((span.t0 + epoch_offset) * 1e9)
        end_ns = start_ns + int(span.duration_ms * 1e6)
        rec: Dict[str, Any] = {
            "traceId": tid32,
            "spanId": _span_id(trace.trace_id, idx),
            "name": span.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(end_ns),
        }
        if parent_hex:
            rec["parentSpanId"] = parent_hex
        if idx == 0:
            attrs["geomesa.keep"] = keep_reason or "sampled"
            if trace.error is not None:
                attrs["geomesa.error"] = trace.error
            if trace.degraded:
                attrs["geomesa.degraded"] = True
            if trace.recompiles:
                attrs["geomesa.recompiles"] = trace.recompiles
            if trace.dropped:
                attrs["geomesa.dropped_spans"] = trace.dropped
            with trace.lock:
                cost = dict(trace.cost)
            for k, v in sorted(cost.items()):
                attrs[f"geomesa.cost.{k}"] = round(v, 4)
        if attrs:
            rec["attributes"] = _otlp_attrs(attrs)
        if trace.error is not None and idx == 0:
            rec["status"] = {"code": 2, "message": trace.error}  # ERROR
        out.append(rec)
        for c in children:
            walk(c, rec["spanId"])

    if trace.root is not None:
        walk(trace.root, "")
    return out


def otlp_batch(entries: List[tuple]) -> Dict[str, Any]:
    """One OTLP/JSON ExportTraceServiceRequest for ``entries`` of
    ``(trace, keep_reason)``."""
    epoch_offset = time.time() - time.perf_counter()
    spans: List[Dict[str, Any]] = []
    for trace, reason in entries:
        spans.extend(trace_to_otlp_spans(trace, reason, epoch_offset))
    return {
        "resourceSpans": [{
            "resource": {"attributes": _otlp_attrs(
                {"service.name": "geomesa-tpu-torch"}
            )},
            "scopeSpans": [{
                "scope": {"name": "geomesa_tpu_torch.tracing"},
                "spans": spans,
            }],
        }],
    }


def dict_tree_to_otlp_spans(trace_id: str,
                            tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a span tree in its DICT form (``Span.to_dict()`` shape:
    ``{"name", "ms", "attrs", "children"}``) into OTLP/JSON span dicts —
    the stitched fleet trace is assembled as a dict tree (router spans +
    ``trace-fetch``ed replica subtrees), so it never had live Span
    objects. Dict trees carry durations but not absolute start times, so
    start times are synthesized: the root ends "now", and each child
    starts when its parent does — slicing stays faithful, sub-span skew
    inside one parent is lost (an accepted stitching approximation)."""
    tid32 = (trace_id * 2)[:32]
    root_ms = float(tree.get("ms") or 0.0)
    root_start_ns = int(time.time() * 1e9) - int(root_ms * 1e6)
    out: List[Dict[str, Any]] = []
    counter = [0]

    def walk(node: Dict[str, Any], parent_hex: str, start_ns: int) -> None:
        idx = counter[0]
        counter[0] += 1
        rec: Dict[str, Any] = {
            "traceId": tid32,
            # a distinct id keyspace from the replicas' own exports: the
            # same trace id legitimately appears twice in a sink (each
            # replica's local subtree + the fleet's stitched whole), and
            # their span ids must not collide
            "spanId": _span_id(f"stitched/{trace_id}", idx),
            "name": str(node.get("name") or "span"),
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_ns),
            "endTimeUnixNano": str(
                start_ns + int(float(node.get("ms") or 0.0) * 1e6)
            ),
        }
        if parent_hex:
            rec["parentSpanId"] = parent_hex
        attrs = dict(node.get("attrs") or {})
        if idx == 0:
            attrs["geomesa.stitched"] = True
        if attrs:
            rec["attributes"] = _otlp_attrs(attrs)
        out.append(rec)
        for c in node.get("children") or []:
            walk(c, rec["spanId"], start_ns)

    walk(tree, "", root_start_ns)
    return out


def stitched_batch(trace_id: str, tree: Dict[str, Any]) -> Dict[str, Any]:
    """One OTLP/JSON ExportTraceServiceRequest for one stitched fleet
    trace. The resource is ``geomesa-tpu-torch-fleet`` with ``stitched=true``
    so a backend (and the CI smoke gate) can tell the fleet's assembled
    view from the replicas' own exports of the same trace id."""
    return {
        "resourceSpans": [{
            "resource": {"attributes": _otlp_attrs({
                "service.name": "geomesa-tpu-torch-fleet",
                "geomesa.stitched": True,
            })},
            "scopeSpans": [{
                "scope": {"name": "geomesa_tpu_torch.fleet.obs"},
                "spans": dict_tree_to_otlp_spans(trace_id, tree),
            }],
        }],
    }


def export_stitched(trace_id: str, tree: Dict[str, Any]) -> bool:
    """Write one stitched trace through the configured sinks (same
    JSONL/OTLP targets and breakers the live exporter uses). Runs on the
    fleet stitcher thread only — never the query path. False when no
    sink is configured or every sink failed."""
    sinks = []
    path = config.TRACE_EXPORT_PATH.get()
    if path:
        sinks.append(("file", path))
    endpoint = config.TRACE_OTLP_ENDPOINT.get()
    if endpoint:
        sinks.append(("otlp", endpoint))
    if not sinks:
        return False
    batch = stitched_batch(trace_id, tree)
    ok = False
    for kind, target in sinks:
        if _Sink(kind, target).write(batch, 1):
            ok = True
    return ok


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


def _write_file_sink(path: str, batch: Dict[str, Any]) -> None:
    resilience.fault_point(SINK_FAULT_POINT, sink="file", path=path)
    with open(path, "a") as fh:
        fh.write(json.dumps(batch) + "\n")


def _write_http_sink(endpoint: str, batch: Dict[str, Any]) -> None:
    resilience.fault_point(SINK_FAULT_POINT, sink="otlp", endpoint=endpoint)
    import urllib.request

    req = urllib.request.Request(
        endpoint, data=json.dumps(batch).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        resp.read()


class _Sink:
    """One sink target: retried writes behind a named circuit breaker.
    A batch that still fails after retries (or finds the breaker open) is
    counted in ``trace.export.failed`` and dropped — export must degrade,
    never back up into the query path."""

    def __init__(self, kind: str, target: str):
        self.kind = kind          # "file" | "otlp"
        self.target = target
        self.breaker_name = f"trace.export.{kind}"

    def write(self, batch: Dict[str, Any], n_traces: int) -> bool:
        br = resilience.breaker(self.breaker_name)
        try:
            br.allow()
        except resilience.CircuitOpenError:
            metrics.inc(metrics.TRACE_EXPORT_FAILED, n_traces)
            return False
        policy = resilience.RetryPolicy.from_config(seed=0)
        try:
            policy.call(lambda: (
                _write_file_sink(self.target, batch) if self.kind == "file"
                else _write_http_sink(self.target, batch)
            ))
        except Exception:
            br.record_failure()
            metrics.inc(metrics.TRACE_EXPORT_FAILED, n_traces)
            return False
        br.record_success()
        return True


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------


class TraceExporter:
    """Bounded-buffer background exporter. ``offer()`` is the only entry
    point the query path touches and it never blocks: sample -> enqueue
    (or drop+count). One daemon flusher thread drains, converts, and
    writes batches grouped by sink target. Dequeue and sink write happen
    atomically under the flush lock, so :meth:`flush` returning with an
    empty buffer means every offered trace was written (or counted
    failed) — no in-flight limbo for tests to race."""

    def __init__(self, maxsize: Optional[int] = None,
                 autoflush: bool = True):
        #: autoflush=False disables the background thread entirely —
        #: flush() is then the only drain (tests drive the sink path
        #: synchronously so thread-local config scopes stay visible)
        self._autoflush = autoflush
        self._maxsize = maxsize
        self._buf: "deque" = deque()
        self._buf_lock = threading.Lock()
        self._wake = threading.Event()
        self._flush_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _cap(self) -> int:
        if self._maxsize is not None:
            return max(1, self._maxsize)
        return max(1, config.TRACE_EXPORT_QUEUE.to_int() or 1024)

    # -- query-thread half -------------------------------------------------
    def offer(self, trace) -> bool:
        """Classify, sample, and enqueue one completed trace. Returns True
        when the trace was queued for export. Never blocks."""
        reason = classify(trace)
        if reason is None and not sampled_in(trace.trace_id):
            # once per trace: a streamed trace re-finishing on every late
            # child re-offers, and each healthy re-offer must not inflate
            # the sampled counter operators use to validate the rate
            if not trace.sample_counted:
                trace.sample_counted = True
                metrics.inc(metrics.TRACE_EXPORT_SAMPLED)
            return False
        # sink targets resolve HERE (thread-local scopes are visible on
        # the offering thread; the flusher sees only env/defaults)
        sinks = []
        path = config.TRACE_EXPORT_PATH.get()
        if path:
            sinks.append(("file", path))
        endpoint = config.TRACE_OTLP_ENDPOINT.get()
        if endpoint:
            sinks.append(("otlp", endpoint))
        if not sinks:
            return False
        with self._buf_lock:
            if len(self._buf) >= self._cap():
                metrics.inc(metrics.TRACE_EXPORT_DROPPED)
                return False
            self._buf.append((trace, reason, tuple(sinks)))
        trace.exported = True
        metrics.inc(metrics.TRACE_EXPORT_EXPORTED)
        self._wake.set()
        self._ensure_thread()
        return True

    # -- flusher half ------------------------------------------------------
    def _ensure_thread(self) -> None:
        if not self._autoflush:
            return
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._buf_lock:
            t = self._thread
            if t is not None and t.is_alive():
                return
            self._stop.clear()
            t = threading.Thread(
                target=self._loop, daemon=True, name="geomesa-trace-export"
            )
            self._thread = t
            t.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            try:
                # drain EVERYTHING buffered, batch by batch: a burst
                # larger than one batch (or offers racing the clear
                # above) must not strand traces until the next offer —
                # the timeout path re-drains too, as the backstop
                while self._flush_once():
                    pass
            except Exception:  # pragma: no cover — a sink conversion bug
                # must not kill the flusher; the batch is already gone
                # from the buffer, count it failed
                metrics.inc(metrics.TRACE_EXPORT_FAILED)

    def _flush_once(self) -> bool:
        """Drain-and-write ONE batch atomically. False = buffer empty."""
        with self._flush_lock:
            batch_max = config.TRACE_EXPORT_BATCH.to_int() or 64
            items: List[tuple] = []
            with self._buf_lock:
                while self._buf and len(items) < batch_max:
                    items.append(self._buf.popleft())
            if not items:
                return False
            self._write(items)
            return True

    def _write(self, items: List[tuple]) -> None:
        # group by sink target set (usually one), one OTLP batch per group
        groups: Dict[tuple, List[tuple]] = {}
        for trace, reason, sinks in items:
            groups.setdefault(sinks, []).append((trace, reason))
        for sinks, entries in groups.items():
            batch = otlp_batch(entries)
            ok = False
            for kind, target in sinks:
                if _Sink(kind, target).write(batch, len(entries)):
                    ok = True
            if ok:
                metrics.inc(metrics.TRACE_EXPORT_BATCHES)

    def flush(self, timeout_s: float = 5.0) -> None:
        """Synchronously drain and write everything queued (tests, bench,
        shutdown). Safe to call concurrently with the flusher; on return
        everything offered before the call has been written or counted."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self._flush_once():
                return

    def shutdown(self, flush: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if flush:
            self.flush()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None


_lock = threading.Lock()
_exporter: Optional[TraceExporter] = None


def exporter() -> TraceExporter:
    """The process-wide exporter (created on first use)."""
    global _exporter
    ex = _exporter
    if ex is None:
        with _lock:
            ex = _exporter
            if ex is None:
                ex = _exporter = TraceExporter()
    return ex


def offer(trace) -> bool:
    """Module-level entry point tracing._finish_trace calls."""
    return exporter().offer(trace)


def flush(timeout_s: float = 5.0) -> None:
    ex = _exporter
    if ex is not None:
        ex.flush(timeout_s)


def reset() -> None:
    """Tear down the exporter (test isolation): stop the flusher WITHOUT
    flushing (queued traces are discarded) and drop the singleton."""
    global _exporter
    with _lock:
        ex, _exporter = _exporter, None
    if ex is not None:
        ex._stop.set()
        ex._wake.set()
        t = ex._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2.0)
