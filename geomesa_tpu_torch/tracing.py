"""Span-tree query tracing and the per-query cost ledger.

Copy of ``geomesa_tpu/tracing.py``. It answers "where did this query's
40 ms go?": each public call opens a root span (``start``), every stage on
the way down (plan, cache cell lookups, partition staging and scans,
device uploads, kernel launches, host syncs) opens a child (``span``), and
the finished tree is:

* stamped into the call's audit event and ``explain`` output by its
  ``trace_id``;
* routed into the per-stage latency histograms (``trace.<stage>`` in the
  metrics registry);
* written as one JSONL record through the audit appender when the call took
  at least ``geomesa.trace.slow.ms`` (the slow-query log), and kept by id
  in a bounded ring (``finished_trace``);
* handed to the trace exporter (``tracing_export.py``) when a sink is
  configured: it tail-samples the trace by the flags the call set
  (``error``, ``degraded``, ``recompiles``, slowness) and writes it as an
  OTLP span batch.

Cheap when off: the current span lives in a :mod:`contextvars` ContextVar,
and with no active trace ``span()`` is a single ContextVar read returning a
shared no-op singleton: no allocation, no lock, no clock read.

Spans time the host. A ``scan.kernel`` span closes when its launches
return, not when the card finishes them; the wait shows in the
``scan.sync`` span at the host copy that follows. No span synchronizes the
device. With ``geomesa.trace.jax.profiler`` on, each span also opens a
``torch.profiler.record_function`` range, so spans show in a
``torch.profiler`` trace beside the kernels.

Cross-thread: the partition prefetch worker adopts the query thread's
span (:func:`snapshot` / :func:`adopt`) as it adopts config overrides.
Span mutation is lock-protected on the owning :class:`Trace`: the prefetch
worker appends staging spans while the query thread appends its own.

The kernel registry's ``kernel.recompile`` events count into the trace's
``recompiles`` (and its cost ledger's ``recompiles`` key when it
finishes). For the serving scheduler (``serving/scheduler.py``): a root
span that a ``DeadlineShedError`` escapes flags its trace ``shed``;
:func:`mark_slot_died` flags a stranded stream's trace ``slot_died`` by id
(the live traces are held weakly in ``_open``) with a ``serving.slot.died``
event under its root; and :func:`pop_thread_trace` hands a dispatch thread
the trace its ticket just finished, so the ticket's cost ledger lands on
its user. ``tracing_export.classify`` keeps both flags' traces.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from geomesa_tpu_torch import config, metrics

#: trace ids: 64 bits from one generator seeded from the OS once. The
#: reference's ``uuid4`` reads ``os.urandom`` for every id, a system call
#: that cost about 0.1-0.27 ms a trace on the H100's host (PERF.md §6)
_ids = random.Random()

#: live traces by id (weak values: a trace lives as long as its holders):
#: the serving supervisor flags a stranded ticket's trace through it
_open: "weakref.WeakValueDictionary[str, Trace]" = weakref.WeakValueDictionary()

#: the innermost open span of the calling context (None = not tracing)
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "geomesa_trace_span", default=None
)


class _NoopSpan:
    """Shared do-nothing span: the entire tracing surface when disabled.
    A singleton so the disabled hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP = _NoopSpan()


class Trace:
    """One query's span tree: id, root, and the bounded span budget, the
    tail-sampling flags (``error`` / ``shed`` / ``degraded`` /
    ``recompiles``, set as the query runs and read at completion by
    ``tracing_export.py``; ``exported`` / ``sample_counted`` make its offer
    at-most-once) and the per-query cost ledger (``cost``: device ms per
    device, partitions, bytes staged and read, cache hits, join cells;
    accumulated by :func:`add_cost`, read by ``explain``'s Cost section and
    the exporter)."""

    __slots__ = ("trace_id", "root", "max_spans", "n_spans", "dropped",
                 "profiler", "lock", "finished", "slow_logged",
                 "error", "shed", "degraded", "recompiles", "cost",
                 "exported", "sample_counted", "slot_died", "__weakref__")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or f"{_ids.getrandbits(64):016x}"
        self.root: Optional[Span] = None
        cap = config.TRACE_MAX_SPANS.to_int()
        self.max_spans = 512 if cap is None else max(cap, 1)
        self.n_spans = 0
        self.dropped = 0
        self.profiler = bool(config.TRACE_JAX_PROFILER.to_bool())
        self.lock = threading.Lock()
        self.finished = False
        self.slow_logged = False
        self.error: Optional[str] = None   # exception type name, if raised
        self.shed = False                  # typed deadline shed (serving)
        self.degraded = False              # partitions skipped (resilience)
        self.recompiles = 0                # kernel.recompile events seen
        self.cost: Dict[str, float] = {}   # per-query cost ledger
        self.exported = False              # handed to the exporter once
        self.sample_counted = False        # sampled-out counted once
        self.slot_died = False             # serving slot died under it
        _open[self.trace_id] = self

    def admit(self) -> bool:
        """Reserve one span slot (False = budget exhausted, span dropped)."""
        with self.lock:
            if self.n_spans >= self.max_spans:
                self.dropped += 1
                return False
            self.n_spans += 1
            return True


class Span:
    """One timed stage. Context manager; durations are monotonic-clock.

    Children attach under the span that was current when they were
    opened, so trees assemble correctly even when stages run on an
    adopted worker thread (the trace lock orders the appends)."""

    __slots__ = ("name", "trace", "parent", "attrs", "children",
                 "t0", "duration_ms", "_token", "_annotation")

    def __init__(self, name: str, trace: Trace, parent: "Optional[Span]",
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace = trace
        self.parent = parent
        self.attrs = attrs or {}
        self.children: List[Span] = []
        self.t0 = 0.0
        self.duration_ms = 0.0
        self._token = None
        self._annotation = None

    def set(self, **attrs) -> "Span":
        """Attach attributes to an open (or closed) span."""
        with self.trace.lock:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        if self.trace.profiler:
            self._annotation = _profiler_range(self.name)
            self._annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None and self.parent is None:
            # root-only: an exception a child span propagates may be caught
            # and recovered above (a skipped partition under allow_partial
            # succeeds degraded); only one that escapes the root means the
            # query failed; a typed deadline shed is its own class
            self.trace.error = exc[0].__name__
            from geomesa_tpu_torch.resilience import DeadlineShedError

            if issubclass(exc[0], DeadlineShedError):
                self.trace.shed = True
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.finish()
        return False

    def finish(self) -> None:
        """Close the span without touching the context var: for spans whose
        lifetime outlives the opening frame (the streamed ``query_batches``
        root closes at stream end, from the consumer's iteration).
        ``__exit__`` routes through here."""
        end = time.perf_counter()
        self.duration_ms = (end - self.t0) * 1e3
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        # per-stage latency histogram; the trace id rides along as the
        # bucket's exemplar
        metrics.observe("trace." + self.name, self.duration_ms / 1e3,
                        trace_id=self.trace.trace_id)
        if self.parent is None:
            _finish_trace(self.trace)
        elif self.trace.finished:
            # a span that outlived its root: stretch the root to cover it
            # and re-evaluate the slow-query threshold (logged once)
            root = self.trace.root
            if root is not None:
                root.duration_ms = max(
                    root.duration_ms, (end - root.t0) * 1e3
                )
                _finish_trace(self.trace)

    def to_dict(self) -> Dict[str, Any]:
        """The span subtree as plain JSON-able data (slow-query records,
        :func:`finished_trace`, :func:`render`)."""
        with self.trace.lock:
            children = list(self.children)
            attrs = dict(self.attrs)
        out: Dict[str, Any] = {
            "name": self.name,
            "ms": round(self.duration_ms, 3),
        }
        if attrs:
            out["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        if children:
            out["children"] = [c.to_dict() for c in children]
        return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``geomesa:<name>``
    (the reference's ``jax.profiler.TraceAnnotation``)."""
    import torch

    return torch.profiler.record_function("geomesa:" + name)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def enabled() -> bool:
    return bool(config.TRACE_ENABLED.to_bool())


def start(name: str, trace_id: Optional[str] = None, force: bool = False, **attrs):
    """Open a ROOT span (one per query), under ``trace_id`` when given.
    The no-op singleton unless tracing is enabled, or ``force`` is set with
    a ``trace_id`` (a fused member keeps the trace id its client sent).
    Called with a trace already active on the context (a public call
    inside another), it joins that trace as a child instead of opening a
    second root."""
    if _current.get() is not None:
        return span(name, **attrs)
    if not (enabled() or (force and trace_id)):
        return NOOP
    trace = Trace(trace_id)
    root = Span(name, trace, None, attrs or None)
    trace.root = root
    trace.n_spans = 1
    return root


def span(name: str, **attrs):
    """Open a child span under the calling context's current span. With no
    active trace this is a single ContextVar read returning the shared
    no-op singleton: the disabled fast path."""
    cur = _current.get()
    if cur is None:
        return NOOP
    trace = cur.trace
    if not trace.admit():
        return NOOP
    child = Span(name, trace, cur, attrs or None)
    with trace.lock:
        cur.children.append(child)
    return child


def event(name: str, **attrs) -> None:
    """A zero-duration marker attached to the current span (a kernel
    registry build inside the query that paid for it). No-op without a
    trace."""
    cur = _current.get()
    if cur is None:
        return
    trace = cur.trace
    if name == "kernel.recompile":
        # an always-keep class of tail sampling, flagged here so the
        # exporter never walks the tree
        with trace.lock:
            trace.recompiles += 1
    if not trace.admit():
        return
    child = Span(name, trace, cur, attrs or None)
    with trace.lock:
        cur.children.append(child)


def current_span():
    """The innermost open span, or None."""
    return _current.get()


def current_trace_id() -> Optional[str]:
    cur = _current.get()
    return None if cur is None else cur.trace.trace_id


def snapshot():
    """The calling thread's current span, for cross-thread adoption (the
    partition prefetch worker pairs this with :func:`adopt` as it pairs
    ``config.snapshot_overrides`` with ``adopt_overrides``)."""
    return _current.get()


def adopt(span_) -> None:
    """Install a :func:`snapshot` span as this thread's current span, so
    worker-side ``span()`` calls nest under the query's tree."""
    _current.set(span_)


# ---------------------------------------------------------------------------
# per-query cost ledger + classification hooks
# ---------------------------------------------------------------------------


def add_cost(key: str, value: float) -> None:
    """Accumulate one cost contribution (``partitions_scanned``,
    ``bytes_staged``, ``cache_hits``, ...) into the calling context's
    trace. No-op without an active trace: the ledger is trace-scoped and
    shares tracing's cheap-when-off contract. The prefetch worker's
    adopted context routes its staging bytes here too."""
    cur = _current.get()
    if cur is None:
        return
    tr = cur.trace
    with tr.lock:
        tr.cost[key] = tr.cost.get(key, 0.0) + value


def current_cost() -> Dict[str, float]:
    """Copy of the active trace's cost ledger (empty without a trace),
    with the live recompile count folded in as a finished trace carries
    it."""
    cur = _current.get()
    if cur is None:
        return {}
    tr = cur.trace
    with tr.lock:
        out = dict(tr.cost)
    if tr.recompiles:
        out.setdefault("recompiles", float(tr.recompiles))
    return out


def mark_degraded() -> None:
    """Flag the active trace degraded (a partition was skipped under the
    degradation contract). Called by ``resilience.record_skip``."""
    cur = _current.get()
    if cur is not None:
        cur.trace.degraded = True


def mark_slot_died(trace_id: Optional[str], slot: int, reason: str = "died") -> bool:
    """Flag the live trace behind ``trace_id`` as stranded by a dying or
    drained serving slot: sets ``slot_died`` (an always-keep class of tail
    sampling) and appends a zero-duration ``serving.slot.died`` event under
    its root. By id, since the dying dispatcher is not in the stream's span
    context. False when no live trace holds the id."""
    if not trace_id:
        return False
    tr = _open.get(trace_id)
    if tr is None:
        return False
    with tr.lock:
        tr.slot_died = True
    root = tr.root
    if root is not None and tr.admit():
        ev = Span("serving.slot.died", tr, root, {"slot": int(slot), "reason": reason})
        with tr.lock:
            root.children.append(ev)
    return True


#: the trace each thread completed last: the serving scheduler reads and
#: clears it around a dispatched ticket, without racing other threads on
#: the process-wide ``last_trace``
_tls = threading.local()


def pop_thread_trace() -> Optional[Trace]:
    """Return and clear this thread's most recently completed trace."""
    tr = getattr(_tls, "last", None)
    _tls.last = None
    return tr


# ---------------------------------------------------------------------------
# slow-query log + finished-trace ring
# ---------------------------------------------------------------------------

_slow_lock = threading.Lock()
_slow: "deque" = deque(maxlen=256)
_last: List[Optional[Trace]] = [None]

#: finished traces by id (strong refs, bounded by geomesa.trace.retain,
#: oldest out). Insertion is one ordered-dict put on trace completion; the
#: span-tree walk happens at fetch time.
_retain_lock = threading.Lock()
_retained: "OrderedDict[str, List[Trace]]" = OrderedDict()

#: traces retained per id (roots opened under one given ``trace_id``)
_RETAIN_PER_ID = 32


def _retain(trace: Trace) -> None:
    cap = config.TRACE_RETAIN.to_int()
    cap = 256 if cap is None else int(cap)
    if cap <= 0:
        return
    with _retain_lock:
        lst = _retained.get(trace.trace_id)
        if lst is None:
            lst = _retained[trace.trace_id] = []
        lst.append(trace)
        del lst[:-_RETAIN_PER_ID]
        _retained.move_to_end(trace.trace_id)
        while len(_retained) > cap:
            _retained.popitem(last=False)


def _trace_record(tr: Trace) -> Dict[str, Any]:
    return {
        "trace_id": tr.trace_id,
        "total_ms": round(tr.root.duration_ms, 3),
        "dropped_spans": tr.dropped,
        "tree": tr.root.to_dict(),
    }


def finished_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """The most recent retained finished trace behind ``trace_id`` as a
    JSON-able record (``{"trace_id", "total_ms", "dropped_spans",
    "tree"}``), or None when the id never finished here or aged out of the
    ring."""
    with _retain_lock:
        lst = [tr for tr in _retained.get(trace_id) or () if tr.root is not None]
    return _trace_record(lst[-1]) if lst else None


def finished_traces(trace_id: str) -> List[Dict[str, Any]]:
    """Every retained trace behind ``trace_id``, oldest first."""
    with _retain_lock:
        lst = list(_retained.get(trace_id) or ())
    return [_trace_record(tr) for tr in lst if tr.root is not None]


def clear_retained() -> None:
    with _retain_lock:
        _retained.clear()


def last_trace() -> Optional[Trace]:
    """The most recently completed trace (None when tracing never ran)."""
    return _last[0]


def _finish_trace(trace: Trace) -> None:
    """Root closed: retain the trace, fold its recompile count into the
    cost ledger, check it against ``geomesa.trace.slow.ms`` and, when slow,
    record the full tree (the ring and the audit JSONL appender, so the
    file's order matches the query events around it); then offer it to the
    exporter, which makes the tail-sampling decision."""
    root = trace.root
    if root is None:
        return
    trace.finished = True
    _last[0] = trace
    _tls.last = trace
    _retain(trace)
    if trace.recompiles:
        with trace.lock:
            trace.cost["recompiles"] = float(trace.recompiles)
    try:
        thresh = config.TRACE_SLOW_MS.to_float()
    except (TypeError, ValueError):
        thresh = None
    if thresh is None or root.duration_ms < thresh or trace.slow_logged:
        _offer_export(trace)
        return
    trace.slow_logged = True
    rec = {
        "kind": "slow_trace",
        "trace_id": trace.trace_id,
        "total_ms": round(root.duration_ms, 3),
        "threshold_ms": thresh,
        "dropped_spans": trace.dropped,
        "date": time.time(),
        "tree": root.to_dict(),
    }
    with _slow_lock:
        _slow.append(rec)
    from geomesa_tpu_torch import audit

    audit.append_record(rec)
    metrics.inc("trace.slow")
    _offer_export(trace)


def _offer_export(trace: Trace) -> None:
    """Hand a finished trace to the exporter when a sink is configured.
    Safe to call again: a late child re-runs :func:`_finish_trace`, and a
    trace sampled out may be offered again once it became slow; the
    ``exported`` flag keeps the enqueue at most once."""
    if trace.exported:
        return
    if not (config.TRACE_OTLP_ENDPOINT.get() or config.TRACE_EXPORT_PATH.get()):
        return
    from geomesa_tpu_torch import tracing_export

    tracing_export.offer(trace)


def slow_traces(n: int = 50) -> List[Dict[str, Any]]:
    """Most recent slow-query span trees (newest last)."""
    with _slow_lock:
        return list(_slow)[-n:]


def clear_slow_traces() -> None:
    with _slow_lock:
        _slow.clear()


def render(tree, indent: int = 0) -> str:
    """Human-readable span tree of a :meth:`Span.to_dict` record, a
    :class:`Span` or a finished :class:`Trace` (``render(last_trace())``)."""
    if isinstance(tree, Trace):
        tree = tree.root
    if isinstance(tree, Span):
        tree = tree.to_dict()
    pad = "  " * indent
    attrs = tree.get("attrs")
    suffix = (
        " [" + ", ".join(f"{k}={v}" for k, v in attrs.items()) + "]"
        if attrs else ""
    )
    lines = [f"{pad}{tree['name']}: {tree.get('ms', 0.0):.3f} ms{suffix}"]
    for c in tree.get("children", ()):
        lines.append(render(c, indent + 1))
    return "\n".join(lines)
