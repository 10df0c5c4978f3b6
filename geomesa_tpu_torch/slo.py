"""SLO burn rates over the trace stage histograms.

Copy of ``geomesa_tpu/slo.py``. An operator declares per-op p99 latency
targets, ``geomesa.slo.<op>.p99.ms`` (a thread-local override or
``GEOMESA_SLO_<OP>_P99_MS``), where ``<op>`` is a root-span name the tracing
layer already histograms (``count``, ``density``, ``query``, ...). The
monitor turns the targets and the ``trace.<op>`` histograms into the
multi-window burn-rate signal:

* bad fraction over a window: observations above the target's bucket over
  all observations in the window (by differencing timestamped snapshots of
  the cumulative histograms);
* burn rate: the bad fraction over the error budget (1% for a p99 target);
* two windows: the fast one (``geomesa.slo.window.fast.s``) degrades
  ``/healthz`` while it burns past ``geomesa.slo.burn.threshold``; the slow
  one (``geomesa.slo.window.slow.s``) confirms a sustained burn. Both ride
  the ``slo.burn.<op>`` gauges and ``/debug/devices``.

The target snaps up to the smallest bucket bound at or above it, the same
answer a PromQL burn query over the exported buckets computes. Every named
circuit breaker is mirrored as a ``slo.breaker.<name>`` gauge.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from geomesa_tpu_torch import config, metrics

#: error budget implied by a p99 target: 1% of requests may exceed it
P99_BUDGET = 0.01

#: breaker state -> slo.breaker.<name> gauge value
_BREAKER_GAUGE = {"open": 1.0, "half-open": 0.5, "closed": 0.0}

_breaker_gauged: set = set()
_breaker_lock = threading.Lock()


def sync_breaker_gauges() -> Dict[str, str]:
    """Mirror every named circuit breaker as a ``slo.breaker.<name>`` gauge
    (1 open, 0.5 half-open, 0 closed), so a breaker opening pages through
    the scrape the burn gauges ride. Returns the current state map. The
    gauges are live callables, registered once per breaker name."""
    from geomesa_tpu_torch import resilience

    states = resilience.breaker_states()
    for name in states:
        gname = f"{metrics.SLO_BREAKER_PREFIX}.{name}"
        if gname in _breaker_gauged:
            continue
        with _breaker_lock:
            if gname in _breaker_gauged:
                continue
            metrics.registry().gauge(
                gname,
                lambda n=name: _BREAKER_GAUGE.get(
                    resilience.breaker_states().get(n, "closed"), 0.0
                ),
                replace=True,
            )
            _breaker_gauged.add(gname)
    return states

#: injectable clock (tests drive window arithmetic deterministically)
_clock = time.monotonic


def _over_count(snap: Dict[str, Any], target_ms: float) -> "tuple":
    """(total, over-target) observation counts from one histogram
    SNAPSHOT (``Histogram.snapshot()`` shape), with the
    target snapped UP to a bucket bound (bucket granularity is all the
    fixed-bucket histogram can answer; observations in the target's own
    bucket count as within-SLO, matching the cumulative le= semantics).
    Accepts a live ``Histogram`` too and snapshots it."""
    if not isinstance(snap, dict):
        snap = snap.snapshot()
    total = snap["count"]
    target_s = target_ms / 1e3
    buckets = snap["buckets"]
    i = bisect.bisect_left(buckets, target_s)
    good = sum(snap["counts"][: i + 1])  # le= the snapped bound (+Inf ok)
    return total, max(total - good, 0)


class SloMonitor:
    """Timestamped snapshot ring per op; burn rates by differencing the
    newest snapshot against the oldest one inside each window.

    ``source`` generalizes WHERE the cumulative histograms come from: a
    callable ``op -> Histogram.snapshot()-shaped dict (or None)``. The
    default reads the process registry's ``trace.<op>`` histograms (a
    fleet's merged histograms would be another source). ``gauge_prefix``
    keeps two monitors' gauges distinct in one process."""

    def __init__(self, source=None, gauge_prefix: Optional[str] = None):
        self._lock = threading.Lock()
        #: op -> deque[(t, total, over)]
        self._snaps: Dict[str, "deque"] = {}
        self._last_eval = 0.0
        self._source = source or (
            lambda op: metrics.registry().histogram(f"trace.{op}").snapshot()
        )
        self._prefix = gauge_prefix or metrics.SLO_BURN_PREFIX

    # -- sampling ----------------------------------------------------------
    def evaluate(self, force: bool = False) -> None:
        """Take one snapshot per targeted op (rate-limited to 1/s unless
        forced — gauges and /healthz may poll much faster)."""
        now = _clock()
        sync_breaker_gauges()  # breaker transitions ride the same surface
        targets = config.slo_targets()
        with self._lock:
            # a target with no snapshot yet (just declared) bypasses the
            # rate limit: its first poll must see a burn, not a blank
            fresh = any(op not in self._snaps for op in targets)
            if not force and not fresh and now - self._last_eval < 1.0:
                return
            self._last_eval = now
        slow_s = config.SLO_WINDOW_SLOW_S.to_float() or 3600.0
        for op, target_ms in targets.items():
            snap = self._source(op)
            if snap is None:
                continue
            total, over = _over_count(snap, target_ms)
            with self._lock:
                dq = self._snaps.setdefault(op, deque())
                dq.append((now, total, over))
                # retain one snapshot beyond the slow window so the oldest
                # in-window diff always has a baseline
                while len(dq) > 2 and dq[1][0] < now - slow_s:
                    dq.popleft()
            self._ensure_gauge(op)

    _gauged: set = set()

    def _ensure_gauge(self, op: str) -> None:
        name = f"{self._prefix}.{op}"
        if name in self._gauged:
            return
        with self._lock:
            if name in self._gauged:
                return
            fast_s = config.SLO_WINDOW_FAST_S.to_float() or 300.0
            metrics.registry().gauge(
                name, lambda op=op, w=fast_s: self.burn(op, w),
                replace=True,
            )
            self._gauged.add(name)

    # -- burn arithmetic ---------------------------------------------------
    def burn(self, op: str, window_s: float) -> float:
        """Burn rate for ``op`` over the trailing ``window_s``: bad
        fraction of the window's observations over the 1% p99 budget.
        0.0 with no observations (an idle service burns nothing)."""
        now = _clock()
        with self._lock:
            dq = self._snaps.get(op)
            if not dq:
                return 0.0
            newest = dq[-1]
            base = None
            for t, total, over in dq:
                if t >= now - window_s:
                    break
                base = (t, total, over)
            if base is None:
                # whole history inside the window: diff from zero
                base = (0.0, 0, 0)
        d_total = newest[1] - base[1]
        d_over = newest[2] - base[2]
        if d_total <= 0:
            return 0.0
        return (d_over / d_total) / P99_BUDGET

    def status(self) -> Dict[str, Any]:
        """Per-op burn summary for /healthz and /debug/devices:
        ``{op: {target_ms, fast_burn, slow_burn, hot}}``. ``hot`` = the
        fast window burns past geomesa.slo.burn.threshold (the /healthz
        degradation trigger)."""
        self.evaluate()
        fast_s = config.SLO_WINDOW_FAST_S.to_float() or 300.0
        slow_s = config.SLO_WINDOW_SLOW_S.to_float() or 3600.0
        thresh = config.SLO_BURN_THRESHOLD.to_float() or 14.4
        out: Dict[str, Any] = {}
        for op, target_ms in config.slo_targets().items():
            fast = self.burn(op, fast_s)
            slow = self.burn(op, slow_s)
            out[op] = {
                "target_ms": target_ms,
                "fast_burn": round(fast, 3),
                "slow_burn": round(slow, 3),
                "hot": fast > thresh,
            }
        return out

    def hot_ops(self) -> Dict[str, Any]:
        return {op: s for op, s in self.status().items() if s["hot"]}


_monitor: Optional[SloMonitor] = None
_lock = threading.Lock()


def monitor() -> SloMonitor:
    global _monitor
    m = _monitor
    if m is None:
        with _lock:
            m = _monitor
            if m is None:
                m = _monitor = SloMonitor()
    return m


def reset() -> None:
    """Drop monitor state (test isolation)."""
    global _monitor
    with _lock:
        _monitor = None
    SloMonitor._gauged = set()
    with _breaker_lock:
        _breaker_gauged.clear()
