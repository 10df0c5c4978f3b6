"""Per-device utilization and serving-slot occupancy accounting.

Copy of ``geomesa_tpu/utilization.py``. Busy intervals recorded at the
dispatch sites (the executors' scan launches, the query-axis batches and
the join slices) roll into:

* the ``device.busy.<id>`` gauges: each device's busy fraction over the
  trailing ``geomesa.device.busy.window`` seconds;
* the ``serving.slot.occupancy.<slot>`` gauges, the same per serving slot;
* the ``/debug/devices`` payload (``obs.py``): busy seconds, fractions and
  interval counts, and the queue-wait against device-time breakdown;
* the per-query cost ledger: :func:`record_device` adds
  ``device_ms.<id>`` to the trace the interval belongs to.

What "busy" is differs by device. The reference times the host's dispatch
window with ``perf_counter``; on a CUDA stream that window closes when the
launches return, not when the card finishes them. So on a CUDA tensor's
device, :func:`device_busy` records a pair of
``torch.cuda.Event(enable_timing=True)`` on the current stream around the
same dispatch and keeps it pending. The executors' ``scan.sync`` copies
call :func:`extend_last` after they return, which moves the end of the
thread's last pair past the copy, so the one interval covers the
dispatch's kernels and its copy back. :func:`resolve_pending` turns every
completed pair into its ``elapsed_time`` once the call's own host copy has
synchronized the stream, and never synchronizes by itself.

The interval is therefore the dispatch's window on the card's clock, not
the card's work: it holds the kernels and copies and every gap between
them in which the stream waits for the host to launch the next one. On
the eager main path the card idles through most of it (the window runs
about 8-11x the ``torch.profiler`` union of its kernels, copies and sets
on an H100, PERF.md §2), so ``device_ms.<id>`` is the card-side latency
of a call's dispatches, and ``device.busy.<id>`` and the
``/debug/devices`` totals bound the card's use from above, as the
reference's host windows bound its chip's. On the CPU (the tests) the
interval is the reference's ``perf_counter`` pair. Either way one
dispatch records one interval, and the device id is the torch device's
index (0 for the CPU), as the reference's ``or 0``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List

from geomesa_tpu_torch import config, metrics, tracing

#: injectable clock (tests advance time deterministically)
_clock = time.monotonic


class _Usage:
    """Busy intervals of one key: cumulative totals and a trailing deque of
    (end_time, duration) the busy-fraction gauge reads."""

    __slots__ = ("busy_s", "count", "recent", "lock")

    def __init__(self):
        self.busy_s = 0.0
        self.count = 0
        self.recent: "deque" = deque()
        self.lock = threading.Lock()

    def add(self, seconds: float, now: float) -> None:
        with self.lock:
            self.busy_s += seconds
            self.count += 1
            self.recent.append((now, seconds))
            self._trim(now)

    def _trim(self, now: float) -> None:
        win = _window_s()
        while self.recent and self.recent[0][0] < now - win:
            self.recent.popleft()

    def fraction(self) -> float:
        """Busy fraction over the trailing window: interval durations
        clipped to the window over its length, at most 1.0 (overlapping
        intervals can sum past the wall clock)."""
        now = _clock()
        win = _window_s()
        with self.lock:
            self._trim(now)
            total = 0.0
            for end, dur in self.recent:
                start = end - dur
                total += end - max(start, now - win)
        return min(total / win, 1.0) if win > 0 else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            busy, n = self.busy_s, self.count
        return {
            "busy_s": round(busy, 6),
            "busy_fraction": round(self.fraction(), 4),
            "intervals": n,
        }


def _window_s() -> float:
    try:
        w = config.DEVICE_BUSY_WINDOW.to_float()
    except (TypeError, ValueError):
        w = None
    return 60.0 if w is None or w <= 0 else w


_lock = threading.Lock()
_devices: Dict[int, _Usage] = {}
_slots: Dict[int, _Usage] = {}
_gauged = set()
#: the queue-wait half of the breakdown
_wait = _Usage()


def _usage(table: Dict[int, _Usage], key: int, gauge_name: str) -> _Usage:
    u = table.get(key)
    if u is None:
        with _lock:
            u = table.get(key)
            if u is None:
                u = table[key] = _Usage()
    if gauge_name not in _gauged:
        with _lock:
            if gauge_name not in _gauged:
                # replace: reset() leaves a stale backing the fresh _Usage
                # takes over from
                metrics.registry().gauge(gauge_name, u.fraction, replace=True)
                _gauged.add(gauge_name)
    return u


def _add_cost(trace, key: str, value: float) -> None:
    """``tracing.add_cost`` into a given trace (a pending CUDA pair may
    resolve outside the span context it was recorded in)."""
    if trace is None:
        tracing.add_cost(key, value)
        return
    with trace.lock:
        trace.cost[key] = trace.cost.get(key, 0.0) + value


def record_device(device_id: int, seconds: float, trace=None) -> None:
    """One device busy interval; also adds ``device_ms.<id>`` to the
    active trace's cost ledger (or ``trace``'s)."""
    did = int(device_id)
    _usage(_devices, did,
           f"{metrics.DEVICE_BUSY_PREFIX}.{did}").add(seconds, _clock())
    _add_cost(trace, f"device_ms.{did}", seconds * 1e3)


def record_slot(slot: int, seconds: float) -> None:
    """One serving-slot busy interval."""
    s = int(slot)
    _usage(_slots, s,
           f"{metrics.SLOT_OCCUPANCY_PREFIX}.{s}").add(seconds, _clock())


def record_wait(seconds: float) -> None:
    """One query's queue wait."""
    _wait.add(seconds, _clock())


# -- CUDA event pairs awaiting their stream ------------------------------------

_pending_lock = threading.Lock()
#: [device id, start event, end event, trace or None, stream]
_pending: List[list] = []
#: this thread's last pair (``extend_last``)
_thread = threading.local()


def resolve_pending() -> int:
    """Record every pending CUDA event pair whose end event has completed
    (``Event.query``: no synchronization); pairs still in flight stay
    pending. Returns how many were recorded."""
    with _pending_lock:
        if not _pending:
            return 0
        done = [p for p in _pending if p[2].query()]
        if not done:
            return 0
        _pending[:] = [p for p in _pending if not any(p is d for d in done)]
    for did, e0, e1, trace, _stream in done:
        record_device(did, e0.elapsed_time(e1) / 1e3, trace)
    return len(done)


def extend_last(device=None) -> None:
    """After a scan's synchronous copy to the host: end this thread's last
    pending pair now instead, so its interval covers the copy too (still
    one interval). Nothing on a device other than CUDA."""
    entry = getattr(_thread, "last", None)
    if entry is None or getattr(device, "type", None) != "cuda":
        return
    _thread.last = None
    import torch

    e = torch.cuda.Event(enable_timing=True)
    e.record(entry[4])
    with _pending_lock:
        if any(p is entry for p in _pending):
            entry[2] = e


def pending() -> int:
    """Event pairs not yet resolved."""
    with _pending_lock:
        return len(_pending)


def _device_index(device) -> int:
    if device is None:
        return 0
    idx = getattr(device, "index", device)
    return 0 if idx is None else int(idx)


@contextlib.contextmanager
def device_busy(device=None):
    """Time one device dispatch as a busy interval. ``device`` is a torch
    device (or an id): a CUDA device records an event pair on its current
    stream, resolved later by :func:`resolve_pending` (the dispatch's
    window on the card's clock, gaps included); anything else the
    reference's ``perf_counter`` pair."""
    did = _device_index(device)
    if getattr(device, "type", None) == "cuda":
        import torch

        resolve_pending()
        stream = torch.cuda.current_stream(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        try:
            yield
        finally:
            e1.record(stream)
            cur = tracing.current_span()
            entry = [did, e0, e1, None if cur is None else cur.trace, stream]
            with _pending_lock:
                _pending.append(entry)
            _thread.last = entry
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_device(did, time.perf_counter() - t0)


@contextlib.contextmanager
def slot_busy(slot: int):
    """Time one serving-slot dispatch as a busy interval."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_slot(slot, time.perf_counter() - t0)


def snapshot() -> Dict[str, Any]:
    """The ``/debug/devices`` payload: per-device and per-slot usage and the
    queue-wait against device-time breakdown."""
    resolve_pending()
    with _lock:
        devs = dict(_devices)
        slots = dict(_slots)
    device_busy_s = sum(u.busy_s for u in devs.values())
    return {
        "window_s": _window_s(),
        "devices": {str(k): u.snapshot() for k, u in sorted(devs.items())},
        "slots": {str(k): u.snapshot() for k, u in sorted(slots.items())},
        "breakdown": {
            "queue_wait_s": round(_wait.busy_s, 6),
            "device_time_s": round(device_busy_s, 6),
            "waits": _wait.count,
        },
    }


def reset() -> None:
    """Drop all usage state (test isolation); gauges re-point on next use."""
    global _wait
    with _lock:
        _devices.clear()
        _slots.clear()
        _gauged.clear()
        _wait = _Usage()
    with _pending_lock:
        _pending.clear()

