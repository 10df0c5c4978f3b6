"""Multi-query serving scheduler.

Copy of ``geomesa_tpu/serving/scheduler.py``. Every dataset operation runs
on one dispatch thread per card (or inline on the caller's thread), so
concurrency is a scheduling problem: while one query executes the rest
queue, and whatever is queued can be reordered, shed or fused.

* **Bounded admission.** Requests beyond ``geomesa.serving.queue.depth``
  are rejected at submission with :class:`AdmissionRejectedError`
  (``[GM-OVERLOADED]``), before any planning or device work.
* **Deadline-aware ordering and shedding.** A ticket carries its deadline;
  one that expires while queued, or whose budget is below the estimated
  queue wait at admission, is shed with :class:`DeadlineShedError`
  (``[GM-SHED]``) and never dispatched. Within a user: earliest deadline
  first.
* **Per-user fair share.** The dispatcher serves the pending user with the
  least attained (weighted) service time, not global FIFO.
* **Cross-query fusion.** Queued tickets whose :class:`FuseSpec` keys are
  equal coalesce into one micro-batch run by the spec's ``batch``
  (``serving/fuse.py``). Only already-queued work fuses, and a failing
  batch falls back to serial execution: fusion changes latency, never
  results.
* **One ledger** per user backs both the fair-share policy and the
  ``/debug/queries`` rollups.

Two modes share the code: **inline** (every ``GeoDataset`` owns one;
:meth:`admit` wraps each public op on the caller's thread) and
**dispatch** (:meth:`start`: tickets queue and a pool of
``geomesa.serving.executors`` threads drains them). The pool is clamped to
the healthy card count, which is 1 in the port (``parallel/devices.py``),
so the port runs one dispatch thread; slots beyond one card come with the
multi-GPU item. Streams enqueue *continuation* tickets that bypass the
bounds and run ahead of new queries, pinned to the slot that opened them.

**Respawn.** A dispatcher that dies (a ``BaseException`` escaping its
loop, as a seeded ``serving.slot.loop`` kill raises) is replaced in the
same lock hold that removes it (:meth:`_dispatcher_exit`): no submission
or supervision round ever sees the pool without the slot, and queued
queries wait for the new generation; only the stream continuations that
the dead generation could serve fail, with :class:`DeviceDrainError`
(``[GM-DRAINING]``). The kill point sits at the top of an iteration,
before every wait and after every wake, so an armed kill fires at the
slot's next step whether or not a notify reaches it. The reference fires
it only at the top and after a wake (a kill armed while its slot heads
for ``wait()`` can miss the one wake-up and never fire), and when the
last slot dies it fails every queued ticket before a separate
:meth:`supervise` call respawns it (``tools/reference_lost_wakeup.py``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from geomesa_tpu_torch import config, metrics, resilience as resilience_mod, tracing, utilization
from geomesa_tpu_torch.parallel import devices as pdev
from geomesa_tpu_torch.resilience import (
    AdmissionRejectedError, Deadline, DeadlineShedError, DeviceDrainError,
    current_deadline, deadline_scope,
)

log = logging.getLogger(__name__)


@dataclass
class FuseSpec:
    """Fusion eligibility and group executor of one ticket.

    ``key``: tickets with equal keys may coalesce (``serving/fuse.py``
    derives it from the op, schema, predicate text and op-shape
    parameters). ``payload``: the member's own parameters. ``batch``:
    called with the group's tickets, returns one result per ticket in
    order (None: members run serially). ``schema``: what the placement
    ranking keys its column heat on; ``placement``: the dispatcher's
    placement decision, surfaced on the group span."""

    key: tuple
    payload: Any = None
    batch: Optional[Callable[[List["Ticket"]], List[Any]]] = None
    schema: Optional[str] = None
    placement: Optional[Dict[str, Any]] = None


class FusedMemberError:
    """A per-member failure inside a fused batch that ran: the batch
    executor returns it in place of that member's result and the scheduler
    delivers the wrapped exception to that member alone (no serial
    fallback, which would repeat the device work and the audit events)."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


@dataclass
class Ticket:
    """One admitted request."""

    seq: int
    user: str
    op: str
    fn: Callable[[], Any]
    future: Future
    deadline: Deadline
    submitted_at: float
    fuse: Optional[FuseSpec] = None
    trace_id: Optional[str] = None
    continuation: bool = False
    wait_s: float = 0.0
    #: slot affinity of a continuation (a stream's chunks run on the slot
    #: that opened it)
    slot: Optional[int] = None
    #: the submitter's thread-local config overrides, adopted on the
    #: dispatch thread so a scoped knob resolves alike in both modes
    overrides: Dict[str, str] = field(default_factory=dict)
    #: host-only fallback giving the typed coarse answer when the ticket is
    #: deadline-shed (the client opted in)
    speculative: Optional[Callable[[], Any]] = None
    #: placement: the slot a fuse-bearing ticket was deferred toward, and
    #: when (other slots skip it for the grace window only)
    defer_slot: Optional[int] = None
    defer_at: float = 0.0

    def _order_key(self):
        # earliest deadline first within a user, FIFO among equal deadlines
        exp = self.deadline.expires_at
        return (exp if exp is not None else float("inf"), self.seq)


class _UserLedger:
    """Per-user accounting: the fair-share policy and the /debug/queries
    rollup read the same numbers."""

    __slots__ = ("submitted", "completed", "shed", "rejected", "errors",
                 "fused", "service_s", "wait_s", "last_ts", "weight", "cost")

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.rejected = 0
        self.errors = 0
        self.fused = 0
        self.service_s = 0.0
        self.wait_s = 0.0
        self.last_ts = 0.0
        #: fair-share weight, captured on the submitting thread (the
        #: dispatcher's own config would drop a caller's scoped override)
        self.weight = 1.0
        #: summed cost ledgers of the user's finished traced ops
        self.cost: Dict[str, float] = {}

    def add_cost(self, cost: Optional[Dict[str, float]]) -> None:
        if not cost:
            return
        for k, v in cost.items():
            self.cost[k] = self.cost.get(k, 0.0) + v

    def to_dict(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "rejected": self.rejected,
            "errors": self.errors,
            "fused": self.fused,
            "service_ms": round(self.service_s * 1e3, 3),
            "queue_wait_ms": round(self.wait_s * 1e3, 3),
            "mean_service_ms": round(self.service_s / self.completed * 1e3, 3)
            if self.completed else 0.0,
            "last_ts": self.last_ts,
            "weight": self.weight,
            "cost": {k: round(v, 4) for k, v in sorted(self.cost.items())},
        }


def _default_user() -> str:
    return config.USER.get() or "anonymous"


#: the most recently started scheduler: the serving.queue.depth gauge reads
#: it weakly, so an inline scheduler never takes the gauge over
_live_sched: Optional["weakref.ref[QueryScheduler]"] = None


def _depth_gauge_value() -> float:
    s = _live_sched() if _live_sched is not None else None
    return float(s._pending) if s is not None else 0.0


class QueryScheduler:
    """See the module docstring. Thread-safe; one per dataset."""

    def __init__(self, name: str = "geomesa-serving"):
        self.name = name
        self._cv = threading.Condition()
        self._queues: Dict[str, List[Ticket]] = {}
        self._continuations: "deque[Ticket]" = deque()
        self._pending = 0
        self._ledger: Dict[str, _UserLedger] = {}
        self._seq = 0
        #: slot -> dispatch thread
        self._threads: Dict[int, threading.Thread] = {}
        self._stopped = False
        #: EWMA of recent execution seconds (the admission wait estimate)
        self._ewma_all: Optional[float] = None
        #: users each slot is executing now, and users inside an inline
        #: admit (refcounted): both are shielded from ledger eviction
        self._active_users: Dict[int, set] = {}
        self._inline_users: Dict[str, int] = {}
        #: groups executed per slot
        self._slot_dispatch: Dict[int, int] = {}
        #: supervision: the width start() asked for (0: supervision off),
        #: slots flagged to drain, lifetime respawns
        self._width0 = 0
        self._width_target = 0
        self._draining: set = set()
        self._respawns = 0
        #: per-slot spawn generation: a stream captures its slot's at open,
        #: and a continuation of an older generation fails [GM-DRAINING]
        self._slot_gen: Dict[int, int] = {}
        self._last_supervise = 0.0
        #: placement: schema -> {slot -> last dispatch time}, the probe of
        #: a schema's resident bytes on a slot, and the idle slots
        self._schema_heat: Dict[str, Dict[int, float]] = {}
        self._residency_probe: Optional[Callable[[str, int], int]] = None
        self._idle: set = set()
        self._tls = threading.local()

    @staticmethod
    def _pool_size() -> int:
        """Effective ``geomesa.serving.executors`` ("all": one per healthy
        card), clamped to the healthy card count: two dispatch threads on
        one card would share it."""
        raw = (config.SERVING_EXECUTORS.get() or "1").strip().lower()
        n_dev = pdev.healthy_device_count()
        if raw in ("all", "devices"):
            return n_dev
        try:
            return max(1, min(int(raw), n_dev))
        except ValueError:
            return 1

    # -- introspection -----------------------------------------------------
    @property
    def depth(self) -> int:
        return self._pending

    def user_rollups(self) -> Dict[str, Dict[str, Any]]:
        """Per-user rollup (the /debug/queries ``users`` payload)."""
        with self._cv:
            return {u: led.to_dict() for u, led in self._ledger.items()}

    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "depth": self._pending,
                "users": len(self._ledger),
                "running": bool(self._threads) and not self._stopped,
                "executors": len(self._threads),
                "configured_width": self._width0,
                "respawns": self._respawns,
                "draining": sorted(self._draining),
                "slot_dispatches": dict(self._slot_dispatch),
                "ewma_service_ms": round((self._ewma_all or 0.0) * 1e3, 3),
            }

    def current_slot(self) -> Optional[int]:
        """Slot of the calling dispatch thread (None off the pool)."""
        return getattr(self._tls, "slot", None)

    def current_wait_ms(self) -> float:
        """Queue wait of the ticket executing on this thread (0 outside a
        dispatch)."""
        return getattr(self._tls, "wait_ms", 0.0)

    def current_user(self) -> Optional[str]:
        """The user whose admitted op runs on this thread (a dispatched
        ticket or an inline admit): audit events carry it."""
        return getattr(self._tls, "user", None)

    # -- ledger helpers (call under self._cv) ------------------------------
    def _led(self, user: str) -> _UserLedger:
        led = self._ledger.get(user)
        if led is None:
            if len(self._ledger) >= 4096:
                # bound the map: evict the longest-idle users, never one
                # with queued or running work (that would reset their debt)
                busy = {t.user for t in self._continuations}
                for users in self._active_users.values():
                    busy |= users
                busy |= self._inline_users.keys()
                idle = [u for u in self._ledger if not self._queues.get(u) and u not in busy]
                for u in sorted(idle, key=lambda u: self._ledger[u].last_ts)[:256]:
                    del self._ledger[u]
            led = self._ledger[user] = _UserLedger()
            led.last_ts = time.time()
        return led

    def _note_service(self, user: str, op: str, seconds: float, ewma: bool = True,
                      cost: Optional[Dict[str, float]] = None) -> None:
        with self._cv:
            led = self._led(user)
            led.completed += 1
            led.service_s += seconds
            led.last_ts = time.time()
            led.add_cost(cost)
            if ewma:
                self._ewma_update_locked(seconds)
        metrics.inc(metrics.SERVING_COMPLETED)

    @staticmethod
    def _take_cost() -> Optional[Dict[str, float]]:
        """The cost ledger of the trace this thread just finished (None
        when the op did not trace)."""
        tr = tracing.pop_thread_trace()
        if tr is None:
            return None
        with tr.lock:
            return dict(tr.cost) or None

    def _ewma_update_locked(self, seconds: float) -> None:
        """One sample of the admission estimate. Continuations and failures
        never feed it, and a fused batch feeds one sample for the batch."""
        a = 0.2
        self._ewma_all = seconds if self._ewma_all is None \
            else (1 - a) * self._ewma_all + a * seconds

    # -- admission ---------------------------------------------------------
    def submit(self, fn: Callable[[], Any], user: Optional[str] = None,
               op: str = "op", fuse: Optional[FuseSpec] = None,
               budget_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               continuation: bool = False,
               slot: Optional[int] = None,
               slot_gen: Optional[int] = None,
               speculative: Optional[Callable[[], Any]] = None) -> Future:
        """Queue one request (needs :meth:`start`). Raises
        :class:`AdmissionRejectedError` when the queue is full and
        :class:`DeadlineShedError` when the budget cannot be met, both
        before any work. ``budget_s`` None inherits the submitter's
        deadline scope. ``slot`` pins a continuation; ``slot_gen`` is the
        generation its stream opened under, and a mismatch raises
        :class:`DeviceDrainError`. ``speculative``: a host-only fallback
        that answers a deadline shed (here or at dispatch) instead of
        ``[GM-SHED]``; the request still counts as shed."""
        user = user or _default_user()
        self.supervise(throttle=True)
        deadline = Deadline.after(budget_s) if budget_s is not None else current_deadline()
        fut: Future = Future()
        with self._cv:
            if self._stopped or not self._threads:
                raise RuntimeError("serving scheduler is not running")
            if continuation and slot is not None and (
                slot not in self._threads
                or (slot_gen is not None and self._slot_gen.get(slot) != slot_gen)
            ):
                # the stream's dispatcher died or drained since it opened:
                # it must re-open, not resume
                raise DeviceDrainError(
                    f"serving executor slot {slot} died or was respawned "
                    "since this stream opened; re-open the stream"
                )
            led = self._led(user)
            # every attempt counts, shed and rejected ones included
            led.submitted += 1
            led.last_ts = time.time()
            led.weight = config.user_weight(user)
            shed_speculative = False
            if not continuation:
                cap = config.SERVING_QUEUE_DEPTH.to_int()
                cap = 256 if cap is None else cap
                if self._pending >= cap:
                    led.rejected += 1
                    metrics.inc(metrics.SERVING_SHED_QUEUE_FULL)
                    raise AdmissionRejectedError(self._pending)
                shed_msg = self._admission_shed_locked(deadline)
                if shed_msg is not None:
                    led.shed += 1
                    metrics.inc(metrics.SERVING_SHED_DEADLINE)
                    if speculative is None:
                        raise DeadlineShedError(shed_msg)
                    shed_speculative = True  # resolved outside the lock
            if not shed_speculative:
                self._seq += 1
                t = Ticket(
                    seq=self._seq, user=user, op=op, fn=fn, future=fut,
                    deadline=deadline, submitted_at=time.perf_counter(),
                    fuse=fuse if config.SERVING_FUSION.to_bool() else None,
                    trace_id=trace_id, continuation=continuation,
                    overrides=config.snapshot_overrides(),
                    slot=slot if continuation else None,
                    speculative=speculative,
                )
                if continuation:
                    self._continuations.append(t)
                else:
                    self._queues.setdefault(user, []).append(t)
                self._pending += 1
                metrics.inc(metrics.SERVING_ADMITTED)
                # notify_all: a pinned continuation must wake its own slot
                self._cv.notify_all()
        if shed_speculative:
            self._resolve_speculative(fut, speculative)
        return fut

    @staticmethod
    def _resolve_speculative(fut: Future, speculative: Callable) -> None:
        """Answer a shed request with its coarse host answer (never under
        the scheduler lock); a failing fallback surfaces as the shed."""
        try:
            out = speculative()
        except Exception as e:
            fut.set_exception(DeadlineShedError(f"query shed (speculative fallback failed: {e!r})"))
            return
        fut.set_result(out)

    def _admission_shed_locked(self, deadline: Deadline) -> Optional[str]:
        """A deadline already expired, or below the estimated queue wait,
        cannot be met."""
        rem = deadline.remaining_s()
        if rem is None:
            return None
        if rem <= 0:
            return "query shed at admission: deadline already expired before any work was scheduled"
        if not config.SERVING_SHED_ESTIMATE.to_bool():
            return None
        # queued queries only: continuations stay out of the EWMA
        n_queries = sum(len(q) for q in self._queues.values())
        if self._ewma_all is not None and n_queries > 0:
            est = self._ewma_all * (n_queries + 1)
            if est > rem:
                return (
                    f"query shed at admission: estimated queue wait {est * 1e3:.0f} ms "
                    f"exceeds the {rem * 1e3:.0f} ms deadline budget"
                )
        return None

    def run(self, fn: Callable[[], Any], user: Optional[str] = None,
            op: str = "op", fuse: Optional[FuseSpec] = None,
            budget_s: Optional[float] = None,
            trace_id: Optional[str] = None,
            continuation: bool = False,
            slot: Optional[int] = None,
            slot_gen: Optional[int] = None):
        """Submit and wait; without a dispatch thread, run inline under
        admission accounting (a continuation then raises)."""
        if not self._threads:
            if continuation:
                raise RuntimeError("serving scheduler stopped")
            ctx = deadline_scope(budget_s) if budget_s is not None else contextlib.nullcontext()
            with ctx, self.admit(op, user=user):
                return fn()
        fut = self.submit(fn, user=user, op=op, fuse=fuse, budget_s=budget_s,
                          trace_id=trace_id, continuation=continuation, slot=slot,
                          slot_gen=slot_gen)
        return fut.result()

    def iterate(self, it, user: Optional[str] = None, op: str = "stream"):
        """Drive iterator ``it`` with every ``next`` on the dispatch thread,
        each chunk a continuation ticket (never bounded or shed) pinned to
        the slot that opened the stream, under that slot's generation."""
        pin = self.current_slot()
        if pin is None and len(self._threads) > 1:
            pin = 0
        gen = None
        if pin is not None:
            with self._cv:
                gen = self._slot_gen.get(pin)
        done = object()
        while True:
            item = self.run(lambda: next(it, done), user=user, op=op,
                            continuation=True, slot=pin, slot_gen=gen)
            if item is done:
                return
            yield item

    @contextlib.contextmanager
    def admit(self, op: str, user: Optional[str] = None,
              inflight_cap: Optional[int] = None):
        """Local-path admission around one public op: sheds typed when the
        caller's deadline is already expired and accounts the op into the
        ledger. Reentrant (a nested op accounts once) and a no-op inside a
        dispatched ticket. ``inflight_cap`` bounds concurrent inline
        admissions (beyond it: :class:`AdmissionRejectedError`)."""
        depth = getattr(self._tls, "admit_depth", 0)
        if depth or getattr(self._tls, "in_dispatch", False):
            self._tls.admit_depth = depth + 1
            try:
                yield
            finally:
                self._tls.admit_depth = depth
            return
        user = user or _default_user()
        rem = current_deadline().remaining_s()
        # inline admission sheds only an expired deadline: an estimate shed
        # here would livelock (a shed op never runs, so the estimate could
        # never decay); in-scan deadline checks are the backstop
        shed = "query shed at admission: deadline already expired before any work" \
            if rem is not None and rem <= 0 else None
        rejected = None
        with self._cv:
            led = self._led(user)
            led.submitted += 1
            led.last_ts = time.time()
            led.weight = config.user_weight(user)
            if shed is not None:
                led.shed += 1
            elif inflight_cap is not None and sum(self._inline_users.values()) >= inflight_cap:
                led.rejected += 1
                rejected = sum(self._inline_users.values())
            else:
                self._inline_users[user] = self._inline_users.get(user, 0) + 1
        if rejected is not None:
            metrics.inc(metrics.SERVING_SHED_QUEUE_FULL)
            raise AdmissionRejectedError(rejected)
        if shed is not None:
            metrics.inc(metrics.SERVING_SHED_DEADLINE)
            raise DeadlineShedError(shed)
        self._tls.admit_depth = 1
        self._tls.user = user
        t0 = time.perf_counter()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            with self._cv:
                self._led(user).errors += 1
            raise
        finally:
            self._tls.admit_depth = 0
            self._tls.user = None
            with self._cv:
                n = self._inline_users.get(user, 0) - 1
                if n > 0:
                    self._inline_users[user] = n
                else:
                    self._inline_users.pop(user, None)
            # failures stay out of the EWMA; the op's root trace is still
            # open here, so its cost is read from the active trace
            self._note_service(user, op, time.perf_counter() - t0, ewma=ok,
                               cost=tracing.current_cost() or None)

    # -- dispatch ----------------------------------------------------------
    def _spawn_locked(self, slot: int) -> None:
        """Start slot ``slot``'s dispatcher as a new generation (under
        ``_cv``)."""
        t = threading.Thread(target=self._loop, args=(slot,), daemon=True,
                             name=self.name if slot == 0 else f"{self.name}-{slot}")
        self._threads[slot] = t
        self._slot_gen[slot] = self._slot_gen.get(slot, 0) + 1
        t.start()

    def start(self) -> "QueryScheduler":
        """Spawn the dispatch pool (idempotent), ``geomesa.serving.executors``
        wide after the clamp. The started scheduler backs the process's
        serving.queue.depth gauge."""
        global _live_sched
        n = self._pool_size()
        pdev.register_pool(self, n)
        with self._cv:
            self._stopped = False
            self._width0 = self._width_target = n
            self._draining.clear()
            for slot in range(n):
                t = self._threads.get(slot)
                if t is None or not t.is_alive():
                    self._spawn_locked(slot)
                # else: a timed-out stop()'s thread is still draining its
                # query; clearing _stopped re-adopts it as the dispatcher
            width = len(self._threads)
        pdev.register_pool(self, width)
        _live_sched = weakref.ref(self)
        metrics.registry().gauge(metrics.SERVING_QUEUE_DEPTH, _depth_gauge_value, replace=True)
        return self

    def stop(self) -> None:
        """Stop dispatching; queued tickets fail (their callers must not
        wait forever)."""
        with self._cv:
            self._stopped = True
            self._width0 = 0  # an intentional stop is not a death
            self._draining.clear()
            stranded = list(self._continuations)
            self._continuations.clear()
            for q in self._queues.values():
                stranded.extend(q)
            self._queues.clear()
            self._pending = 0
            self._cv.notify_all()
            threads = list(self._threads.values())
        for tk in stranded:
            tk.future.set_exception(RuntimeError("serving scheduler stopped"))
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        # a timed-out join leaves the thread registered, so a later start()
        # re-adopts it, and keeps the card claimed until it exits
        if not any(t.is_alive() and t is not threading.current_thread() for t in threads):
            pdev.unregister_pool(self)

    def _target_width(self) -> int:
        """The configured width clamped to the healthy card count, at
        least 1."""
        return max(1, min(self._width0, pdev.healthy_device_count()))

    def supervise(self, throttle: bool = False) -> Dict[str, Any]:
        """One supervision round: re-clamp the pool to the healthy card
        count (slots beyond it drain: they exit typed at their next
        wake-up, failing their pinned continuations with
        :class:`DeviceDrainError`) and start any slot within it that has
        no live thread. A dead dispatcher is already replaced in
        :meth:`_dispatcher_exit`, so this round only repairs a width
        change. ``throttle`` (the submit and wake-up paths) skips the
        round while the pool is whole and a round ran in the last 0.25 s."""
        out: Dict[str, Any] = {"respawned": [], "draining": [], "width": 0}
        if self._width0 <= 0:
            return out
        if throttle:
            now = time.monotonic()
            if len(self._threads) >= self._width_target and not self._draining \
                    and now - self._last_supervise < 0.25:
                return out
            self._last_supervise = now
        with self._cv:
            if self._stopped or self._width0 <= 0:
                return out
            # computed and applied under one lock hold: a stale target must
            # never respawn a slot a newer round drained
            target = self._width_target = self._target_width()
            for slot in list(self._threads):
                if slot >= target and slot not in self._draining:
                    self._draining.add(slot)
                    out["draining"].append(slot)
            for slot in range(target):
                t = self._threads.get(slot)
                if (t is None or not t.is_alive()) and slot not in self._draining:
                    self._spawn_locked(slot)
                    out["respawned"].append(slot)
            self._respawns += len(out["respawned"])
            out["width"] = len(self._threads)
            if out["draining"] or out["respawned"]:
                self._cv.notify_all()
        for slot in out["respawned"]:
            metrics.inc(metrics.SERVING_SLOT_RESPAWN)
            metrics.inc(f"{metrics.SERVING_SLOT_RESPAWN}.{slot}")
        if out["respawned"] or out["draining"]:
            pdev.register_pool(self, max(out["width"], 1))
        return out

    def wait_respawns(self, n: int, timeout: float) -> bool:
        """Block until the lifetime respawn count reaches ``n`` (False on
        ``timeout``): a respawn notifies ``_cv``, so no caller polls."""
        with self._cv:
            return self._cv.wait_for(lambda: self._respawns >= n, timeout)

    def _has_work_locked(self, slot: int) -> bool:
        """Anything this slot may dispatch? Queries go to any slot,
        continuations only to their pinned slot."""
        if any(self._queues.values()):
            return True
        return any(t.slot is None or t.slot == slot for t in self._continuations)

    def _loop(self, slot: int = 0):
        self._tls.slot = slot
        try:
            while True:
                # filled in place, so the except arm below can fail tickets
                # that left the queue before a failure in assembly
                group: List[Ticket] = []
                drained: Optional[List[Ticket]] = None
                try:
                    resilience_mod.fault_point("serving.slot.loop", slot=slot)
                    self.supervise(throttle=True)
                    with self._cv:
                        while not self._stopped and slot not in self._draining \
                                and not self._has_work_locked(slot):
                            # the kill point before every wait and after every
                            # wake: a kill armed while this slot ran fires
                            # here, with no notify needed (the reference's
                            # point after the wake alone misses a kill armed
                            # before the slot reaches wait() when a sibling
                            # takes the one wake-up's ticket)
                            resilience_mod.fault_point("serving.slot.loop", slot=slot, wake=False)
                            self._idle.add(slot)
                            try:
                                self._cv.wait()
                            finally:
                                self._idle.discard(slot)
                            resilience_mod.fault_point("serving.slot.loop", slot=slot, wake=True)
                        if slot in self._draining and not self._stopped:
                            drained = self._drain_exit_locked(slot)
                        elif self._stopped:
                            # the exit handshake under the lock: start() never
                            # sees a live-looking thread about to return
                            if self._threads.get(slot) is threading.current_thread():
                                del self._threads[slot]
                            if not self._threads:
                                pdev.unregister_pool(self)
                            return
                        if drained is None:
                            self._next_group_locked(group, slot)
                            if not group and self._has_work_locked(slot):
                                # everything queued is reserved for another
                                # slot within its grace window
                                self._cv.wait(self._placement_grace_s())
                            self._note_heat_locked(group, slot)
                            self._active_users[slot] = {t.user for t in group}
                    if drained is not None:
                        self._fail_drained(slot, drained)
                        with self._cv:
                            width = len(self._threads)
                        pdev.register_pool(self, max(width, 1))
                        return
                    if group:
                        with self._cv:
                            self._slot_dispatch[slot] = self._slot_dispatch.get(slot, 0) + 1
                        metrics.inc(f"{metrics.SERVING_EXECUTOR_DISPATCH}.{slot}")
                        with utilization.slot_busy(slot):
                            self._execute_group(group)
                except Exception as e:
                    # a dispatcher survives what one dispatch can throw
                    # (ticket errors land on futures in _execute_one)
                    log.exception("serving dispatch iteration failed")
                    for t in group:
                        if not t.future.done():
                            t.future.set_exception(e)
                finally:
                    with self._cv:
                        self._active_users.pop(slot, None)
        finally:
            self._dispatcher_exit(slot)

    def _drain_exit_locked(self, slot: int) -> List[Ticket]:
        """Remove this slot under a width re-clamp (under ``_cv``); returns
        its pinned continuations for the caller to fail outside the lock."""
        self._draining.discard(slot)
        if self._threads.get(slot) is threading.current_thread():
            del self._threads[slot]
        stranded = [t for t in self._continuations if t.slot == slot]
        for t in stranded:
            self._continuations.remove(t)
        self._pending -= len(stranded)
        return stranded

    def _fail_drained(self, slot: int, stranded: List[Ticket]) -> None:
        """Fail a drained slot's pinned continuations ``[GM-DRAINING]`` and
        flag their traces."""
        metrics.inc(f"{metrics.SERVING_SLOT_DIED}.drained")
        for tk in stranded:
            tracing.mark_slot_died(tk.trace_id, slot, reason="drained")
            if not tk.future.done():
                tk.future.set_exception(DeviceDrainError(
                    f"serving executor slot {slot} drained (pool width "
                    "re-clamped after a device cordon); re-open the stream"
                ))

    def _dispatcher_exit(self, slot: int = 0) -> None:
        """The thread's last act. A dispatcher still registered here was
        not removed on purpose (stop and drain remove it first): it died.
        Its replacement starts in the same lock hold that removes it, so no
        submission or supervision round sees the pool without the slot and
        no wake-up is needed for the repair. The continuations that only
        the dead generation could serve fail typed; queued queries stay for
        the new dispatcher. With nothing left to serve them (a stop), every
        queued ticket fails."""
        died = False
        with self._cv:
            self._draining.discard(slot)
            if self._threads.get(slot) is threading.current_thread():
                del self._threads[slot]
                died = not self._stopped
            siblings = bool(self._threads)
            stranded = [t for t in self._continuations
                        if t.slot == slot or (t.slot is None and not siblings)]
            for t in stranded:
                self._continuations.remove(t)
            self._pending -= len(stranded)
            respawned = died and self._width0 > 0 and slot < self._target_width()
            if respawned:
                self._spawn_locked(slot)
                self._respawns += 1
                self._cv.notify_all()
            elif not self._threads:
                for q in self._queues.values():
                    stranded.extend(q)
                self._queues.clear()
                stranded.extend(self._continuations)
                self._continuations.clear()
                self._pending = 0
            last = not self._threads
        if died:
            # a death is never silent: counted, and every stranded stream's
            # trace is flagged slot_died (kept by tail sampling)
            metrics.inc(metrics.SERVING_SLOT_DIED)
            metrics.inc(f"{metrics.SERVING_SLOT_DIED}.{slot}")
        if respawned:
            metrics.inc(metrics.SERVING_SLOT_RESPAWN)
            metrics.inc(f"{metrics.SERVING_SLOT_RESPAWN}.{slot}")
        for tk in stranded:
            tracing.mark_slot_died(tk.trace_id, slot, reason="died")
            if not tk.future.done():
                tk.future.set_exception(DeviceDrainError(
                    f"serving executor slot {slot} dispatcher exited; re-open the stream"
                    if tk.continuation else "serving dispatch thread exited"
                ))
        if last:
            pdev.unregister_pool(self)

    def _users_by_share_locked(self) -> List[str]:
        """Users with pending work in dispatch order: least attained
        weighted service first (FIFO head breaks ties), or FIFO across
        users with ``geomesa.serving.fair-share`` off."""
        users = [u for u, q in self._queues.items() if q]
        if not users:
            return users
        if not config.SERVING_FAIR_SHARE.to_bool():
            return sorted(users, key=lambda u: min(t.seq for t in self._queues[u]))
        return sorted(
            users,
            key=lambda u: (
                self._led(u).service_s / (self._led(u).weight or 1.0),
                min(t.seq for t in self._queues[u]),
            ),
        )

    @contextlib.contextmanager
    def member_user(self, user: Optional[str]):
        """Attribute work on this thread to ``user`` for a while: a distinct
        group's serial fallback runs each member's public call on the
        dispatch thread, whose user is the group primary's."""
        prev = getattr(self._tls, "user", None)
        self._tls.user = user
        try:
            yield
        finally:
            self._tls.user = prev

    # -- pool-aware fusion placement ---------------------------------------
    def set_residency_probe(self, fn: Optional[Callable[[str, int], int]]) -> None:
        """Install ``fn(schema, slot)``: the schema's card-resident column
        bytes on that slot's card now (metadata reads only: it runs under
        the scheduler lock). Without it the ranking is by recency."""
        with self._cv:
            self._residency_probe = fn

    def _rank_slot_locked(self, schema: str, slot: int) -> Optional[int]:
        """The best slot for ``schema`` by resident bytes, then recency, or
        None when none beats ``slot`` itself."""
        heat = self._schema_heat.get(schema)
        if not heat:
            return None
        probe = self._residency_probe
        alive = [s for s in heat if s in self._threads]
        if not alive:
            return None

        def score(s: int):
            res = 0
            if probe is not None:
                try:
                    res = int(probe(schema, s))
                except Exception:
                    res = 0  # a torn cache walk never fails dispatch
            return (res, heat.get(s, float("-inf")))

        scores = {s: score(s) for s in set(alive) | {slot}}
        best = max(alive, key=scores.__getitem__)
        if best == slot or scores[best] <= scores[slot]:
            return None
        return best

    def _placement_grace_s(self) -> float:
        g = config.SERVING_PLACEMENT_GRACE_MS.to_int()
        return (50 if g is None else max(g, 0)) / 1e3

    def _defer_ok_locked(self, t: Ticket, slot: int, now: float) -> bool:
        """May this slot take ``t``? A deferred ticket is reserved for its
        preferred slot within the grace window only."""
        if t.defer_slot is None or t.defer_slot == slot:
            return True
        if t.defer_slot not in self._threads:
            return True
        return (now - t.defer_at) > self._placement_grace_s()

    def _defer_for_placement_locked(self, head: Ticket, slot: int, now: float) -> bool:
        """Defer a fuse-bearing head once toward the idle slot holding most
        of its schema's columns; never on a pool of one slot."""
        if (head.fuse is None or head.fuse.schema is None
                or head.continuation or head.defer_slot is not None
                or len(self._threads) <= 1
                or not config.SERVING_PLACEMENT.to_bool()):
            return False
        pref = self._rank_slot_locked(head.fuse.schema, slot)
        if pref is None or pref not in self._idle:
            return False
        head.defer_slot = pref
        head.defer_at = now
        head.fuse.placement = {
            "preferred": pref, "deferred_from": slot,
            "reason": "column-residency" if self._residency_probe is not None else "column-heat",
        }
        metrics.inc(metrics.SERVING_PLACEMENT_DEFER)
        self._cv.notify_all()
        return True

    def _note_heat_locked(self, group: List[Ticket], slot: int) -> None:
        """Record which slot just scanned each fused schema."""
        for t in group:
            if t.fuse is not None and t.fuse.schema is not None:
                self._schema_heat.setdefault(t.fuse.schema, {})[slot] = time.perf_counter()
                if t.fuse.placement is not None and "slot" not in t.fuse.placement:
                    t.fuse.placement["slot"] = slot
                    bound = t.fuse.placement.get("preferred") == slot
                    t.fuse.placement["bound"] = bound
                    if bound:
                        metrics.inc(metrics.SERVING_PLACEMENT_BOUND)

    def _next_group_locked(self, group: List[Ticket], slot: int = 0) -> List[Ticket]:
        """Fill ``group`` in place: a pinned or free continuation first;
        else the fair-share head and every queued ticket with its fusion
        key and config overrides (in submission order, up to
        ``geomesa.serving.fusion.max``)."""
        for t in self._continuations:
            if t.slot is None or t.slot == slot:
                self._continuations.remove(t)
                self._pending -= 1
                group.append(t)
                return group
        now = time.perf_counter()
        while True:
            head = None
            for user in self._users_by_share_locked():
                eligible = [t for t in self._queues[user] if self._defer_ok_locked(t, slot, now)]
                if eligible:
                    head = min(eligible, key=Ticket._order_key)
                    break
            if head is None:
                return group
            if not self._defer_for_placement_locked(head, slot, now):
                break
        q = self._queues[user]
        q.remove(head)
        self._pending -= 1
        group.append(head)
        cap = config.SERVING_FUSION_MAX.to_int()
        cap = 16 if cap is None else cap
        if head.fuse is not None and cap > 1:
            cands: List[Ticket] = []
            for uq in self._queues.values():
                cands.extend(
                    t for t in uq
                    if t.fuse is not None and t.fuse.key == head.fuse.key
                    # the batch runs under the primary's overrides
                    and t.overrides == head.overrides
                )
            cands.sort(key=lambda t: t.seq)
            for t in cands[: cap - 1]:
                self._queues[t.user].remove(t)
                self._pending -= 1
                group.append(t)
        for u in {t.user for t in group}:
            if not self._queues.get(u):
                self._queues.pop(u, None)
        return group

    def _shed_ticket(self, t: Ticket) -> None:
        with self._cv:
            self._led(t.user).shed += 1
        metrics.inc(metrics.SERVING_SHED_DEADLINE)
        if t.speculative is not None:
            self._resolve_speculative(t.future, t.speculative)
            return
        t.future.set_exception(DeadlineShedError(
            f"query shed before dispatch: deadline expired after "
            f"{t.wait_s * 1e3:.0f} ms queued (no device work was done)"
        ))

    def _execute_group(self, group: List[Ticket]) -> None:
        now = time.perf_counter()
        wait_hist = metrics.registry().histogram(metrics.SERVING_QUEUE_WAIT)
        live: List[Ticket] = []
        for t in group:
            t.wait_s = now - t.submitted_at
            if not t.continuation:
                wait_hist.observe(t.wait_s)
                utilization.record_wait(t.wait_s)
                with self._cv:
                    self._led(t.user).wait_s += t.wait_s
            # shed before work: a deadline that lapsed in the queue
            # (continuations are never shed mid-stream)
            if t.deadline.expired and not t.continuation:
                self._shed_ticket(t)
            else:
                live.append(t)
        if not live:
            return
        if len(live) > 1 and live[0].fuse is not None and live[0].fuse.batch is not None:
            if self._execute_fused(live):
                return
        for t in live:
            self._execute_one(t)

    def _execute_fused(self, group: List[Ticket]) -> bool:
        """One pass for the whole group; False falls back to serial."""
        head = group[0]
        t0 = time.perf_counter()
        self._tls.in_dispatch = True
        self._tls.wait_ms = head.wait_s * 1e3
        self._tls.user = head.user
        prev_ov = config.snapshot_overrides()
        config.adopt_overrides(head.overrides)
        tracing.pop_thread_trace()  # a previous ticket's residue
        try:
            results = head.fuse.batch(group)
        except BaseException as e:
            if not isinstance(e, Exception):
                # an interrupt during the batch: relay it to every member
                # rather than kill the dispatcher or rerun serially
                for t in group:
                    with self._cv:
                        self._led(t.user).errors += 1
                    t.future.set_exception(e)
                return True
            log.warning("fused batch of %d %s queries failed (%r); degrading to "
                        "per-query execution", len(group), head.op, e)
            return False
        finally:
            config.adopt_overrides(prev_ov)
            self._tls.in_dispatch = False
            self._tls.wait_ms = 0.0
            self._tls.user = None
        if results is None or len(results) != len(group):
            log.warning("fused batch executor returned %s results for %d members; "
                        "degrading to per-query execution",
                        "no" if results is None else len(results), len(group))
            return False
        elapsed = time.perf_counter() - t0
        metrics.registry().histogram(
            metrics.SERVING_FUSION_BATCH, buckets=metrics.FUSION_BATCH_BUCKETS, unit=None,
        ).observe(float(len(group)))
        metrics.inc(metrics.SERVING_FUSED, len(group))
        share = elapsed / len(group)
        # the batch ran under the primary's trace: its cost splits evenly
        batch_cost = self._take_cost()
        cost_share = {k: v / len(group) for k, v in batch_cost.items()} if batch_cost else None
        for t, r in zip(group, results):
            with self._cv:
                self._led(t.user).fused += 1
            self._note_service(t.user, t.op, share, ewma=False, cost=cost_share)
            if isinstance(r, FusedMemberError):
                t.future.set_exception(r.error)
            else:
                t.future.set_result(r)
        with self._cv:
            self._ewma_update_locked(elapsed)
        return True

    def _execute_one(self, t: Ticket) -> None:
        t0 = time.perf_counter()
        self._tls.in_dispatch = True
        self._tls.wait_ms = t.wait_s * 1e3
        self._tls.user = t.user
        prev_ov = config.snapshot_overrides()
        config.adopt_overrides(t.overrides)
        tracing.pop_thread_trace()
        try:
            out = t.fn()
        except BaseException as e:  # noqa: B036 - relayed to the caller
            with self._cv:
                self._led(t.user).errors += 1
            self._note_service(t.user, t.op, time.perf_counter() - t0, ewma=False,
                               cost=self._take_cost())
            t.future.set_exception(e)
            return
        finally:
            config.adopt_overrides(prev_ov)
            self._tls.in_dispatch = False
            self._tls.wait_ms = 0.0
            self._tls.user = None
        self._note_service(t.user, t.op, time.perf_counter() - t0,
                           ewma=not t.continuation, cost=self._take_cost())
        t.future.set_result(out)
