"""Retry policies, deadlines, fault points and the degradation contract.

Copy of the parts of ``geomesa_tpu/resilience.py`` that the port's scan,
spill, lake, join and journal paths call:

* :class:`RetryPolicy`: exponential backoff with full jitter from a seeded
  ``random.Random``, so a seed gives the reference's backoff schedule draw
  for draw; ``from_config`` reads ``geomesa.retry.*``.
  :func:`transient_os_error` says which ``OSError`` a file edge retries.
* :class:`Deadline`, :func:`deadline_scope`, :func:`adopt_deadline`,
  :func:`current_deadline` and :func:`check_deadline`: a thread-local
  wall-clock budget (``geomesa.query.timeout``) checked between scan
  phases, never inside a kernel; an expiry raises
  :class:`QueryTimeoutError`.
* :func:`fault_point` with a seeded :class:`FaultInjector`
  (:func:`inject_faults`): named I/O edges that tests and drills drive; a
  rule may fire with a probability ``p`` from the injector's seeded RNG
  and sleep ``delay_s`` before it raises. Inert (one global load) unless
  an injector is installed, which ``geomesa.fault.injection`` must allow.
* The degradation contract: strict mode (the default) re-raises a
  failing partition or join slice; inside :func:`allow_partial` (or with
  ``geomesa.scan.partial``) the scan records it with :func:`record_skip`
  and goes on, and the answer is exact over the survivors.
  :func:`record_skip` feeds the innermost :class:`DegradationCollector`
  a process-local trail (:func:`skipped`), the audit log's
  ``DegradationEvent`` trail, and marks the current trace degraded.
* :func:`fsync_dir`, :func:`durable_replace` and
  :func:`durable_write_json`: the tmp-then-rename publish with file and
  directory fsyncs, so a crash leaves either the old or the new file.

* :class:`CircuitBreaker` and the named registry (:func:`breaker`,
  :func:`breaker_states`, :func:`reset_breakers`): ``threshold``
  consecutive failures open a circuit; after ``reset_ms`` one trial call
  is admitted (half-open). The trace exporter's sinks, the storage roots
  (:func:`guarded_root_io`) and each device (``parallel/health.py``) sit
  behind one; ``/healthz`` reads their states.

* The serving errors: :class:`DeadlineShedError` (``[GM-SHED]``),
  :class:`AdmissionRejectedError` (``[GM-OVERLOADED]``) and
  :class:`DeviceDrainError` (``[GM-DRAINING]``), raised by
  ``serving/scheduler.py`` before any device work or for a stranded
  stream.

``PartialResult`` (with ``fs/storage.py``) and ``FleetPartialError`` (with
the fleet) are not here yet.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, TypeVar

from geomesa_tpu_torch import audit, config, tracing

T = TypeVar("T")


class QueryTimeoutError(RuntimeError):
    """A scan exceeded its :class:`Deadline` (``geomesa.query.timeout``)."""


class DeadlineShedError(QueryTimeoutError):
    """A query SHED by the serving scheduler: dropped at admission or at
    dispatch because its deadline budget cannot be met (already expired,
    expired while queued, or smaller than the estimated queue wait),
    before any planning or device work. A :class:`QueryTimeoutError`, so
    deadline-aware callers classify it as a timeout; ``retry_after_s`` is
    advisory (0: do not retry)."""

    code = "GM-SHED"

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class AdmissionRejectedError(RuntimeError):
    """The serving scheduler's bounded admission queue is full:
    backpressure, not failure (retry with backoff)."""

    code = "GM-OVERLOADED"

    def __init__(self, depth: int):
        super().__init__(
            f"admission queue full ({depth} queued); retry with backoff or "
            "raise geomesa.serving.queue.depth"
        )
        self.depth = depth


class DeviceDrainError(RuntimeError):
    """Serving work rejected or stranded because its executor slot was
    drained: the slot's dispatcher died, or the pool was re-clamped. The
    device work in flight is not known to have committed, so a stream
    re-opens instead of resuming."""

    code = "GM-DRAINING"


class CircuitOpenError(RuntimeError):
    """Raised by :meth:`CircuitBreaker.allow` while the breaker is open:
    the callee has failed repeatedly and calls are fenced off until the
    reset window elapses."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit {name!r} is open (retry after {retry_after_s:.1f}s)"
        )
        self.breaker_name = name
        self.retry_after_s = retry_after_s


class InjectedFault(RuntimeError):
    """Default error type raised by a fault-injection rule."""


# -- retry policy ------------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Exponential backoff with full jitter from a seeded RNG.

    ``attempts`` is the total number of tries (1: no retry). The delay
    before retry ``i`` (1-based) is ``min(base_ms * 2**(i-1), max_ms)``
    scaled by ``1 - jitter * rng.random()``, the same draws as the
    reference's for the same seed."""

    attempts: int = 3
    base_ms: float = 50.0
    max_ms: float = 5_000.0
    jitter: float = 0.2
    seed: Optional[int] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    @staticmethod
    def from_config(seed: Optional[int] = None) -> "RetryPolicy":
        """The policy of the ``geomesa.retry.*`` knobs. An explicit 0 is a
        setting (no delay, no retry); only an unset knob takes the
        default, and an unset jitter is 0, as in the reference."""
        def cfg(v, default):
            return default if v is None else v

        return RetryPolicy(
            attempts=cfg(config.RETRY_ATTEMPTS.to_int(), 3),
            base_ms=cfg(config.RETRY_BASE_MS.to_float(), 50.0),
            max_ms=cfg(config.RETRY_MAX_MS.to_float(), 5_000.0),
            jitter=cfg(config.RETRY_JITTER.to_float(), 0.0),
            seed=seed,
        )

    def delays_ms(self) -> List[float]:
        """The backoff schedule of this policy's retries (draws from the
        RNG: one call per schedule run)."""
        out = []
        for i in range(max(self.attempts - 1, 0)):
            d = min(self.base_ms * (2.0 ** i), self.max_ms)
            if self.jitter:
                d *= 1.0 - self.jitter * self._rng.random()
            out.append(d)
        return out

    def call(self, fn: Callable[[], T],
             retryable: Callable[[BaseException], bool] = lambda e: True,
             deadline: "Optional[Deadline]" = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None) -> T:
        """Run ``fn`` with retries. ``retryable(exc)`` gates each retry; a
        live ``deadline`` stops retrying once its budget is spent and trims
        each sleep to what is left."""
        last: Optional[BaseException] = None
        attempts = max(self.attempts, 1)  # 0 or negative: still one try
        for attempt in range(1, attempts + 1):
            try:
                return fn()
            except Exception as e:  # KeyboardInterrupt / SystemExit propagate
                last = e
                if attempt >= attempts or not retryable(e):
                    raise
                d = min(self.base_ms * (2.0 ** (attempt - 1)), self.max_ms)
                if self.jitter:
                    d *= 1.0 - self.jitter * self._rng.random()
                if deadline is not None:
                    rem = deadline.remaining_s()
                    if rem is not None:
                        if rem <= 0:
                            raise
                        d = min(d, rem * 1000.0)
                if on_retry is not None:
                    on_retry(attempt, e)
                if d > 0:
                    self.sleep(d / 1000.0)
        raise last  # pragma: no cover (the loop returns or raises)


def transient_os_error(e: BaseException) -> bool:
    """Whether a file edge (spill store and load) retries ``e``: fd
    pressure and network-filesystem blips do; a missing file, a wrong node
    type or a denied permission fail at once, since a retry meets the same
    error."""
    return isinstance(e, OSError) and not isinstance(
        e, (FileNotFoundError, IsADirectoryError, NotADirectoryError, PermissionError))


# -- deadlines --------------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Count-based breaker: ``threshold`` consecutive failures open the
    circuit; after ``reset_ms`` ONE trial call is admitted (half-open):
    success closes, failure re-opens. While that trial is in flight every
    other caller is fenced with :class:`CircuitOpenError`. ``clock`` is
    injectable so tests advance time deterministically."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, name: str, threshold: Optional[int] = None,
                 reset_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.threshold = threshold if threshold is not None else (
            config.BREAKER_THRESHOLD.to_int() or 5
        )
        self.reset_ms = reset_ms if reset_ms is not None else (
            config.BREAKER_RESET_MS.to_float() or 30_000.0
        )
        self.clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._trial_in_flight = False
        self._trial_started = 0.0
        self._trial_thread: Optional[int] = None

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        if self._state == self.OPEN and (
            (self.clock() - self._opened_at) * 1000.0 >= self.reset_ms
        ):
            return self.HALF_OPEN
        return self._state

    def allow(self) -> None:
        """Raise :class:`CircuitOpenError` unless a call may proceed. In
        half-open, admits one caller as the trial; concurrent callers are
        fenced until the trial resolves, or until a full reset window has
        passed since it started (a trial whose caller died never wedges
        the breaker half-open)."""
        with self._lock:
            st = self._effective_state()
            if st == self.OPEN:
                rem = self.reset_ms / 1000.0 - (self.clock() - self._opened_at)
                raise CircuitOpenError(self.name, max(rem, 0.0))
            if st == self.HALF_OPEN:
                if self._trial_in_flight:
                    stale = ((self.clock() - self._trial_started) * 1000.0
                             >= self.reset_ms)
                    if not stale:
                        rem = (self.reset_ms / 1000.0
                               - (self.clock() - self._trial_started))
                        raise CircuitOpenError(self.name, max(rem, 0.0))
                self._state = self.HALF_OPEN
                self._trial_in_flight = True
                self._trial_started = self.clock()
                self._trial_thread = threading.get_ident()

    def record_success(self) -> None:
        with self._lock:
            if (
                self._state == self.HALF_OPEN
                and self._trial_in_flight
                and self._trial_thread is not None
                and threading.get_ident() != self._trial_thread
            ):
                # a superseded trial reporting late must not close the
                # circuit over the live trial
                return
            self._failures = 0
            self._state = self.CLOSED
            self._trial_in_flight = False
            self._trial_thread = None

    def record_failure(self) -> None:
        # failures count from any caller, a superseded trial's too
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or self._failures >= self.threshold:
                self._state = self.OPEN
                self._opened_at = self.clock()
            self._trial_in_flight = False
            self._trial_thread = None

    def trip(self) -> None:
        """Force the circuit open whatever the failure count; recovery
        follows the normal half-open trial after ``reset_ms``."""
        with self._lock:
            self._failures = max(self._failures, self.threshold)
            self._state = self.OPEN
            self._opened_at = self.clock()
            self._trial_in_flight = False
            self._trial_thread = None


_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker(name: str, **kw) -> CircuitBreaker:
    """The process-wide breaker of ``name`` (made on first use with
    ``kw``)."""
    with _breakers_lock:
        b = _breakers.get(name)
        if b is None:
            b = _breakers[name] = CircuitBreaker(name, **kw)
        return b


def guarded_root_io(root: str, fn):
    """Run one storage-root I/O under the root's ``fs.root:<abspath>``
    breaker: an open circuit fences fast, a transient ``OSError`` charges
    the breaker, success resets it. ``FileNotFoundError`` never charges (a
    missing file says nothing about the mount)."""
    br = breaker("fs.root:" + os.path.abspath(root))
    br.allow()
    try:
        out = fn()
    except OSError as e:
        if not isinstance(e, FileNotFoundError):
            br.record_failure()
        raise
    br.record_success()
    return out


def reset_breakers() -> None:
    """Drop all registered breakers (test isolation)."""
    with _breakers_lock:
        _breakers.clear()


def breaker_states() -> Dict[str, str]:
    """name -> effective state of every registered breaker (``/healthz``)."""
    with _breakers_lock:
        items = list(_breakers.items())
    return {name: b.state for name, b in items}


_deadline_local = threading.local()


@dataclass(frozen=True)
class Deadline:
    """A wall-clock budget on ``time.monotonic()``; ``expires_at`` None is
    unlimited (checks are no-ops)."""

    expires_at: Optional[float]

    @staticmethod
    def after(timeout_s: Optional[float]) -> "Deadline":
        return Deadline(None if timeout_s is None else time.monotonic() + timeout_s)

    def remaining_s(self) -> Optional[float]:
        if self.expires_at is None:
            return None
        return self.expires_at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.expires_at is not None and time.monotonic() > self.expires_at

    def check(self, what: str = "query") -> None:
        if self.expired:
            raise QueryTimeoutError(
                f"{what} exceeded geomesa.query.timeout; narrow the filter "
                "or raise the timeout"
            )


UNLIMITED = Deadline(None)


def current_deadline() -> Deadline:
    """The innermost deadline scope of this thread (UNLIMITED when none)."""
    d = getattr(_deadline_local, "stack", None)
    return d[-1] if d else UNLIMITED


class _DeadlineScope:
    def __init__(self, deadline: Deadline):
        self.deadline = deadline

    def __enter__(self) -> Deadline:
        stack = getattr(_deadline_local, "stack", None)
        if stack is None:
            stack = _deadline_local.stack = []
        stack.append(self.deadline)
        self._stack = stack  # a generator may exit on another thread
        return self.deadline

    def __exit__(self, *exc):
        # remove this scope's own deadline from the stack it entered, even
        # if other scopes interleaved
        try:
            self._stack.remove(self.deadline)
        except ValueError:
            pass
        return False


def deadline_scope(timeout_s: Optional[float]) -> _DeadlineScope:
    """Scope a deadline of ``timeout_s`` seconds (None: unlimited) over
    this thread; scopes nest and :func:`check_deadline` reads the
    innermost."""
    return _DeadlineScope(Deadline.after(timeout_s))


def adopt_deadline(deadline: Deadline) -> _DeadlineScope:
    """Install an existing deadline as this thread's innermost scope: a
    worker serving a query re-enters the caller's
    :func:`current_deadline`, so one budget bounds both threads."""
    return _DeadlineScope(deadline)


def check_deadline(what: str = "query") -> None:
    """Raise :class:`QueryTimeoutError` if the innermost deadline passed.
    Called between host passes, before device dispatches and per
    partition: a kernel is not interrupted, so a query stops at the end of
    the phase that was running."""
    current_deadline().check(what)


# -- deterministic fault injection ----------------------------------------------------------

@dataclass
class _FaultRule:
    pattern: str
    error: Any                      # exception instance, type or factory
    times: Optional[int] = None     # None: every matching hit
    p: float = 1.0                  # probability per hit (the injector's RNG)
    delay_s: float = 0.0            # sleep before raising
    hits: int = 0                   # matched (after p and times gating)
    #: the rule matches only where ``where(ctx)`` is truthy (ctx: the
    #: fault point's keyword arguments)
    where: Optional[Callable[[Dict[str, Any]], bool]] = None


class FaultInjector:
    """Seeded registry of fault rules matched against fault-point names
    (``fnmatch`` patterns: ``journal.*``, ``exec.partition.scan``, ...)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: List[_FaultRule] = []
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str]] = []  # (site, error repr)

    def fail(self, pattern: str, error: Any = None, times: Optional[int] = 1,
             p: float = 1.0, delay_s: float = 0.0,
             where: Optional[Callable[[Dict[str, Any]], bool]] = None) -> _FaultRule:
        """Arm a rule. ``error``: an exception instance or type, or a
        zero-argument factory (default :class:`InjectedFault`);
        ``times=None`` fires on every match; ``p`` < 1 fires a match with
        that probability (seeded); ``delay_s`` sleeps before the raise."""
        rule = _FaultRule(pattern, error, times, p, delay_s, where=where)
        with self._lock:
            self._rules.append(rule)
        return rule

    @staticmethod
    def _materialize(rule: _FaultRule, site: str) -> BaseException:
        err = rule.error
        if err is None:
            return InjectedFault(f"injected fault at {site}")
        if isinstance(err, BaseException):
            return err
        out = err()  # a type or a factory
        return out if isinstance(out, BaseException) else InjectedFault(str(out))

    def fire(self, site: str, ctx: Dict[str, Any]) -> None:
        with self._lock:
            for rule in self._rules:
                if not fnmatch.fnmatch(site, rule.pattern):
                    continue
                if rule.times is not None and rule.hits >= rule.times:
                    continue
                if rule.where is not None and not rule.where(ctx):
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.hits += 1
                err = self._materialize(rule, site)
                self.fired.append((site, repr(err)))
                delay = rule.delay_s
                break
            else:
                return
        if delay:
            time.sleep(delay)
        raise err


_injector: Optional[FaultInjector] = None


def fault_point(site: str, **ctx: Any) -> None:
    """An instrumented I/O edge: a no-op unless an injector is installed
    through :func:`inject_faults`."""
    inj = _injector
    if inj is None:
        return
    inj.fire(site, ctx)


class _InjectScope:
    def __init__(self, injector: FaultInjector):
        self.injector = injector

    def __enter__(self) -> FaultInjector:
        global _injector
        if not config.FAULT_INJECTION.to_bool():
            raise RuntimeError(
                "fault injection requires geomesa.fault.injection=true "
                "(scoped or via GEOMESA_FAULT_INJECTION)"
            )
        if _injector is not None:
            raise RuntimeError("a fault injector is already installed")
        _injector = self.injector
        return self.injector

    def __exit__(self, *exc):
        global _injector
        _injector = None
        return False


def inject_faults(seed: int = 0) -> _InjectScope:
    """Install a process-global seeded :class:`FaultInjector` for the
    scope (it fires on every thread, the journal's committer and the
    prefetch worker included)."""
    return _InjectScope(FaultInjector(seed))


# -- the degradation contract ------------------------------------------------------------------

@dataclass(frozen=True)
class Skipped:
    """One unit of work that was skipped, and why."""

    source: str        # e.g. "exec.partition.scan", "journal.replay"
    part: str          # partition ("bin:<b>"), join slice, schema@seq
    error: str         # repr of the failure
    phase: str = ""    # optional sub-phase ("count", "load", "apply", ...)


class DegradationCollector:
    """The :class:`Skipped` records of one operation, installed on its
    thread by :func:`allow_partial`."""

    def __init__(self):
        self.skipped: List[Skipped] = []
        self._lock = threading.Lock()

    @property
    def degraded(self) -> bool:
        return bool(self.skipped)

    def add(self, rec: Skipped) -> None:
        with self._lock:
            self.skipped.append(rec)


_partial_local = threading.local()


def _collectors() -> List[DegradationCollector]:
    st = getattr(_partial_local, "stack", None)
    if st is None:
        st = _partial_local.stack = []
    return st


class _PartialScope:
    def __enter__(self) -> DegradationCollector:
        c = DegradationCollector()
        _collectors().append(c)
        return c

    def __exit__(self, *exc):
        _collectors().pop()
        return False


def allow_partial() -> _PartialScope:
    """``with allow_partial() as partial:`` a failing partition or join
    slice inside the scope is skipped and recorded instead of raising;
    ``partial.skipped`` holds the account. Scopes nest; records land in
    the innermost collector. A deadline is never degraded."""
    return _PartialScope()


def partial_allowed() -> bool:
    """Whether the current operation may degrade: inside
    :func:`allow_partial`, or with ``geomesa.scan.partial`` set."""
    if _collectors():
        return True
    return bool(config.SCAN_PARTIAL.to_bool())


_skipped: List[Skipped] = []
_skipped_lock = threading.Lock()


def record_skip(source: str, part: str, error: BaseException,
                phase: str = "") -> Skipped:
    """Record one skipped unit: into the innermost collector (if any), the
    process-local trail and the audit log's degradation trail
    (``audit.degradations``), and mark the current trace degraded. The
    caller decides whether to go on (:func:`partial_allowed`)."""
    rec = Skipped(source=source, part=str(part), error=repr(error), phase=phase)
    st = _collectors()
    if st:
        st[-1].add(rec)
    with _skipped_lock:
        _skipped.append(rec)
    audit.record_degradation(rec)
    tracing.mark_degraded()
    return rec


def skipped(clear: bool = False) -> List[Skipped]:
    """The process-local skip trail so far (``clear``: and empty it)."""
    with _skipped_lock:
        out = list(_skipped)
        if clear:
            _skipped.clear()
    return out


# -- durable tmp-then-rename publish ------------------------------------------------------------

def fsync_dir(path: str) -> None:
    """fsync a directory so a rename or create inside it is durable. A
    filesystem that refuses a directory fsync keeps the rename atomic, just
    not provably durable; the refusal is swallowed."""
    try:
        dirfd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dirfd)
    except OSError:
        pass
    finally:
        os.close(dirfd)


def durable_replace(tmp: str, path: str) -> None:
    """``os.replace`` + parent-directory fsync. The tmp file must already
    be written and fsynced."""
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def durable_write_json(path: str, obj: Any, indent: Optional[int] = None) -> None:
    """Crash-safe JSON publish: same-directory tmp, write, flush, file
    fsync, atomic replace, directory fsync."""
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(obj, fh, indent=indent)
            fh.flush()
            os.fsync(fh.fileno())
        durable_replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
