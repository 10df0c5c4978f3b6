"""Fault points, the skip trail and durable file publishes.

Copy of the parts of ``geomesa_tpu/resilience.py`` that the mutation
journal and the checkpoint call:

* :func:`fault_point` with :class:`FaultInjector`, :class:`InjectedFault`
  and :func:`inject_faults`: named I/O edges that crash tests drive. Inert
  (one global load) unless an injector is installed, which
  ``geomesa.fault.injection`` must allow.
* :func:`record_skip`: a record that failed to apply during journal replay
  is skipped and kept as a :class:`Skipped` in a process-local list
  (:func:`skipped`). The reference also feeds its audit trail and tracing;
  the port has neither yet.
* :func:`fsync_dir`, :func:`durable_replace` and
  :func:`durable_write_json`: the tmp-then-rename publish with file and
  directory fsyncs, so a crash leaves either the old or the new file.

The retry policies, deadlines, breakers and the partial-result scopes of
the reference's scan paths are not here yet.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from geomesa_tpu_torch import config


class InjectedFault(RuntimeError):
    """Default error type raised by a fault-injection rule."""


# -- deterministic fault injection ----------------------------------------------------------

@dataclass
class _FaultRule:
    pattern: str
    error: Any                      # exception instance, type or factory
    times: Optional[int] = None     # None: every matching hit
    hits: int = 0                   # matched (after times gating)
    #: the rule matches only where ``where(ctx)`` is truthy (ctx: the
    #: fault point's keyword arguments)
    where: Optional[Callable[[Dict[str, Any]], bool]] = None


class FaultInjector:
    """Registry of fault rules matched against fault-point names
    (``fnmatch`` patterns: ``journal.*``, ``fs.save.manifest``, ...)."""

    def __init__(self):
        self._rules: List[_FaultRule] = []
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str]] = []  # (site, error repr)

    def fail(self, pattern: str, error: Any = None, times: Optional[int] = 1,
             where: Optional[Callable[[Dict[str, Any]], bool]] = None) -> _FaultRule:
        """Arm a rule. ``error``: an exception instance or type, or a
        zero-argument factory (default :class:`InjectedFault`);
        ``times=None`` fires on every match."""
        rule = _FaultRule(pattern, error, times, where=where)
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
                rule.hits += 1
                err = self._materialize(rule, site)
                self.fired.append((site, repr(err)))
                break
            else:
                return
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


def inject_faults() -> _InjectScope:
    """Install a process-global :class:`FaultInjector` for the scope (it
    fires on every thread, the journal's committer included)."""
    return _InjectScope(FaultInjector())


# -- the skip trail ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Skipped:
    """One unit of work that was skipped, and why."""

    source: str        # e.g. "journal.replay"
    part: str          # schema@seq, partition or file
    error: str         # repr of the failure
    phase: str = ""    # optional sub-phase ("apply", ...)


_skipped: List[Skipped] = []
_skipped_lock = threading.Lock()


def record_skip(source: str, part: str, error: BaseException,
                phase: str = "") -> Skipped:
    """Record one skipped unit in the process-local trail."""
    rec = Skipped(source=source, part=str(part), error=repr(error), phase=phase)
    with _skipped_lock:
        _skipped.append(rec)
    return rec


def skipped(clear: bool = False) -> List[Skipped]:
    """The skip trail so far (``clear``: and empty it)."""
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
