"""Per-device health: circuit breakers and cordons.

Copy of ``geomesa_tpu/parallel/health.py``, cut to one card. Every device
carries:

* a circuit breaker (``resilience.breaker("device:<id>")``): consecutive
  failed dispatches (``geomesa.device.breaker.threshold``) open it (state
  ``broken``), and the normal half-open trial after
  ``geomesa.device.breaker.reset.ms`` restores it;
* an explicit cordon: operator action (:meth:`DeviceHealthRegistry.cordon`)
  or the ``geomesa.mesh.cordon`` knob removes the device from scheduling
  without a restart and without touching its breaker;
* the ``device.health.<id>`` gauge: 1 ok, 0 cordoned, -1 broken.

``obs.py`` serves :meth:`DeviceHealthRegistry.snapshot` at
``/debug/devices`` and the :meth:`DeviceHealthRegistry.summary` digest in
``/healthz``. The latency-outlier detector and the reassignment of a failed
device's partitions need the sharded scan over several cards, which the
port has not yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Set

from geomesa_tpu_torch import config, metrics, resilience

#: health states (gauge values)
OK, CORDONED, BROKEN = "ok", "cordoned", "broken"
_GAUGE_VALUE = {OK: 1.0, CORDONED: 0.0, BROKEN: -1.0}


def _cordon_config_ids() -> Set[int]:
    """Device ids cordoned through ``geomesa.mesh.cordon``."""
    raw = (config.MESH_CORDON.get() or "").strip()
    if not raw:
        return set()
    out: Set[int] = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if tok:
            try:
                out.add(int(tok))
            except ValueError:
                pass  # a malformed token never un-cordons the valid ones
    return out


class DeviceHealthRegistry:
    """Process-wide per-device health state, by torch device index."""

    def __init__(self):
        self._lock = threading.Lock()
        #: explicit cordons: id -> reason (the knob is read separately)
        self._cordoned: Dict[int, str] = {}
        self._last_failure: Dict[int, str] = {}
        self._failures: Dict[int, int] = {}
        self._gauged: Set[int] = set()

    def _breaker(self, did: int) -> resilience.CircuitBreaker:
        """The device's breaker, in the process-wide named registry (so
        ``/healthz`` lists it; obs.py treats ``device:*`` breakers as soft
        degradation)."""
        return resilience.breaker(
            f"device:{did}",
            threshold=config.DEVICE_BREAKER_THRESHOLD.to_int() or 3,
            reset_ms=config.DEVICE_BREAKER_RESET_MS.to_float() or 30_000.0,
        )

    def _ensure_gauge(self, did: int) -> None:
        if did in self._gauged:
            return
        with self._lock:
            if did in self._gauged:
                return
            self._gauged.add(did)
        metrics.registry().gauge(
            f"{metrics.DEVICE_HEALTH_PREFIX}.{did}",
            lambda d=did: _GAUGE_VALUE[self.state(d)],
            replace=True,
        )

    # -- state -------------------------------------------------------------
    def cordon_reason(self, did: int) -> Optional[str]:
        with self._lock:
            reason = self._cordoned.get(did)
        if reason is not None:
            return reason
        if did in _cordon_config_ids():
            return "geomesa.mesh.cordon"
        return None

    def state(self, did: int) -> str:
        """``ok``, ``cordoned`` or ``broken`` (breaker open, or half-open
        awaiting its trial)."""
        if self.cordon_reason(did) is not None:
            return CORDONED
        if self._breaker(did).state != resilience.CircuitBreaker.CLOSED:
            return BROKEN
        return OK

    # -- operator surface --------------------------------------------------
    def cordon(self, did: int, reason: str = "operator") -> None:
        """Remove a device from scheduling (until :meth:`uncordon`)."""
        self._ensure_gauge(did)
        with self._lock:
            self._cordoned[int(did)] = str(reason)

    def uncordon(self, did: int) -> bool:
        """Re-admit an explicitly cordoned device; False when it was not
        cordoned here (a knob cordon clears by unsetting the knob)."""
        with self._lock:
            return self._cordoned.pop(int(did), None) is not None

    # -- fault bookkeeping -------------------------------------------------
    def record_failure(self, did: int, error: BaseException) -> None:
        """One failed dispatch on ``did``: feeds its breaker."""
        self._ensure_gauge(did)
        self._breaker(did).record_failure()
        with self._lock:
            self._failures[did] = self._failures.get(did, 0) + 1
            self._last_failure[did] = repr(error)[:300]

    def record_success(self, did: int) -> None:
        """One successful dispatch: closes a half-open trial."""
        self._breaker(did).record_success()

    # -- operator payloads -------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-device payload (``/debug/devices``): state, breaker state,
        cordon reason, failures, reassignments (always 0 on one card) and
        the last failure."""
        with self._lock:
            ids = set(self._gauged) | set(self._cordoned) | set(self._last_failure)
            cordons = dict(self._cordoned)
            failures = dict(self._failures)
            last = dict(self._last_failure)
        ids |= _cordon_config_ids()
        out: Dict[str, Dict[str, Any]] = {}
        for did in sorted(ids):
            entry: Dict[str, Any] = {
                "state": self.state(did),
                "breaker": self._breaker(did).state,
                "failures": failures.get(did, 0),
                "reassigned": 0,
            }
            reason = cordons.get(did) or (
                "geomesa.mesh.cordon" if did in _cordon_config_ids() else None)
            if reason is not None:
                entry["cordon_reason"] = reason
            if did in last:
                entry["last_failure"] = last[did]
            out[str(did)] = entry
        return out

    def summary(self, total_devices: int) -> Dict[str, Any]:
        """The ``/healthz`` capacity digest: cordoned and broken ids and how
        many of ``total_devices`` remain schedulable."""
        cordoned: List[int] = []
        broken: List[int] = []
        for did in range(max(int(total_devices), 0)):
            st = self.state(did)
            if st == CORDONED:
                cordoned.append(did)
            elif st == BROKEN:
                broken.append(did)
        usable = max(int(total_devices), 0) - len(cordoned) - len(broken)
        return {"total": int(total_devices), "usable": usable,
                "cordoned": cordoned, "broken": broken}


_registry = DeviceHealthRegistry()


def registry() -> DeviceHealthRegistry:
    return _registry


def reset() -> None:
    """A fresh registry (test isolation); the ``device:*`` breakers stay
    (pair with ``resilience.reset_breakers()``)."""
    global _registry
    _registry = DeviceHealthRegistry()
