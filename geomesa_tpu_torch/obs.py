"""The live observability surface: ``/metrics``, ``/healthz`` and the debug
endpoints.

Copy of ``geomesa_tpu/obs.py``: a stdlib ``ThreadingHTTPServer`` over the
process's operational state.

    GET /metrics        prometheus text (counters, gauges, timers and
                        histograms with their buckets: the trace.<stage>
                        span histograms, kernel.recompiles[.<site>], the
                        recompile alert, device.busy.<id>, ...); a scraper
                        asking for application/openmetrics-text gets the
                        OpenMetrics exposition with exemplars
    GET /healthz        JSON health: circuit-breaker states, quarantine
                        counters, journal lag, the card's reachability,
                        the device-health digest and SLO burn; 200 when
                        healthy or softly degraded, 503 when a breaker
                        other than a device's is open, an SLO burns, or no
                        device is usable
    GET /debug/queries  JSON: recent audit events, the degradation trail
                        and slow-query span trees (?n=, ?user=, ?op=);
                        ?trace=<id> returns one retained span tree
    GET /debug/devices  JSON: per-device busy fractions and totals (the
                        dispatch windows of ``utilization.py``: an upper
                        bound of the card's use), the per-device health
                        map and the SLO burn summary
    GET /debug/heat     JSON: per-(schema, cell) access heat
    GET /debug/fleet, /metrics/fleet, /healthz/fleet
                        what the reference answers in a process that runs
                        no fleet router (the port has none): an empty
                        router list, and 404 for the other two

The device probe lists ``torch.cuda.get_device_name(i)`` for each card,
in a daemon thread under a timeout, and caches the answer; a host with no
card reports ``unreachable``, never the CPU as an accelerator.
:func:`handle` routes one GET path (tests and embedding servers call it
directly); :func:`serve` runs the standalone endpoint.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from geomesa_tpu_torch import metrics, tracing

#: OpenMetrics content type served when the scraper negotiates it
OPENMETRICS_CTYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def metrics_text(openmetrics: bool = False) -> str:
    """The /metrics payload: the classic prometheus text, or with
    ``openmetrics`` the OpenMetrics exposition (exemplars on histogram
    buckets and the ``# EOF`` trailer)."""
    from geomesa_tpu_torch import utilization

    utilization.resolve_pending()
    text = metrics.registry().prometheus(exemplars=openmetrics)
    return text + "# EOF\n" if openmetrics else text


# -- device reachability -------------------------------------------------------
# the first CUDA call of a process can block on a wedged device, so the probe
# runs on a daemon thread with a short join and caches the answer

_device_lock = threading.Lock()
_device_state: Dict[str, Any] = {"status": "unknown", "checked_at": 0.0}
_DEVICE_TTL_S = 60.0


def _list_cards():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false)")
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def _probe_devices(timeout_s: float = 2.0, lister=None) -> Dict[str, Any]:
    """``{"status": "ok", "devices": [names]}``, or ``unreachable`` with the
    error (no card, a failing CUDA runtime, or a probe that hung past
    ``timeout_s``)."""
    out: Dict[str, Any] = {}
    lister = lister or _list_cards

    def probe():
        try:
            out["devices"] = list(lister())
            out["status"] = "ok"
        except Exception as e:
            out["status"] = "unreachable"
            out["error"] = repr(e)[:200]

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return {"status": "unreachable",
                "error": f"device probe hung > {timeout_s}s (wedged device?)"}
    return out


def device_health() -> Dict[str, Any]:
    """Cached card reachability (a TTL, so /healthz polling never hammers,
    or hangs again on, the CUDA runtime)."""
    with _device_lock:
        if time.monotonic() - _device_state.get("checked_at", 0.0) < _DEVICE_TTL_S \
                and _device_state.get("status") != "unknown":
            return {k: v for k, v in _device_state.items() if k != "checked_at"}
    probed = _probe_devices()
    with _device_lock:
        _device_state.clear()
        _device_state.update(probed)
        _device_state["checked_at"] = time.monotonic()
    return probed


def _journal_lag() -> Dict[str, int]:
    """Per-root journal records appended and not yet durable (empty in a
    process that never opened a journal)."""
    mod = sys.modules.get("geomesa_tpu_torch.fs.journal")
    if mod is None:
        return {}
    try:
        return mod.lag_snapshot()
    except Exception:  # pragma: no cover - defensive
        return {}


def health() -> Dict[str, Any]:
    """The /healthz payload. ``status`` is ``degraded`` while a breaker is
    open, an SLO's fast window burns past ``geomesa.slo.burn.threshold``,
    or a device is cordoned or broken. Device-level degradation is soft
    while capacity remains (``soft: true``, HTTP 200); an open non-device
    breaker, a burning SLO or no usable device is hard (503)."""
    from geomesa_tpu_torch import slo
    from geomesa_tpu_torch.parallel import health as phealth

    breakers = slo.sync_breaker_gauges()
    report = metrics.registry().report()
    quarantine = {
        name: v for name, v in report.items()
        if "quarantin" in name and isinstance(v, (int, float)) and v
    }
    open_breakers = [n for n, s in breakers.items() if s == "open"]
    hard_breakers = [n for n in open_breakers if not n.startswith("device:")]
    slo_status = slo.monitor().status()
    slo_hot = {op: s for op, s in slo_status.items() if s["hot"]}
    dev = device_health()
    total_devices = len(dev.get("devices") or ())
    mesh = phealth.registry().summary(total_devices)
    mesh_degraded = bool(mesh["cordoned"] or mesh["broken"])
    no_capacity = total_devices > 0 and mesh["usable"] <= 0
    hard = bool(hard_breakers or slo_hot or no_capacity)
    degraded = hard or mesh_degraded or bool(open_breakers)
    out = {
        "status": "degraded" if degraded else "ok",
        "soft": bool(degraded and not hard),
        "breakers": breakers,
        "open_breakers": open_breakers,
        "quarantine": quarantine,
        # the reference's per-root storage quarantine maps: the port has
        # no fs/storage.py yet
        "fs_quarantine": {},
        "journal": _journal_lag(),
        "device": dev,
        "mesh": mesh,
        "tracing": tracing.enabled(),
    }
    if open_breakers:
        out["breaker_note"] = (
            "breaker open: " + ", ".join(sorted(open_breakers))
            + " — see slo.breaker.* gauges"
        )
    if slo_status:
        out["slo"] = slo_status
        if slo_hot:
            out["slo_burning"] = sorted(slo_hot)
    return out


def debug_queries(dataset=None, n: int = 50, user: Optional[str] = None,
                  op: Optional[str] = None) -> Dict[str, Any]:
    """The /debug/queries payload: recent audit events of ``dataset``, the
    degradation trail and slow traces (process-wide). ``user`` / ``op``
    filter before the ``n`` cap. The port runs no serving scheduler or
    standing queries, so ``users``, ``serving`` and ``subscriptions`` are
    empty."""
    from geomesa_tpu_torch import audit as audit_mod

    events = []
    user_tids = None
    if dataset is not None:
        raw = dataset.audit.recent(n if user is None and op is None else 10_000)
        events = [json.loads(e.to_json()) for e in raw]
        if user is not None:
            events = [e for e in events if e.get("user") == user]
            # slow traces carry no user: join through the trace id
            user_tids = {e.get("hints", {}).get("trace_id") for e in events} - {None}
        if op is not None:
            events = [e for e in events if e.get("hints", {}).get("op") == op]
        events = events[-n:]
    degraded = [json.loads(e.to_json()) for e in audit_mod.degradations.recent(n)]
    slow = tracing.slow_traces(10_000 if (op is not None or user is not None) else n)
    if op is not None:
        slow = [s for s in slow if s.get("tree", {}).get("name") == op]
    if user is not None:
        slow = [s for s in slow if s.get("trace_id") in (user_tids or ())]
    return {
        "queries": events,
        "degradations": degraded,
        "slow_traces": slow[-n:],
        "users": {},
        "serving": {},
        "subscriptions": {"groups": [], "subscribers": 0},
    }


def trace_lookup(trace_id: str) -> Optional[Dict[str, Any]]:
    """The /debug/queries?trace=<id> payload: the retained trace, or None
    (no fleet stitcher runs in the port)."""
    return tracing.finished_trace(trace_id)


def debug_heat(top: Optional[int] = None) -> Dict[str, Any]:
    """The /debug/heat payload: this process's cell-heat table."""
    from geomesa_tpu_torch import heat

    return {"local": heat.snapshot(top)}


def debug_devices(dataset=None) -> Dict[str, Any]:
    """The /debug/devices payload: per-device utilization, the queue-wait
    against device-time breakdown, the SLO burn summary and the per-device
    health map."""
    from geomesa_tpu_torch import slo, utilization
    from geomesa_tpu_torch.parallel import health as phealth

    out = utilization.snapshot()
    out["slo"] = slo.monitor().status()
    out["health"] = phealth.registry().snapshot()
    return out


def _json(code: int, obj) -> tuple:
    return code, "application/json", json.dumps(obj, default=str).encode()


_NO_ROUTER = {"error": "no live fleet router in this process"}


def handle(path: str, dataset=None, accept: Optional[str] = None):
    """Route one GET path to (status, content type, body bytes), or None
    when the path is no observability route. ``accept`` is the request's
    Accept header (OpenMetrics negotiation on /metrics)."""
    parsed = urllib.parse.urlparse(path)
    q = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
    route = parsed.path.rstrip("/") or "/"
    if route == "/metrics":
        if accept and "application/openmetrics-text" in accept:
            return 200, OPENMETRICS_CTYPE, metrics_text(openmetrics=True).encode()
        return 200, "text/plain; version=0.0.4", metrics_text().encode()
    if route in ("/metrics/fleet", "/healthz/fleet"):
        return _json(404, _NO_ROUTER)
    if route == "/debug/heat":
        try:
            top = max(1, min(int(q["top"]), 10_000)) if "top" in q else None
        except ValueError:
            return _json(400, {"error": "?top= must be an integer"})
        return _json(200, debug_heat(top))
    if route == "/healthz":
        h = health()
        code = 200 if h["status"] == "ok" or h.get("soft") else 503
        return code, "application/json", json.dumps(h).encode()
    if route == "/debug/queries":
        if "trace" in q:
            rec = trace_lookup(q["trace"])
            if rec is None:
                return _json(404, {"error": f"trace {q['trace']!r} not retained here"})
            return _json(200, rec)
        try:
            n = max(1, min(int(q.get("n", "50")), 10_000))
        except ValueError:
            return _json(400, {"error": "?n= must be an integer"})
        return _json(200, debug_queries(dataset, n, user=q.get("user"), op=q.get("op")))
    if route == "/debug/devices":
        return _json(200, debug_devices(dataset))
    if route == "/debug/fleet":
        return _json(200, {"routers": []})
    return None


class _ObsHandler(BaseHTTPRequestHandler):
    dataset = None  # injected by serve()

    def log_message(self, fmt, *args):  # noqa: D102 - quiet stderr
        pass

    def do_GET(self):  # noqa: N802
        try:
            out = handle(self.path, self.dataset, accept=self.headers.get("Accept"))
        except Exception as e:  # pragma: no cover - defensive
            out = _json(500, {"error": f"{type(e).__name__}: {e}"})
        if out is None:
            out = _json(404, {"error": f"unknown path {self.path!r}"})
        code, ctype, body = out
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve(dataset=None, host: str = "127.0.0.1", port: int = 9090,
          background: bool = False) -> ThreadingHTTPServer:
    """Serve the routes above. ``background=True`` runs the server on a
    daemon thread and returns it (``shutdown()`` / ``server_close()`` stop
    it); otherwise it serves until interrupted."""
    handler = type("ObsHandler", (_ObsHandler,), {"dataset": dataset})
    server = ThreadingHTTPServer((host, port), handler)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server
