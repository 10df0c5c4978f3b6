"""Query interceptors: pluggable rewrite and guard hooks.

Copy of ``geomesa_tpu/planning/interceptors.py`` (GeoMesa's
``QueryInterceptor``): per-schema hooks loaded from the schema's user-data
key ``geomesa.query.interceptors`` (comma-separated dotted paths) or
registered programmatically. Each interceptor may implement:

    rewrite(filter: ir.Filter, ft) -> ir.Filter   # before planning
    guard(plan) -> None                            # raise to veto the plan

The built-in guards (full-table-scan block, temporal span limit) run
regardless; these hooks add schema-specific policy on top.
"""

from __future__ import annotations

import importlib
import logging
import threading
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_registry: Dict[str, List[Any]] = {}
# keyed by the user-data spec STRING (id(ft) would recycle across GC'd
# schemas); identical specs share loaded interceptor instances
_loaded_userdata: Dict[str, List[Any]] = {}

USER_DATA_KEY = "geomesa.query.interceptors"


_version = 0


def version() -> int:
    """Bumped on every registry mutation: a key of anything derived from a
    planned query (plans are pure in (filter, hints, interceptors))."""
    return _version


def register(type_name: str, interceptor: Any):
    """Programmatic registration for one schema name."""
    global _version
    with _lock:
        _registry.setdefault(type_name, []).append(interceptor)
        _version += 1


def clear(type_name: Optional[str] = None):
    global _version
    with _lock:
        if type_name is None:
            _registry.clear()
            _loaded_userdata.clear()
        else:
            _registry.pop(type_name, None)
        _version += 1


def _load_path(path: str) -> Any:
    mod, _, attr = path.rpartition(".")
    obj = getattr(importlib.import_module(mod), attr)
    return obj() if isinstance(obj, type) else obj


def for_schema(ft) -> List[Any]:
    """Interceptors for a schema: user-data dotted paths + registered."""
    out: List[Any] = []
    spec = (ft.user_data or {}).get(USER_DATA_KEY)
    if spec:
        key = str(spec)
        with _lock:
            cached = _loaded_userdata.get(key)
        if cached is None:
            cached = []
            for p in key.split(","):
                p = p.strip()
                if not p:
                    continue
                try:
                    cached.append(_load_path(p))
                except Exception as e:
                    # a mistyped path must not brick the schema: log it and
                    # go on
                    logging.getLogger(__name__).warning(
                        "failed to load query interceptor %r: %r", p, e
                    )
            with _lock:
                if len(_loaded_userdata) >= 256:
                    _loaded_userdata.clear()
                _loaded_userdata[key] = cached
        out.extend(cached)
    with _lock:
        out.extend(_registry.get(ft.name, ()))
    return out


def apply_rewrite(ft, f):
    for ic in for_schema(ft):
        rw = getattr(ic, "rewrite", None)
        if rw is not None:
            f = rw(f, ft)
    return f


def apply_guards(ft, plan):
    for ic in for_schema(ft):
        g = getattr(ic, "guard", None)
        if g is not None:
            g(plan)
