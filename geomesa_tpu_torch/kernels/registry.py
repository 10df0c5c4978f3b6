"""The scan-callable registry and the shape buckets of the scan.

Copy of ``geomesa_tpu/kernels/registry.py``. The JAX package caches one
jitted kernel per version-stable key; a miss pays an XLA trace and
compile. Eager PyTorch traces nothing, so the port's counterpart of a
registry entry is the mask-and-aggregate callable an executor prepares for
one scan: the compiled predicate and its f32 band, the sampling mode, the
aggregate and whatever literal tensors they keep. A miss builds that
callable and ``put``s it (a "trace" in the reference's words and metric
names); a hit reuses it and builds nothing. The keys are the reference's,
so for one call sequence the port builds, hits, evicts and alerts where
the reference traces, hits, evicts and alerts.

* :class:`KernelRegistry`: a bounded, thread-safe LRU shared by the
  partitions of one store and by the aggregate cache's cell queries;
  entries evict one at a time (``geomesa.kernel.cache.size``).
* Version-stable keys: a key carries no store version, only the
  dictionary-growth fingerprint (:func:`dict_fingerprint`), since string
  predicates resolve dictionary codes when they are compiled.
* The per-query window: a site building more than
  ``geomesa.kernel.alert.threshold`` callables within one query trips the
  latched ``kernel.recompile.alert`` gauge.
* Shape buckets: :func:`bucket_count` pads a per-shard window count to a
  power of two above ``geomesa.compact.bucket.floor`` (identity above one
  when ``geomesa.compact.bucketing`` is off); :func:`bucket_batch` pads a
  query-axis batch's member count.
* :func:`enable_persistent_cache` reads ``geomesa.compile.cache.dir`` as
  the reference does, but the port has no compile cache behind it: its
  CUDA kernels are built once into the package's ignored build directory,
  and a callable is rebuilt in microseconds.

Metrics: ``kernel.recompiles[.<site>]``, ``kernel.bucket_hit``,
``kernel.evict[.<site>]``, ``kernel.recompiles.evicted``,
``kernel.recompile.alert`` and ``kernel.recompile.alerts``.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Tuple

from geomesa_tpu_torch import config, metrics, tracing

KERNEL_RECOMPILES = metrics.KERNEL_RECOMPILES
KERNEL_HIT = metrics.KERNEL_BUCKET_HIT
KERNEL_EVICT = metrics.KERNEL_EVICT

_query_window = threading.local()

_MISSING = object()  # OrderedDict.pop sentinel (None is a valid value)

#: how long a trip stays visible on the gauge (the alerts counter is the
#: durable record); the gauge latches because query windows are per thread
#: and the gauge is per process
_ALERT_TTL_S = 300.0
_alert_lock = threading.Lock()
_alert_state = {"at": 0.0, "over": 0}


def _alert_value() -> float:
    """The ``kernel.recompile.alert`` gauge: the sites over threshold in
    the most recent tripped window, until the latch expires."""
    with _alert_lock:
        if _time.monotonic() - _alert_state["at"] <= _ALERT_TTL_S:
            return float(_alert_state["over"])
    return 0.0


def _ensure_alert_gauge() -> None:
    metrics.registry().gauge(metrics.KERNEL_RECOMPILE_ALERT, _alert_value)


def reset_alert() -> None:
    """Clear the alert latch (tests)."""
    with _alert_lock:
        _alert_state["at"] = 0.0
        _alert_state["over"] = 0


def _site_slug(site) -> str:
    """Metric-name-safe site label."""
    s = str(site)
    return "".join(ch if (ch.isalnum() or ch in "._-") else "_" for ch in s)


def begin_query_window() -> None:
    """Reset this thread's per-query build window (at the top of every
    plan). The alert gauge is not cleared: it latches."""
    _query_window.counts = {}
    _ensure_alert_gauge()


def query_recompiles() -> Dict[str, int]:
    """site -> builds paid by the current query window."""
    return dict(getattr(_query_window, "counts", {}))


def alert_threshold() -> int:
    """Effective ``geomesa.kernel.alert.threshold``."""
    t = config.KERNEL_ALERT_THRESHOLD.to_int()
    return 3 if t is None else t


def _note_recompile(site) -> None:
    slug = _site_slug(site)
    metrics.inc(KERNEL_RECOMPILES)
    metrics.inc(f"{KERNEL_RECOMPILES}.{slug}")
    # visible inside the query that paid for it
    tracing.event("kernel.recompile", site=slug)
    counts = getattr(_query_window, "counts", None)
    if counts is None:
        return
    counts[slug] = counts.get(slug, 0) + 1
    threshold = alert_threshold()
    if counts[slug] > threshold:
        over = sum(1 for v in counts.values() if v > threshold)
        with _alert_lock:
            _alert_state["at"] = _time.monotonic()
            _alert_state["over"] = over
        _ensure_alert_gauge()
        if counts[slug] == threshold + 1:  # first trip for this site
            metrics.inc(metrics.KERNEL_RECOMPILE_ALERTS)
            tracing.event("kernel.recompile.alert", site=slug,
                          recompiles=counts[slug])


class KernelRegistry:
    """Bounded LRU of scan callables under version-stable keys, with
    per-site build accounting: ``key[0]`` (or ``key[0][0]`` for tagged
    keys) names the site."""

    _EVICTED_KEYS_MAX = 4096

    def __init__(self, capacity: Optional[int] = None):
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._capacity = capacity
        self._lock = threading.Lock()
        #: site -> builds (puts, not hits)
        self._traces: Dict[Any, int] = {}
        #: site -> entries evicted
        self._evicts: Dict[Any, int] = {}
        #: keys evicted and not since re-admitted (bounded): a put of one
        #: is an eviction-caused build
        self._evicted_keys: "OrderedDict[Hashable, None]" = OrderedDict()
        self._evicted_recompiles = 0

    def _cap(self) -> int:
        if self._capacity is not None:
            return self._capacity
        return config.KERNEL_CACHE_SIZE.to_int() or 512

    @staticmethod
    def _site(key: Hashable) -> Any:
        site = key[0] if isinstance(key, tuple) and key else key
        if isinstance(site, tuple) and site:
            site = site[0]
        return site

    def get(self, key: Hashable, default=None):
        if key is None:
            return default
        with self._lock:
            fn = self._entries.get(key)
            if fn is None:
                return default
            self._entries.move_to_end(key)
        metrics.inc(KERNEL_HIT)
        return fn

    def put(self, key: Hashable, fn) -> None:
        """Admit one freshly built callable, evicting least-recently-used
        entries over capacity one at a time; evictions count per site, and
        re-building an evicted key counts ``kernel.recompiles.evicted``."""
        with self._lock:
            self._entries[key] = fn
            self._entries.move_to_end(key)
            site = self._site(key)
            self._traces[site] = self._traces.get(site, 0) + 1
            evicted_from = self._evicted_keys.pop(key, _MISSING)
            if evicted_from is not _MISSING:
                self._evicted_recompiles += 1
            evicted_sites = []
            cap = max(self._cap(), 1)
            while len(self._entries) > cap:
                ekey, _ = self._entries.popitem(last=False)
                esite = self._site(ekey)
                self._evicts[esite] = self._evicts.get(esite, 0) + 1
                evicted_sites.append(esite)
                self._evicted_keys[ekey] = None
                while len(self._evicted_keys) > self._EVICTED_KEYS_MAX:
                    self._evicted_keys.popitem(last=False)
        _note_recompile(site)
        if evicted_from is not _MISSING:
            metrics.inc(metrics.KERNEL_RECOMPILE_EVICTED)
        if evicted_sites:
            metrics.inc(KERNEL_EVICT, len(evicted_sites))
            for esite in evicted_sites:
                metrics.inc(f"{KERNEL_EVICT}.{_site_slug(esite)}")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def traces(self, site=None):
        """Builds per site (or one site's count)."""
        with self._lock:
            if site is not None:
                return self._traces.get(site, 0)
            return dict(self._traces)

    def evicts(self, site=None):
        """LRU evictions per site (or one site's count)."""
        with self._lock:
            if site is not None:
                return self._evicts.get(site, 0)
            return dict(self._evicts)

    def evicted_recompiles(self) -> int:
        """Builds paid for keys the LRU had evicted (nonzero: the working
        set exceeds ``geomesa.kernel.cache.size``)."""
        with self._lock:
            return self._evicted_recompiles

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# -- dispatch records of a build ------------------------------------------------
# The reference notes a Pallas kernel's dispatch decision when the jitted
# scan that calls it traces, so ``exec_path`` carries ``kernel:<name>`` only
# for the run that compiled it. The port's counterpart: a kernel wrapper
# records its route while a freshly built scan callable runs for the first
# time (:func:`building`), and the executor drains the records into
# ``exec_path`` once per scan (:func:`take_dispatch`).

_build_state = threading.local()


class building:
    """Scope of a freshly built callable's first run (nests)."""

    def __enter__(self):
        _build_state.depth = getattr(_build_state, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _build_state.depth -= 1
        return False


def building_active() -> bool:
    return getattr(_build_state, "depth", 0) > 0


def record_dispatch(kernel: str, choice: str) -> None:
    """Note a kernel's route (inside :func:`building` only)."""
    if not building_active():
        return
    seen = getattr(_build_state, "dispatch", None)
    if seen is None:
        seen = _build_state.dispatch = {}
    lst = seen.setdefault(kernel, [])
    if choice not in lst:
        lst.append(choice)


def take_dispatch() -> Dict[str, str]:
    """Drain this thread's dispatch records (kernel -> route, distinct
    routes joined by `` + ``)."""
    out = getattr(_build_state, "dispatch", None) or {}
    _build_state.dispatch = {}
    return {k: v[0] if len(v) == 1 else " + ".join(v) for k, v in out.items()}


def dict_fingerprint(dicts: Dict[str, Any]) -> Tuple:
    """Validity fingerprint of compiled string predicates: dictionaries
    are append-only, so each vocabulary's length captures every growth
    that could change a compiled closure."""
    return tuple(sorted((k, len(d.values)) for k, d in dicts.items()))


def bucket_batch(n: int) -> int:
    """Pad a batch's member count to the next power of two. Padded
    members carry empty windows and zero literals; their results are
    dropped."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_count(n: int) -> int:
    """Pad a per-shard window count to its shape bucket: the next power of
    two, floored at ``geomesa.compact.bucket.floor`` (no floor when
    ``geomesa.compact.bucketing`` is off)."""
    n = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if not config.COMPACT_BUCKETING.to_bool():
        return n
    floor = config.COMPACT_BUCKET_FLOOR.to_int()
    floor = 8 if floor is None else max(floor, 1)
    return max(n, floor)


def enable_persistent_cache() -> Optional[str]:
    """``geomesa.compile.cache.dir`` when set, else None. The reference
    points JAX's persistent compilation cache there; the port has no
    compile cache behind it (see the module docstring), so this only
    reports the knob."""
    return config.COMPILE_CACHE_DIR.get() or None
