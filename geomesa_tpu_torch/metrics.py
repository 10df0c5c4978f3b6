"""Process-wide metrics registry: counters, gauges, histograms and timers.

Copy of the core of ``geomesa_tpu/metrics.py`` (the geomesa-metrics
analog): the metric kinds, ``MetricRegistry`` with ``report``,
``prometheus`` (the ``/metrics`` text, with OpenMetrics exemplars on
request), ``export_snapshot`` and ``clear``, the process registry with the
``inc`` / ``observe`` shorthands, and the names the aggregate cache, the
cell-heat table, the executor's dispatch count and compaction share, the
partition pipeline, the joins, the lake tier, the mutation journal, the
kernel registry, the trace exporter, utilization, device health and the
SLO monitor use. The names equal the JAX package's, so
one name reads the same count in both packages. The registry is per
process, like the reference's.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self.value += n


class Gauge:
    """A sampled value, set explicitly or backed by a callable. Replacing
    an installed callable needs ``replace=True``."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self.fn = fn
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def set_fn(self, fn: Callable[[], float], replace: bool = False) -> None:
        """Install (or explicitly replace) the callable backing."""
        with self._lock:
            if self.fn is not None and self.fn is not fn and not replace:
                raise ValueError(
                    "gauge is already callable-backed; pass replace=True to "
                    "swap the backing function"
                )
            self.fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self.fn
            if fn is None:
                return self._value
        return float(fn())  # sampled outside the lock: fn may be slow


#: fixed histogram bucket upper bounds (seconds)
DEFAULT_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram:
    """Fixed-bucket histogram, latency buckets (seconds) by default; pass
    ``buckets`` and ``unit=None`` for a dimensionless distribution.
    ``observe(seconds, trace_id=...)`` keeps the trace id as the bucket's
    exemplar (last writer wins)."""

    __slots__ = ("buckets", "counts", "count", "sum_s", "unit", "exemplars",
                 "_lock")

    def __init__(self, buckets: Optional[Tuple[float, ...]] = None,
                 unit: Optional[str] = "s"):
        self.unit = unit
        self.buckets = tuple(buckets or DEFAULT_BUCKETS_S)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum_s = 0.0
        #: bucket index -> (trace_id, value, unix_ts); None until first use
        self.exemplars: Optional[Dict[int, Tuple[str, float, float]]] = None
        self._lock = threading.Lock()

    def observe(self, seconds: float, trace_id: Optional[str] = None):
        i = bisect.bisect_left(self.buckets, seconds)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum_s += seconds
            if trace_id is not None:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[i] = (trace_id, seconds, time.time())

    def quantile(self, q: float) -> float:
        """Approximate quantile: the upper bound of the bucket holding the
        q-th observation (+Inf resolves to the largest finite bound)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self.counts)
            total, s = self.count, self.sum_s
            ex = dict(self.exemplars) if self.exemplars else {}
        return {"count": total, "sum_s": s, "counts": counts,
                "buckets": list(self.buckets), "exemplars": ex}


class Timer:
    """Count, total and max duration, and a latency histogram. Use
    ``with timer.time():``."""

    __slots__ = ("count", "total_s", "max_s", "hist", "_lock")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.hist = Histogram()
        self._lock = threading.Lock()

    def update(self, seconds: float):
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)
        self.hist.observe(seconds)

    def time(self):
        return _TimerContext(self)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class _TimerContext:
    def __init__(self, timer: Timer):
        self.timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.update(time.perf_counter() - self._t0)
        return False


class MetricRegistry:
    def __init__(self, prefix: str = "geomesa"):
        self.prefix = prefix
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(*args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              replace: bool = False) -> Gauge:
        """A named gauge; ``fn`` installs a callable backing (replacing a
        different one needs ``replace=True``)."""
        g = self._get(name, Gauge)
        if fn is not None:
            g.set_fn(fn, replace=replace)
        return g

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def histogram(self, name: str, buckets: Optional[Tuple[float, ...]] = None,
                  unit: Optional[str] = "s") -> Histogram:
        """A named histogram; ``buckets`` / ``unit`` apply on first
        registration only."""
        return self._get(name, Histogram, buckets, unit)

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            elif isinstance(m, Timer):
                out[name] = {
                    "count": m.count, "total_s": m.total_s,
                    "mean_s": m.mean_s, "max_s": m.max_s,
                    "p50_s": m.hist.quantile(0.5),
                    "p99_s": m.hist.quantile(0.99),
                }
            elif isinstance(m, Histogram):
                snap = m.snapshot()
                out[name] = {
                    "count": snap["count"], "sum_s": snap["sum_s"],
                    "p50_s": m.quantile(0.5), "p90_s": m.quantile(0.9),
                    "p99_s": m.quantile(0.99),
                }
        return out

    @staticmethod
    def _prom_hist_lines(metric: str, snap: Dict[str, object],
                         exemplars: bool = False) -> List[str]:
        """Cumulative prometheus histogram lines of one histogram snapshot.
        ``exemplars`` (legal in the OpenMetrics exposition only) appends
        each bucket's exemplar as ``# {trace_id="..."} value timestamp``."""
        ex = (snap.get("exemplars") or {}) if exemplars else {}

        def _ex(i: int) -> str:
            e = ex.get(i)
            if e is None:
                return ""
            tid, val, ts = e
            return f' # {{trace_id="{tid}"}} {val:.6f} {ts:.3f}'

        lines: List[str] = []
        cum = 0
        for i, (le, c) in enumerate(zip(snap["buckets"], snap["counts"])):
            cum += c
            lines.append(f'{metric}_bucket{{le="{le}"}} {cum}{_ex(i)}')
        cum += snap["counts"][-1]
        lines.append(
            f'{metric}_bucket{{le="+Inf"}} {cum}'
            f'{_ex(len(snap["buckets"]))}'
        )
        lines.append(f"{metric}_sum {snap['sum_s']:.6f}")
        lines.append(f"{metric}_count {snap['count']}")
        return lines

    def prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition of every metric: timers as their
        count / total / max lines plus ``_seconds`` histogram buckets,
        histograms as the bucket / sum / count triple, counters and gauges
        as one line. ``exemplars`` adds the per-bucket exemplar suffixes of
        the OpenMetrics exposition (never legal in the classic text)."""
        lines: List[str] = []
        p = self.prefix
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            metric = f"{p}_{name}".replace(".", "_").replace("-", "_")
            if isinstance(m, Timer):
                lines.append(f"{metric}_count {m.count}")
                lines.append(f"{metric}_seconds_total {m.total_s:.6f}")
                lines.append(f"{metric}_seconds_max {m.max_s:.6f}")
                lines.extend(self._prom_hist_lines(
                    metric + "_seconds", m.hist.snapshot(), exemplars))
            elif isinstance(m, Histogram):
                suffix = "_seconds" if m.unit == "s" else ""
                lines.extend(self._prom_hist_lines(
                    metric + suffix, m.snapshot(), exemplars))
            elif isinstance(m, (Counter, Gauge)):
                lines.append(f"{metric} {m.value}")
        return "\n".join(lines) + "\n"

    def export_snapshot(self) -> Dict[str, object]:
        """Raw counters, sampled gauges and full histogram bucket vectors
        (not the quantile summaries of :meth:`report`), for federation.
        Exemplars are left out: they point into this process's traces."""
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, object] = {}
        timers: Dict[str, object] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                try:
                    gauges[name] = float(m.value)
                except Exception:
                    continue  # a dead callable backing must not kill export
            elif isinstance(m, Timer):
                snap = m.hist.snapshot()
                snap.pop("exemplars", None)
                snap["unit"] = m.hist.unit
                timers[name] = {"count": m.count, "total_s": m.total_s,
                                "max_s": m.max_s, "hist": snap}
            elif isinstance(m, Histogram):
                snap = m.snapshot()
                snap.pop("exemplars", None)
                snap["unit"] = m.unit
                hists[name] = snap
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "timers": timers}

    def clear(self):
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricRegistry()


def registry() -> MetricRegistry:
    return _REGISTRY


def inc(name: str, n: int = 1) -> None:
    """Bump a counter of the process registry."""
    _REGISTRY.counter(name).inc(n)


def observe(name: str, seconds: float,
            trace_id: Optional[str] = None) -> None:
    """Record one latency observation into a process-registry histogram,
    with an optional exemplar ``trace_id``."""
    _REGISTRY.histogram(name).observe(seconds, trace_id)


# Aggregate-cache names (cache/store.py, cache/service.py, lake/persist.py):
#   cache.hit          whole-result hits (no scan at all)
#   cache.partial      partial-cover hits (only the missing cells scanned)
#   cache.miss         queries that found nothing reusable
#   cache.put          entries admitted
#   cache.evict        entries evicted by the size-aware LRU
#   cache.invalidate   entries dropped by an epoch bump or an explicit drop
#   cache.bytes        resident cached bytes (gauge)
#   cache.entries      resident entry count (gauge)
#   cache.hierarchy.hit       cells served by assembling cached children
#   cache.hierarchy.promote   coarse entries written by assembly or roll-up
#   cache.hierarchy.residual  cells that fell through to a scan after an
#                             assembly attempt found no children
#   cache.polygon             queries decomposed into interior and
#                             boundary cells of a polygon region
#   cache.curve.region        density_curve queries whose chunk loop split
#                             into polygon chunk families
#   cache.persist.restored    entries re-admitted by ``restore_cache``
CACHE_HIT = "cache.hit"
CACHE_PARTIAL = "cache.partial"
CACHE_MISS = "cache.miss"
CACHE_PUT = "cache.put"
CACHE_EVICT = "cache.evict"
CACHE_INVALIDATE = "cache.invalidate"
CACHE_BYTES = "cache.bytes"
CACHE_ENTRIES = "cache.entries"
CACHE_HIER_HIT = "cache.hierarchy.hit"
CACHE_HIER_PROMOTE = "cache.hierarchy.promote"
CACHE_HIER_RESIDUAL = "cache.hierarchy.residual"
CACHE_POLYGON = "cache.polygon"
CACHE_CURVE_REGION = "cache.curve.region"
CACHE_PERSIST_RESTORED = "cache.persist.restored"
#   exec.device.dispatch   device scans the executors launched (a warm
#                          zoom-out served by the cache launches none)
EXEC_DEVICE_DISPATCH = "exec.device.dispatch"
#   compact.desc.shared    compacted-scan descriptors served from the
#                          store's content-addressed share (another plan
#                          resolved the same windows)
COMPACT_DESC_SHARED = "compact.desc.shared"
#   pipeline.prefetch      partitions the prefetch worker staged
PIPELINE_PREFETCH = "pipeline.prefetch"
# Spatial joins (planning/join_exec.py, api/dataset.py):
#   join.queries           spatial joins run (count and pair forms)
#   join.cells             co-partition cells with rows on both sides
#   join.candidate.pairs   pairwise tests dispatched
#   join.pairs             matched pairs emitted
#   join.cells.<strategy>  joint cells by strategy (pairwise, brute,
#                          split, interior)
#   join.pushdown.bytes    payload bytes a pushdown side scan read
#   join.pushdown.residency.hits / .bytes  row-group chunks served from
#                          the cross-chunk residency, and the payload bytes
#                          a re-decode would have read
JOIN_QUERIES = "join.queries"
JOIN_CELLS = "join.cells"
JOIN_CANDIDATE_PAIRS = "join.candidate.pairs"
JOIN_PAIRS = "join.pairs"
JOIN_CELLS_STRATEGY = "join.cells."
JOIN_PUSHDOWN_BYTES = "join.pushdown.bytes"
JOIN_PUSHDOWN_RESIDENCY_HITS = "join.pushdown.residency.hits"
JOIN_PUSHDOWN_RESIDENCY_BYTES = "join.pushdown.residency.bytes"
# The lake tier (lake/format.py, lake/snapshot.py,
# planning/partitioned_exec.py):
#   lake.bytes.read        payload and footer bytes read
#   lake.bytes.skipped     payload bytes statistics pruning never touched
#   lake.rowgroups.loaded  row groups decoded for scans
#   lake.rowgroups.pruned  row groups footer statistics excluded
#   lake.pushdown.scans    partition scans a pruned partial load served
#   lake.pushdown.fallback pushdown asked for but served by a whole load
LAKE_BYTES_READ = "lake.bytes.read"
LAKE_BYTES_SKIPPED = "lake.bytes.skipped"
LAKE_ROWGROUPS_LOADED = "lake.rowgroups.loaded"
LAKE_ROWGROUPS_PRUNED = "lake.rowgroups.pruned"
LAKE_PUSHDOWN_SCANS = "lake.pushdown.scans"
LAKE_PUSHDOWN_FALLBACK = "lake.pushdown.fallback"
# The mutation journal (fs/journal.py, api/dataset.py):
#   journal.appends          records made durable (acked appends)
#   journal.group.size       histogram: appends per group-commit fsync
#   journal.fsync_ms         histogram: a group's write and fsync (ms)
#   journal.replayed         records re-applied by a replay
#   journal.truncated_bytes  bytes reclaimed by checkpoints or clipped
#                            from torn tails
#   journal.torn_tails       torn segment tails truncated
#   journal.lag              gauge: appended records not yet durable
JOURNAL_APPENDS = "journal.appends"
JOURNAL_GROUP_SIZE = "journal.group.size"
JOURNAL_FSYNC_MS = "journal.fsync_ms"
JOURNAL_REPLAYED = "journal.replayed"
JOURNAL_TRUNCATED_BYTES = "journal.truncated_bytes"
JOURNAL_TORN_TAILS = "journal.torn_tails"
JOURNAL_LAG = "journal.lag"
#: group-commit width buckets (appends per fsync)
JOURNAL_GROUP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
#: group-commit fsync latency buckets (milliseconds)
JOURNAL_FSYNC_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                            50.0, 100.0, 250.0)
# Query timers (api/dataset.py): query.plan, query.scan (count and the
# feature calls) and query.density (density, density_curve and their
# batches)
# Partition spills (index/partitioned.py):
#   index.spill.quarantined   corrupt snapshots quarantined
SPILL_QUARANTINED = "index.spill.quarantined"
# Cell-heat table (heat.py):
#   heat.cells     gauge: distinct (schema, cell) rows in the table
#   heat.evicted   rows dropped by the table's size bound
HEAT_CELLS = "heat.cells"
HEAT_EVICTED = "heat.evicted"
# Kernel registry (kernels/registry.py, planning/executor.py):
#   kernel.recompiles[.<site>]  scan callables built (registry misses)
#   kernel.bucket_hit           registry hits
#   kernel.evict[.<site>]       LRU evictions
#   kernel.recompiles.evicted   builds of keys the LRU had evicted
#   kernel.recompile.alert      gauge: sites over geomesa.kernel.alert.
#                               threshold in the last tripped query window
#   kernel.recompile.alerts     alert trips
KERNEL_RECOMPILES = "kernel.recompiles"
KERNEL_BUCKET_HIT = "kernel.bucket_hit"
KERNEL_EVICT = "kernel.evict"
KERNEL_RECOMPILE_EVICTED = "kernel.recompiles.evicted"
KERNEL_RECOMPILE_ALERT = "kernel.recompile.alert"
KERNEL_RECOMPILE_ALERTS = "kernel.recompile.alerts"
# Trace export (tracing_export.py):
#   trace.export.exported   traces handed to a sink (after sampling)
#   trace.export.sampled    healthy traces dropped by the sample rate
#   trace.export.dropped    traces dropped on a full export queue
#   trace.export.failed     traces whose sink write failed
#   trace.export.batches    OTLP batches written
TRACE_EXPORT_EXPORTED = "trace.export.exported"
TRACE_EXPORT_SAMPLED = "trace.export.sampled"
TRACE_EXPORT_DROPPED = "trace.export.dropped"
TRACE_EXPORT_FAILED = "trace.export.failed"
TRACE_EXPORT_BATCHES = "trace.export.batches"
# Utilization, device health and SLO burn (utilization.py,
# parallel/health.py, slo.py):
#   device.busy.<id>            gauge: busy fraction over the trailing
#                               geomesa.device.busy.window
#   serving.slot.occupancy.<s>  gauge: busy fraction of a serving slot
#   device.health.<id>          gauge: 1 ok, 0 cordoned, -1 broken
#   slo.burn.<op>               gauge: fast-window burn rate
#   slo.breaker.<name>          gauge: 1 open, 0.5 half-open, 0 closed
DEVICE_BUSY_PREFIX = "device.busy"
SLOT_OCCUPANCY_PREFIX = "serving.slot.occupancy"
DEVICE_HEALTH_PREFIX = "device.health"
SLO_BURN_PREFIX = "slo.burn"
SLO_BREAKER_PREFIX = "slo.breaker"
# The serving scheduler (serving/scheduler.py, serving/fuse.py):
#   serving.queue.depth       gauge: tickets queued on the started scheduler
#   serving.queue.wait        histogram: a ticket's wait before dispatch
#   serving.admitted / .completed            tickets queued / ops finished
#   serving.shed.deadline / .shed.queue_full  typed sheds and rejections
#   serving.fused             members served by a fused batch (all of them)
#   serving.fused.distinct    members served by a distinct-literal batch
#   serving.fusion.batch      histogram (dimensionless): fused batch sizes
#   serving.speculative       sheds answered with the coarse host answer
#   serving.placement.bound / .defer  placement of fused groups on a pool
#   serving.executor.dispatch.<slot>  groups executed per slot
#   serving.slot.died[.<slot>] / serving.slot.respawn[.<slot>]  dispatcher
#                             deaths and the supervisor's respawns
SERVING_QUEUE_DEPTH = "serving.queue.depth"
SERVING_QUEUE_WAIT = "serving.queue.wait"
SERVING_ADMITTED = "serving.admitted"
SERVING_COMPLETED = "serving.completed"
SERVING_SHED_DEADLINE = "serving.shed.deadline"
SERVING_SHED_QUEUE_FULL = "serving.shed.queue_full"
SERVING_FUSED = "serving.fused"
SERVING_FUSED_DISTINCT = "serving.fused.distinct"
SERVING_SPECULATIVE = "serving.speculative"
SERVING_PLACEMENT_BOUND = "serving.placement.bound"
SERVING_PLACEMENT_DEFER = "serving.placement.defer"
SERVING_FUSION_BATCH = "serving.fusion.batch"
SERVING_EXECUTOR_DISPATCH = "serving.executor.dispatch"
SERVING_SLOT_DIED = "serving.slot.died"
SERVING_SLOT_RESPAWN = "serving.slot.respawn"
#: fused batch-size histogram buckets (members per micro-batch)
FUSION_BATCH_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)
# Standing queries (subscribe/):
#   subscribe.groups / .subscribers   gauges: groups and subscribers held
#   subscribe.update.dispatches       delta passes: one per applied ingest
#                                     batch per schema, however many watch
#   subscribe.updates                 update records emitted
#   subscribe.rescans                 dirty-scoped re-scans
#   subscribe.fused                   registrations joining an existing group
#   subscribe.verify                  delta-against-re-scan checks run
#   subscribe.handoff.exported / .imported / .resync  group migration
SUBSCRIBE_GROUPS = "subscribe.groups"
SUBSCRIBE_SUBSCRIBERS = "subscribe.subscribers"
SUBSCRIBE_DISPATCHES = "subscribe.update.dispatches"
SUBSCRIBE_UPDATES = "subscribe.updates"
SUBSCRIBE_RESCANS = "subscribe.rescans"
SUBSCRIBE_FUSED = "subscribe.fused"
SUBSCRIBE_VERIFY = "subscribe.verify"
SUBSCRIBE_HANDOFF_EXPORTED = "subscribe.handoff.exported"
SUBSCRIBE_HANDOFF_IMPORTED = "subscribe.handoff.imported"
SUBSCRIBE_HANDOFF_RESYNC = "subscribe.handoff.resync"
