"""Named, typed tunables with a thread-local scope.

Copy of ``SystemProperty`` from ``geomesa_tpu/config.py`` (GeoMesa's
``SystemProperty`` pattern), cut to the knobs this port reads. Each keeps
the JAX package's name and default. A value resolves at call time as: the
thread-local override (``prop.set(v)`` / ``with prop.scoped(v):``), else
the environment variable (the name with ``.`` and ``-`` as ``_``,
upper-cased: ``geomesa.topk.max`` -> ``GEOMESA_TOPK_MAX``), else the
default. Modules read their knob when they need it, never at import.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

_local = threading.local()

_REGISTRY: Dict[str, "SystemProperty"] = {}


def _overrides() -> Dict[str, str]:
    if not hasattr(_local, "overrides"):
        _local.overrides = {}
    return _local.overrides


class SystemProperty:
    """A named tunable with a default and typed accessors."""

    def __init__(self, name: str, default: Optional[str] = None):
        self.name = name
        self.default = default
        self.env_name = name.replace(".", "_").replace("-", "_").upper()
        _REGISTRY[name] = self

    def get(self) -> Optional[str]:
        ov = _overrides()
        if self.name in ov:
            return ov[self.name]
        if self.env_name in os.environ:
            return os.environ[self.env_name]
        return self.default

    def set(self, value: Optional[Any]) -> None:
        """Thread-local override (None clears)."""
        ov = _overrides()
        if value is None:
            ov.pop(self.name, None)
        else:
            ov[self.name] = str(value)

    class _Scope:
        def __init__(self, prop: "SystemProperty", value: Any):
            self.prop, self.value = prop, value

        def __enter__(self):
            ov = _overrides()
            self.prev = ov.get(self.prop.name)
            ov[self.prop.name] = str(self.value)
            return self

        def __exit__(self, *exc):
            ov = _overrides()
            if self.prev is None:
                ov.pop(self.prop.name, None)
            else:
                ov[self.prop.name] = self.prev
            return False

    def scoped(self, value: Any) -> "SystemProperty._Scope":
        """``with prop.scoped(123): ...``: a temporary thread-local
        override, restored on exit (scopes nest)."""
        return SystemProperty._Scope(self, value)

    # -- typed accessors ----------------------------------------------------
    def to_str(self) -> Optional[str]:
        return self.get()

    def to_int(self) -> Optional[int]:
        v = self.get()
        return None if v is None else int(v)

    def to_float(self) -> Optional[float]:
        v = self.get()
        return None if v is None else float(v)

    def to_bool(self) -> Optional[bool]:
        v = self.get()
        if v is None:
            return None
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def to_duration_ms(self) -> Optional[int]:
        """Parse ``'100 ms'``, ``'10s'``, ``'5 minutes'``, ``'1h'`` and the
        like to milliseconds (a bare number is milliseconds)."""
        v = self.get()
        if v is None:
            return None
        s = str(v).strip().lower()
        num = ""
        for ch in s:
            if ch.isdigit() or ch == ".":
                num += ch
            else:
                break
        unit = s[len(num):].strip()
        if not num:
            raise ValueError(f"invalid duration: {v!r}")
        factors = {
            "": 1, "ms": 1, "millis": 1, "millisecond": 1, "milliseconds": 1,
            "s": 1000, "sec": 1000, "second": 1000, "seconds": 1000,
            "m": 60_000, "min": 60_000, "minute": 60_000, "minutes": 60_000,
            "h": 3_600_000, "hour": 3_600_000, "hours": 3_600_000,
            "d": 86_400_000, "day": 86_400_000, "days": 86_400_000,
        }
        if unit not in factors:
            raise ValueError(f"invalid duration unit: {v!r}")
        return int(float(num) * factors[unit])


def registry() -> Dict[str, SystemProperty]:
    return dict(_REGISTRY)


def snapshot_overrides() -> Dict[str, str]:
    """Copy of the current thread's overrides. A worker thread sees only
    env and defaults; the partition pipeline hands its worker this copy
    (:func:`adopt_overrides`) so both threads resolve every knob alike."""
    return dict(_overrides())


def adopt_overrides(snapshot: Dict[str, str]) -> None:
    """Install a :func:`snapshot_overrides` copy as this thread's
    overrides."""
    _local.overrides = dict(snapshot)


# -- the knobs this port reads (names and defaults of geomesa_tpu/config.py) --

#: soft budget of z-ranges a query cover produces
SCAN_RANGES_TARGET = SystemProperty("geomesa.scan.ranges.target", "2000")

#: BBOX on an extent geometry as envelope overlap only, with no exact
#: refinement (default: exact)
LOOSE_BBOX = SystemProperty("geomesa.loose.bbox", "false")

#: spill directory of cold time partitions (unset: a temporary directory
#: per store, removed with it)
SPILL_DIR = SystemProperty("geomesa.partition.spill.dir", None)

#: time partitions kept resident per partitioned store
MAX_RESIDENT_PARTITIONS = SystemProperty("geomesa.partition.max.resident", "4")

#: partition child tables round their padded shard length up to a
#: multiple of this
SHARD_LEN_BUCKET = SystemProperty("geomesa.partition.shard.bucket", "65536")

#: range budget (and per-shard window cap) of the compacted layout's fine
#: window resolution
COMPACT_COVER = SystemProperty("geomesa.compact.cover", "32768")

#: spill partitions as lake snapshots (false: the npz layout; either loads)
LAKE_ENABLED = SystemProperty("geomesa.lake.enabled", "true")

#: rows per lake row group, the pruning granule
LAKE_ROWGROUP_ROWS = SystemProperty("geomesa.lake.rowgroup.rows", "16384")

#: additive scans (count, unweighted density and curve, stats) and the
#: join's side scans load only the row groups whose statistics meet the
#: plan's box and interval (false: whole partitions)
LAKE_PUSHDOWN = SystemProperty("geomesa.lake.pushdown", "true")

#: degrees added around a row group's bbox before it is pruned, so the
#: scan's f32 edge arithmetic never matches a row of a pruned group
LAKE_PRUNE_MARGIN = SystemProperty("geomesa.lake.prune.margin", "1e-3")

#: a count-only dwithin / bbox join over a partitioned right store scans
#: the right side per chunk of left cells through the lake window
JOIN_PUSHDOWN = SystemProperty("geomesa.join.pushdown", "true")

#: occupied left cells per pushdown chunk
JOIN_PUSHDOWN_CELLS = SystemProperty("geomesa.join.pushdown.cells", "256")

#: MiB of decoded row-group chunks kept across a pushdown join's chunks
#: (0 disables)
JOIN_PUSHDOWN_RESIDENCY_MB = SystemProperty("geomesa.join.pushdown.residency.mb", "64")

#: stage the next partition while the current one runs (one worker, one
#: partition in flight)
PIPELINE_PREFETCH = SystemProperty("geomesa.pipeline.prefetch", "true")

#: the grouped density kernel declines (the scan scatters) when its pair
#: schedule would duplicate rows beyond this factor
DENSITY_PALLAS_MAX_DUP = SystemProperty("geomesa.density.pallas.max.dup", "4.0")

#: largest ``max_features`` a sorted query selects on the device
TOPK_MAX = SystemProperty("geomesa.topk.max", "100000")

#: candidate rows beyond k the device top-k keeps for boundary ties; a
#: tie group that overflows k + slack sorts on the host
TOPK_TIE_SLACK = SystemProperty("geomesa.topk.tie-slack", "4096")

#: hash groups of per-key sampling for int keys and dictionaries beyond
#: the exact per-key counter (a power of two; 0: such keys sample on the
#: host with an exact counter per key)
SAMPLE_HASH_BUCKETS = SystemProperty("geomesa.sample.hash-buckets", "64")

#: shards of a store whose caller and schema name none
DEFAULT_SHARDS = SystemProperty("geomesa.index.shards", "4")

#: "cost": the decider weighs every candidate index; anything else takes
#: the first candidate
STRATEGY_DECIDER = SystemProperty("geomesa.strategy.decider", "cost")

#: the window-compacted scan layout (gather only the window rows)
COMPACT_ENABLED = SystemProperty("geomesa.compact.enabled", "true")

#: table rows below which a scan keeps the padded layout
COMPACT_MIN_ROWS = SystemProperty("geomesa.compact.min.rows", str(1 << 20))

#: compaction engages only when its padded chunk rows stay under this
#: fraction of the table
COMPACT_FRACTION = SystemProperty("geomesa.compact.fraction", "0.5")

#: chunk length override, clamped onto the ladder (0: the adaptive
#: choice, least padding and the largest B within 10% of it)
COMPACT_B = SystemProperty("geomesa.compact.b", "0")

#: flat stores round their padded shard length up to a multiple of this
#: under bucketing (partition children use geomesa.partition.shard.bucket)
COMPACT_SHARD_BUCKET = SystemProperty("geomesa.compact.shard.bucket", "8192")

#: the grouped density kernel (``csrc/density_grouped.cu``) on compacted
#: z3 / z2 / xz scans
DENSITY_PALLAS = SystemProperty("geomesa.density.pallas", "true")

#: the einsum pair rung on compacted z3 / z2 scans when the grouped
#: kernel is off or declines (false: those scans scatter)
DENSITY_MXU = SystemProperty("geomesa.density.mxu", "true")

#: the einsum rung's grid tile shape (cells)
MXU_TILE_X = SystemProperty("geomesa.mxu.tile.x", "64")
MXU_TILE_Y = SystemProperty("geomesa.mxu.tile.y", "32")

#: spatial-join tiles: per-cell build/probe blocks chunk into tiles of at
#: most this many rows per side
JOIN_TILE = SystemProperty("geomesa.join.tile", "64")

#: finest cell level the join co-partition may choose
JOIN_MAX_LEVEL = SystemProperty("geomesa.join.max.level", "12")

#: matched pairs per ColumnBatch of a streaming join result
JOIN_BATCH_ROWS = SystemProperty("geomesa.join.batch.rows", "65536")

#: per-cell join strategy selection (pairwise / brute / split); off runs
#: every joint cell through the pairwise tiles
JOIN_ADAPTIVE = SystemProperty("geomesa.join.adaptive", "true")

#: a joint cell with at most this many candidate pairs takes the flat
#: brute-force list
JOIN_ADAPTIVE_BRUTE_PAIRS = SystemProperty("geomesa.join.adaptive.brute.pairs", "256")

#: a joint cell whose longer side holds at least this many times the
#: shorter side's rows is skewed and tiles in its own narrow section
JOIN_ADAPTIVE_SKEW_RATIO = SystemProperty("geomesa.join.adaptive.skew.ratio", "8")

#: attach the write-ahead mutation journal (``fs/journal.py``): ``load``
#: attaches it and every mutation is on disk before it returns (false:
#: ``attach_journal`` does nothing and acked mutations live until the next
#: ``save``)
JOURNAL_ENABLED = SystemProperty("geomesa.journal.enabled", "true")

#: group-commit widening window (ms), opened only after a commit found
#: more than one pending record
JOURNAL_GROUP_MS = SystemProperty("geomesa.journal.group.ms", "2")

#: journal segment roll threshold (bytes)
JOURNAL_SEGMENT_BYTES = SystemProperty("geomesa.journal.segment.bytes", str(8 << 20))

#: allow ``resilience.inject_faults`` scopes (tests and crash drills)
FAULT_INJECTION = SystemProperty("geomesa.fault.injection", "false")

#: a query's wall-clock budget (a duration: ``"500 ms"``, ``"2s"``); unset
#: is unlimited. Checked between scan phases, so a kernel is never cut
QUERY_TIMEOUT = SystemProperty("geomesa.query.timeout", None)

#: degrade instead of raising: a failing partition or join slice is skipped
#: and recorded, and the answer is exact over the survivors (the
#: ``resilience.allow_partial()`` scope turns it on for one operation)
SCAN_PARTIAL = SystemProperty("geomesa.scan.partial", "false")

#: total tries of a retried file edge (spill store and load; 1: no retry)
RETRY_ATTEMPTS = SystemProperty("geomesa.retry.attempts", "3")

#: backoff base delay (ms): retry i waits base * 2^(i-1), capped below
RETRY_BASE_MS = SystemProperty("geomesa.retry.base.ms", "50")

#: backoff delay cap (ms)
RETRY_MAX_MS = SystemProperty("geomesa.retry.max.ms", "5000")

#: jitter fraction in [0, 1): each delay scales by 1 - jitter * U(0, 1) from
#: the policy's seeded RNG
RETRY_JITTER = SystemProperty("geomesa.retry.jitter", "0.2")

#: the aggregate result cache (``cache/``): count, density, density_curve
#: and stats answer through it (default off)
CACHE_ENABLED = SystemProperty("geomesa.cache.enabled", "false")

#: bytes of cached aggregates kept per feature store (size-aware LRU)
CACHE_BUDGET_BYTES = SystemProperty("geomesa.cache.budget.bytes", str(64 << 20))

#: a decomposed query covers at most this many grid cells per axis of its
#: box (the cell level adapts to the box's span)
CACHE_CELLS_PER_AXIS = SystemProperty("geomesa.cache.cells-per-axis", "8")

#: finest cell level a decomposition may choose
CACHE_MAX_LEVEL = SystemProperty("geomesa.cache.max.level", "12")

#: interior cells per decomposed query beyond which the query caches its
#: whole result only
CACHE_MAX_CELLS = SystemProperty("geomesa.cache.max.cells", "256")

#: a missing cell assembles from its four cached children, and a completed
#: sibling quad writes its parent on put
CACHE_HIERARCHY = SystemProperty("geomesa.cache.hierarchy", "true")

#: levels an on-miss assembly may recurse down looking for cached children
CACHE_HIERARCHY_DEPTH = SystemProperty("geomesa.cache.hierarchy.depth", "2")

#: polygon-region queries split into interior cells (cached) and boundary
#: cells (scanned under the polygon); off caches their whole result only
CACHE_POLYGON = SystemProperty("geomesa.cache.polygon", "true")

#: distinct (schema, cell) rows the cell-heat table keeps ("0" disables it)
HEAT_CELLS_MAX = SystemProperty("geomesa.heat.cells", "4096")

#: hottest rows a heat snapshot returns per schema
HEAT_TOP = SystemProperty("geomesa.heat.top", "256")

#: refuse a plan that scans the whole table (the full-table-scan guard)
BLOCK_FULL_TABLE_SCANS = SystemProperty("geomesa.scan.block-full-table", "false")

#: the temporal guard: a schema with a date must be queried over at most
#: this many days (unset: no limit)
TEMPORAL_GUARD_MAX_DAYS = SystemProperty("geomesa.guard.temporal.max.days", None)

#: the query audit log's JSONL file (unset: the in-memory ring only)
AUDIT_PATH = SystemProperty("geomesa.audit.path", None)

#: write ``QueryEvent`` / ``DegradationEvent`` records at all
AUDIT_ENABLED = SystemProperty("geomesa.audit.enabled", "true")

#: span-tree tracing of every public call (default off)
TRACE_ENABLED = SystemProperty("geomesa.trace.enabled", "false")

#: a finished trace at least this slow (ms) writes its span tree to the
#: slow-query log and the audit file (unset: never)
TRACE_SLOW_MS = SystemProperty("geomesa.trace.slow.ms", None)

#: spans kept per trace; later ones are dropped and counted
TRACE_MAX_SPANS = SystemProperty("geomesa.trace.max.spans", "512")

#: mirror every span into a ``torch.profiler.record_function`` range (the
#: reference's name: there it opens ``jax.profiler.TraceAnnotation``)
TRACE_JAX_PROFILER = SystemProperty("geomesa.trace.jax.profiler", "false")

#: finished traces retained by id (``tracing.finished_trace``)
TRACE_RETAIN = SystemProperty("geomesa.trace.retain", "256")

#: the identity audit events carry (unset: "anonymous")
USER = SystemProperty("geomesa.user", None)

# -- the kernel registry, breakers, device health, trace export, utilization
# and SLO knobs (names and defaults of geomesa_tpu/config.py) --

#: pad a scan's per-shard window count to a power of two above the floor
#: below ("false": exact powers of two, no floor)
COMPACT_BUCKETING = SystemProperty("geomesa.compact.bucketing", "true")

#: floor of the bucketed per-shard window count
COMPACT_BUCKET_FLOOR = SystemProperty("geomesa.compact.bucket.floor", "8")

#: entries of the shared scan-callable registry (LRU, one eviction at a
#: time)
KERNEL_CACHE_SIZE = SystemProperty("geomesa.kernel.cache.size", "512")

#: a registry site paying more than this many builds within one query
#: trips the ``kernel.recompile.alert`` gauge
KERNEL_ALERT_THRESHOLD = SystemProperty("geomesa.kernel.alert.threshold", "3")

#: the reference's persistent XLA compile cache directory; the port reads
#: it and reports it, but has no compile cache behind it
COMPILE_CACHE_DIR = SystemProperty("geomesa.compile.cache.dir", None)

#: consecutive failures that open a named circuit breaker
BREAKER_THRESHOLD = SystemProperty("geomesa.breaker.threshold", "5")

#: open -> half-open reset window (ms)
BREAKER_RESET_MS = SystemProperty("geomesa.breaker.reset.ms", "30000")

#: devices cordoned out of scheduling, comma-separated ids
MESH_CORDON = SystemProperty("geomesa.mesh.cordon", None)

#: consecutive dispatch failures that open a ``device:<id>`` breaker
DEVICE_BREAKER_THRESHOLD = SystemProperty("geomesa.device.breaker.threshold", "3")

#: broken-device reset window (ms)
DEVICE_BREAKER_RESET_MS = SystemProperty("geomesa.device.breaker.reset.ms", "30000")

#: HTTP OTLP sink of finished traces (unset: none)
TRACE_OTLP_ENDPOINT = SystemProperty("geomesa.trace.otlp.endpoint", None)

#: JSONL file sink of finished traces, one OTLP batch per line (unset: none)
TRACE_EXPORT_PATH = SystemProperty("geomesa.trace.export.path", None)

#: keep rate of healthy traces in [0, 1], decided from (seed, trace id)
TRACE_SAMPLE_RATE = SystemProperty("geomesa.trace.sample.rate", "1.0")

#: seed of the sampling hash
TRACE_SAMPLE_SEED = SystemProperty("geomesa.trace.sample.seed", "0")

#: bounded export queue; a full queue drops the trace and counts it
TRACE_EXPORT_QUEUE = SystemProperty("geomesa.trace.export.queue", "1024")

#: traces converted and written per flusher pass (one OTLP batch)
TRACE_EXPORT_BATCH = SystemProperty("geomesa.trace.export.batch", "64")

#: trailing window (s) of the ``device.busy.<id>`` gauges
DEVICE_BUSY_WINDOW = SystemProperty("geomesa.device.busy.window", "60")

#: SLO burn: fast window (s), slow window (s) and the fast-window burn
#: past which /healthz degrades
SLO_WINDOW_FAST_S = SystemProperty("geomesa.slo.window.fast.s", "300")
SLO_WINDOW_SLOW_S = SystemProperty("geomesa.slo.window.slow.s", "3600")
SLO_BURN_THRESHOLD = SystemProperty("geomesa.slo.burn.threshold", "14.4")

#: per-op p99 targets are ``geomesa.slo.<op>.p99.ms`` (see slo_targets)
SLO_PREFIX = "geomesa.slo."
SLO_SUFFIX = ".p99.ms"


def slo_targets() -> Dict[str, float]:
    """Per-op p99 targets in ms, ``{op: target_ms}``: thread-local
    overrides (``geomesa.slo.<op>.p99.ms``) over the environment
    (``GEOMESA_SLO_<OP>_P99_MS``); an unparseable value is ignored."""
    out: Dict[str, float] = {}
    env_pre, env_suf = "GEOMESA_SLO_", "_P99_MS"
    for k, v in os.environ.items():
        if k.startswith(env_pre) and k.endswith(env_suf) \
                and len(k) > len(env_pre) + len(env_suf):
            try:
                out[k[len(env_pre):-len(env_suf)].lower()] = float(v)
            except ValueError:
                pass
    for k, v in _overrides().items():
        if k.startswith(SLO_PREFIX) and k.endswith(SLO_SUFFIX) \
                and len(k) > len(SLO_PREFIX) + len(SLO_SUFFIX):
            try:
                out[k[len(SLO_PREFIX):-len(SLO_SUFFIX)]] = float(v)
            except ValueError:
                pass
    return out
