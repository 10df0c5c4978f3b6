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
