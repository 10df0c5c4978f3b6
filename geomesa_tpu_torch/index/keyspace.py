"""Z3 key space: feature batch -> sort keys (ingest) and filter -> scan
windows (plan time).

Copy of ``geomesa_tpu/index/keyspace.py`` cut to ``Z3KeySpace`` (point geometry
+ time) with ``KeyPlan``, range merging, window capping and the LSM append's
``fast_build(force_shifts=)`` / ``insert_positions``. Per-bin window
resolution is NumPy ``searchsorted`` (the JAX package may use native C++
there; both give the same windows). The range budget and the per-shard
window cap are explicit arguments instead of scoped configuration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.curves.binned_time import TimePeriod
from geomesa_tpu_torch.curves.cover import ZRange
from geomesa_tpu_torch.curves.zorder import Z3SFC
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index import packsort
from geomesa_tpu_torch.schema.feature_type import FeatureType

MAX_WINDOW_BINS = 64  # collapse per-bin windows beyond this many time bins

#: per-shard budget for resolved scan windows (bins x z-ranges); beyond it
#: windows gap-union down (over-cover; the fine mask restores exactness)
MAX_SHARD_WINDOWS = 256

#: default z-range budget of a query cover
RANGES_TARGET = 2000


@dataclass
class KeyPlan:
    """Plan-time product of the key space for one query."""

    keyspace: "Z3KeySpace"
    #: provably empty (disjoint bounds)
    disjoint: bool = False
    #: z-ranges over the full offset span (middle bins)
    ranges: List[ZRange] = field(default_factory=list)
    #: time bins touched
    bins: Optional[np.ndarray] = None
    #: per edge bin: time-tightened z-ranges
    edge: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)

    def windows(self, shard_cols: Dict[str, np.ndarray], n: int,
                cap: int = MAX_SHARD_WINDOWS) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, ends) row windows for one shard's sorted key columns."""
        if self.disjoint:
            return np.zeros(1, np.int64), np.zeros(1, np.int64)
        return self.keyspace.resolve_windows(self, shard_cols, n, cap)


def _merge_cap(los: np.ndarray, his: np.ndarray, cap: int,
               adjacent: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Sort, merge overlapping (or within ``adjacent``) intervals, then keep
    only the ``cap-1`` largest gaps as separators."""
    if len(los) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(los, kind="stable")
    los = np.asarray(los, np.int64)[order]
    his = np.asarray(his, np.int64)[order]
    run_hi = np.maximum.accumulate(his)
    new = np.concatenate(([True], los[1:] > run_hi[:-1] + adjacent))
    idx = np.flatnonzero(new)
    mlo = los[idx]
    mhi = run_hi[np.concatenate((idx[1:] - 1, [len(los) - 1]))]
    if len(mlo) > cap:
        gaps = mlo[1:] - mhi[:-1]
        keep = np.sort(np.argpartition(gaps, -(cap - 1))[-(cap - 1):]) \
            if cap > 1 else np.zeros(0, np.int64)
        mlo = np.concatenate((mlo[:1], mlo[keep + 1]))
        mhi = np.concatenate((mhi[keep], mhi[-1:]))
    return mlo, mhi


def _merge_zranges(ranges: List[Tuple[int, int]], cap: int) -> List[Tuple[int, int]]:
    """Tuple-list facade over :func:`_merge_cap` (adjacency 1: integer key
    ranges touching end-to-end fuse)."""
    if not ranges:
        return []
    los = np.asarray([r[0] for r in ranges], np.int64)
    his = np.asarray([r[1] for r in ranges], np.int64)
    mlo, mhi = _merge_cap(los, his, cap, adjacent=1)
    return list(zip(mlo.tolist(), mhi.tolist()))


def _cap_windows(starts: np.ndarray, ends: np.ndarray, cap: int):
    """Merge overlapping half-open row windows; union the smallest gaps
    when more than ``cap`` remain."""
    return _merge_cap(starts, ends, cap, adjacent=0)


def _bin_windows(bins_col: np.ndarray, z_col: np.ndarray, bins: np.ndarray,
                 zlo: int, zhi: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-time-bin [zlo, zhi] windows over (bin, z)-sorted columns; only
    the non-empty ones."""
    starts, ends = [], []
    for b in bins.tolist():
        s = int(np.searchsorted(bins_col, b, side="left"))
        e = int(np.searchsorted(bins_col, b, side="right"))
        if e <= s:
            continue
        seg = z_col[s:e]
        s2 = s + int(np.searchsorted(seg, np.uint64(zlo), side="left"))
        e2 = s + int(np.searchsorted(seg, np.uint64(zhi), side="right"))
        if e2 > s2:
            starts.append(s2)
            ends.append(e2)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


class Z3KeySpace:
    """(bin, z3) keys over point geometry + time."""

    kind = "z3"

    def __init__(self, geom: str, dtg: str, period: "str | TimePeriod" = TimePeriod.WEEK):
        self.geom = geom
        self.dtg = dtg
        self.sfc = Z3SFC(period)
        self.binned = self.sfc.binned
        self.key_cols = ("__z3_bin", "__z3")

    def index_keys(self, ft: FeatureType, cols: Dict[str, np.ndarray]):
        """Vectorized key encode for an ingest batch, reusing the batch's
        ``<dtg>__bin`` column when its period matches."""
        bin_col = self.dtg + "__bin"
        if bin_col in cols and ft.time_period == self.binned.period:
            b = cols[bin_col]
            off = self.binned.offset_from_bin(cols[self.dtg], b)
        else:
            b, off = self.binned.to_bin_and_offset(cols[self.dtg])
        z = self.sfc.index(cols[self.geom + "__x"], cols[self.geom + "__y"], off)
        return {"__z3_bin": np.asarray(b, np.int32), "__z3": z}

    def sort_order(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """argsort of raw (bin, z3) keys (the fallback of the pack-sort)."""
        return np.lexsort((cols["__z3"], cols["__z3_bin"]))

    def fast_build(self, cols: Dict[str, np.ndarray],
                   force_shifts: Optional[Dict[str, int]] = None):
        """Radix pack-sort build: (order, key columns quantized by shifts,
        shifts), or None when the bit budget is too tight. ``force_shifts``
        pins the quantization to an existing table's (LSM append)."""
        fs = None if force_shifts is None else force_shifts.get("__z3")
        out = packsort.pack_sort(cols["__z3"], 63, prefix=cols["__z3_bin"],
                                 force_shift=fs)
        if out is None:
            return None
        perm, zq, bins_sorted, shift = out
        return perm, {"__z3_bin": bins_sorted, "__z3": zq}, {"__z3": shift}

    def build(self, cols: Dict[str, np.ndarray]):
        """(order, sorted key columns, key shifts): the radix pack-sort, or
        a lexsort over raw keys when the bit budget is too tight."""
        out = self.fast_build(cols)
        if out is not None:
            return out
        order = self.sort_order(cols)
        order = order.astype(np.int32 if len(order) < 2**31 else np.int64)
        return order, {k: cols[k][order] for k in self.key_cols}, None

    def insert_positions(self, sorted_key_cols: Dict[str, np.ndarray],
                         fresh_sorted: Dict[str, np.ndarray]) -> np.ndarray:
        """Merge positions of already-sorted fresh (bin, z3) keys into the
        table's sorted key columns: per fresh bin, a searchsorted inside
        that bin's run (equal keys land after the old rows)."""
        bins_col = sorted_key_cols["__z3_bin"]
        key_col = sorted_key_cols["__z3"]
        fb, fk = fresh_sorted["__z3_bin"], fresh_sorted["__z3"]
        p = np.empty(len(fb), np.int64)
        for b in np.unique(fb):
            sel = fb == b
            s = int(np.searchsorted(bins_col, b, side="left"))
            e = int(np.searchsorted(bins_col, b, side="right"))
            p[sel] = s + np.searchsorted(key_col[s:e], fk[sel], side="right")
        return p

    def plan(self, ft: FeatureType, f: ir.Filter,
             ranges_target: int = RANGES_TARGET) -> Optional[KeyPlan]:
        """None when the filter has no time bound (z3 cannot serve it)."""
        geoms = ir.extract_geometries(f, self.geom)
        intervals = ir.extract_intervals(f, self.dtg)
        if geoms.disjoint or intervals.disjoint:
            return KeyPlan(self, disjoint=True)
        if intervals.is_empty:
            return None
        CLAMP = 2**45
        iv = [(max(lo, -CLAMP), min(hi, CLAMP)) for lo, hi in intervals.values]
        bins = np.unique(
            np.concatenate([self.binned.bins_between(lo, hi) for lo, hi in iv])
        )
        max_off = float(self.binned.max_offset_ms)
        if geoms.is_empty:
            xy = [(-180.0, -90.0, 180.0, 90.0)]
        else:
            xy = [g.bounds() for g in geoms.values]
        # per-geometry covers over the full offset span (middle bins)
        all_r: List[Tuple[int, int]] = []
        for b in xy:
            for r in self.sfc.ranges(
                (b[0], b[2]), (b[1], b[3]), (0.0, max_off), ranges_target
            ):
                all_r.append((int(r.lo), int(r.hi)))
        ranges = [ZRange(lo, hi) for lo, hi in _merge_zranges(all_r, ranges_target)]
        # edge-bin time tightening: the first/last bin of each interval
        # gets its own cover restricted to the interval's offsets there
        edge: Dict[int, List[Tuple[int, int]]] = {}
        for lo, hi in iv:
            blo, olo = self.binned.to_bin_and_offset(np.asarray([lo], np.int64))
            bhi, ohi = self.binned.to_bin_and_offset(np.asarray([hi], np.int64))
            blo, olo = int(blo[0]), float(olo[0])
            bhi, ohi = int(bhi[0]), float(ohi[0])
            for b, off_lo, off_hi in (
                ((blo, olo, max_off if blo != bhi else ohi),)
                + (((bhi, 0.0, ohi),) if bhi != blo else ())
            ):
                rs = [
                    (int(r.lo), int(r.hi))
                    for box in xy
                    for r in self.sfc.ranges(
                        (box[0], box[2]), (box[1], box[3]), (off_lo, off_hi),
                        ranges_target,
                    )
                ]
                edge.setdefault(b, []).extend(rs)
        return KeyPlan(
            self, ranges=ranges, bins=bins.astype(np.int32),
            edge={b: _merge_zranges(rs, ranges_target) for b, rs in edge.items()},
        )

    def resolve_windows(self, plan: KeyPlan, shard_cols, n: int, cap: int):
        bins_col = shard_cols["__z3_bin"]
        z_col = shard_cols["__z3"]
        shifts = shard_cols.get("__shifts__")
        sh = 0 if shifts is None else shifts.get("__z3", 0)
        bins = plan.bins
        if len(bins) > MAX_WINDOW_BINS:
            # collapse: one window spanning [first bin, last bin]
            s = np.searchsorted(bins_col, bins[0], side="left")
            e = np.searchsorted(bins_col, bins[-1], side="right")
            return np.asarray([s], np.int64), np.asarray([e], np.int64)
        # every cover range resolves to its own window per bin; the
        # shifted + merged range sets are shard-independent: cached
        per_bin_cap = max(1, cap // max(len(bins), 1))
        cache = plan.__dict__.setdefault("_shifted_ranges", {})
        sets = cache.get((sh, cap))
        if sets is None:
            base = _merge_zranges(
                [(r.lo >> sh, r.hi >> sh) for r in plan.ranges], per_bin_cap
            )
            esets = {
                b: _merge_zranges(
                    [(lo >> sh, hi >> sh) for lo, hi in rs], per_bin_cap
                )
                for b, rs in plan.edge.items()
            }
            sets = cache[(sh, cap)] = (base, esets)
        base, esets = sets
        starts: List[int] = []
        ends: List[int] = []
        plain = np.asarray([b for b in bins.tolist() if b not in esets], np.int32)
        for lo, hi in base:
            ws, we = _bin_windows(bins_col, z_col, plain, lo, hi)
            starts.extend(ws.tolist())
            ends.extend(we.tolist())
        for b, rs in esets.items():
            s = int(np.searchsorted(bins_col, b, side="left"))
            e = int(np.searchsorted(bins_col, b, side="right"))
            if e <= s or not rs:
                continue
            seg = z_col[s:e]
            los = np.asarray([r[0] for r in rs], seg.dtype)
            his = np.asarray([r[1] for r in rs], seg.dtype)
            ws = s + np.searchsorted(seg, los, side="left")
            we = s + np.searchsorted(seg, his, side="right")
            keep = we > ws
            starts.extend(ws[keep].tolist())
            ends.extend(we[keep].tolist())
        if not starts:
            return np.zeros(1, np.int64), np.zeros(1, np.int64)
        return _cap_windows(
            np.asarray(starts, np.int64), np.asarray(ends, np.int64), cap,
        )
