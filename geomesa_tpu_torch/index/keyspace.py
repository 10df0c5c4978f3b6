"""Key spaces: feature batch -> sort keys (ingest) and filter -> scan
windows (plan time).

Copy of ``geomesa_tpu/index/keyspace.py`` cut to ``Z3KeySpace`` (point
geometry + time), ``Z2KeySpace`` (point geometry), ``XZ3KeySpace`` and
``XZ2KeySpace`` (extent geometries, + time for xz3), ``S2KeySpace`` and
``S3KeySpace`` (S2 cell ids over point geometry, + time bins for s3),
``IdKeySpace`` (feature-id hash) and ``AttributeKeySpace`` (one attribute,
with a z2 tiebreak), with ``KeyPlan`` (full scans included), range merging,
window capping and the LSM append's insert positions. Per-bin window resolution is NumPy ``searchsorted`` (the
JAX package may use native C++ there; both give the same windows). The
range budget is ``geomesa.scan.ranges.target`` unless a caller passes one;
the per-shard window cap is an explicit argument instead of scoped
configuration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.binned_time import BinnedTime, TimePeriod
from geomesa_tpu_torch.curves.cover import ZRange
from geomesa_tpu_torch.curves.s2 import S2SFC
from geomesa_tpu_torch.curves.xz import XZ2SFC, XZ3SFC
from geomesa_tpu_torch.curves.zorder import Z2SFC, Z3SFC
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index import packsort
from geomesa_tpu_torch.schema.feature_type import FeatureType

MAX_WINDOW_BINS = 64  # collapse per-bin windows beyond this many time bins

#: per-shard budget for resolved scan windows (bins x z-ranges); beyond it
#: windows gap-union down (over-cover; the fine mask restores exactness)
MAX_SHARD_WINDOWS = 256


@dataclass
class KeyPlan:
    """Plan-time product of a key space for one query."""

    keyspace: "KeySpace"
    #: provably empty (disjoint bounds)
    disjoint: bool = False
    #: no key constraint: every row of every shard
    full_scan: bool = False
    #: z-ranges (over the full offset span for z3's middle bins); also the
    #: decider's selectivity input
    ranges: List[ZRange] = field(default_factory=list)
    #: time bins touched (z3)
    bins: Optional[np.ndarray] = None
    #: per z3 edge bin: time-tightened z-ranges
    edge: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    #: estimated fraction of the key space covered (a cost input)
    coverage: float = 1.0
    #: feature ids (id index)
    ids: Tuple[str, ...] = ()
    #: closed value bounds, None = open (attribute index)
    bounds: list = field(default_factory=list)

    def windows(self, shard_cols: Dict[str, np.ndarray], n: int,
                cap: int = MAX_SHARD_WINDOWS) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, ends) row windows for one shard's sorted key columns."""
        if self.disjoint:
            return np.zeros(1, np.int64), np.zeros(1, np.int64)
        if self.full_scan:
            return np.zeros(1, np.int64), np.full(1, n, np.int64)
        return self.keyspace.resolve_windows(self, shard_cols, n, cap)


class KeySpace:
    name: str = "base"   # unique per instance (table key)
    kind: str = "base"   # family (cost model / dispatch key)
    key_cols: Sequence[str] = ()
    #: False when appends always rebuild the table
    can_insert = True

    def supports(self, ft: FeatureType) -> bool:
        """Whether this key space can index the schema."""
        raise NotImplementedError

    def index_keys(self, ft: FeatureType, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Vectorized key encode for an ingest batch."""
        raise NotImplementedError

    def sort_order(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """argsort of the raw keys (the fallback of the pack-sort)."""
        raise NotImplementedError

    def fast_build(self, cols: Dict[str, np.ndarray],
                   force_shifts: Optional[Dict[str, int]] = None):
        """Radix pack-sort build: (order, key columns quantized by shifts,
        shifts), or None to fall back to :meth:`sort_order`.
        ``force_shifts`` pins the quantization to an existing table's."""
        return None

    def plan(self, ft: FeatureType, f: ir.Filter,
             ranges_target: Optional[int] = None) -> Optional[KeyPlan]:
        """None when this key space cannot serve the filter at all.
        ``ranges_target``: the cover's range budget (None:
        ``geomesa.scan.ranges.target``)."""
        raise NotImplementedError

    def resolve_windows(self, plan: KeyPlan, shard_cols, n: int, cap: int):
        raise NotImplementedError

    def insert_positions(self, sorted_key_cols: Dict[str, np.ndarray],
                         fresh_sorted: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """Merge positions of already-sorted fresh keys into the table's
        sorted key columns (equal keys land after the old rows): one
        searchsorted for a single key column, per fresh bin for (bin, key)
        pairs."""
        cols = list(self.key_cols)
        if len(cols) == 1:
            k = cols[0]
            return np.searchsorted(sorted_key_cols[k], fresh_sorted[k],
                                   side="right").astype(np.int64)
        if len(cols) == 2:
            bc, kc = cols
            bins_col, key_col = sorted_key_cols[bc], sorted_key_cols[kc]
            fb, fk = fresh_sorted[bc], fresh_sorted[kc]
            p = np.empty(len(fb), np.int64)
            for b in np.unique(fb):
                sel = fb == b
                s = int(np.searchsorted(bins_col, b, side="left"))
                e = int(np.searchsorted(bins_col, b, side="right"))
                p[sel] = s + np.searchsorted(key_col[s:e], fk[sel], side="right")
            return p
        return None


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


def _per_geom_ranges(cover_fn, bounds_list, ranges_target: int) -> List[ZRange]:
    """Cover each query geometry's bounds separately and merge: disjoint
    boxes get disjoint covers instead of one envelope cover."""
    all_r = [(int(r.lo), int(r.hi)) for b in bounds_list for r in cover_fn(b)]
    return [ZRange(lo, hi) for lo, hi in _merge_zranges(all_r, ranges_target)]


def _cap_windows(starts: np.ndarray, ends: np.ndarray, cap: int):
    """Merge overlapping half-open row windows; union the smallest gaps
    when more than ``cap`` remain."""
    return _merge_cap(starts, ends, cap, adjacent=0)


def _ranges_target(ranges_target: Optional[int]) -> int:
    return ranges_target or config.SCAN_RANGES_TARGET.to_int() or 2000


def _shift_of(shard_cols: Dict, col: str) -> int:
    """Quantization shift of a stored key column (0 on the argsort path)."""
    shifts = shard_cols.get("__shifts__")
    return 0 if shifts is None else shifts.get(col, 0)


def _coverage(ranges: List[ZRange], total_bits: int) -> float:
    return sum(r.hi - r.lo + 1 for r in ranges) / float(1 << total_bits)


def _empty_windows():
    return np.zeros(1, np.int64), np.zeros(1, np.int64)


def _range_bin_windows(bins_col: np.ndarray, z_col: np.ndarray, bins: np.ndarray,
                       ranges) -> Tuple[np.ndarray, np.ndarray]:
    """[zlo, zhi] windows of every range in every time bin over (bin, z)-
    sorted columns, only the non-empty ones, in range-major order (a loop
    over the ranges, then the bins); one vectorized search per bin."""
    los = np.asarray([r[0] for r in ranges], np.uint64)
    his = np.asarray([r[1] for r in ranges], np.uint64)
    ws, we = [], []
    for b in bins.tolist():
        s = int(np.searchsorted(bins_col, b, side="left"))
        e = int(np.searchsorted(bins_col, b, side="right"))
        if e <= s:
            continue
        seg = z_col[s:e]
        ws.append(s + np.searchsorted(seg, los, side="left"))
        we.append(s + np.searchsorted(seg, his, side="right"))
    if not ws or not len(los):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ws = np.stack(ws, axis=1).reshape(-1).astype(np.int64)
    we = np.stack(we, axis=1).reshape(-1).astype(np.int64)
    keep = we > ws
    return ws[keep], we[keep]


class Z3KeySpace(KeySpace):
    """(bin, z3) keys over point geometry + time."""

    name = "z3"
    kind = "z3"

    def __init__(self, geom: str, dtg: str, period: "str | TimePeriod" = TimePeriod.WEEK):
        self.geom = geom
        self.dtg = dtg
        self.sfc = Z3SFC(period)
        self.binned = self.sfc.binned
        self.key_cols = ("__z3_bin", "__z3")

    def index_keys(self, ft: FeatureType, cols: Dict[str, np.ndarray]):
        """Reuses the batch's ``<dtg>__bin`` column when its period matches."""
        bin_col = self.dtg + "__bin"
        if bin_col in cols and ft.time_period == self.binned.period:
            b = cols[bin_col]
            off = self.binned.offset_from_bin(cols[self.dtg], b)
        else:
            b, off = self.binned.to_bin_and_offset(cols[self.dtg])
        z = self.sfc.index(cols[self.geom + "__x"], cols[self.geom + "__y"], off)
        return {"__z3_bin": np.asarray(b, np.int32), "__z3": z}

    def sort_order(self, cols):
        return np.lexsort((cols["__z3"], cols["__z3_bin"]))

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__z3")
        out = packsort.pack_sort(cols["__z3"], 63, prefix=cols["__z3_bin"],
                                 force_shift=fs)
        if out is None:
            return None
        perm, zq, bins_sorted, shift = out
        return perm, {"__z3_bin": bins_sorted, "__z3": zq}, {"__z3": shift}

    def supports(self, ft):
        return (ft.has(self.geom) and ft.attr(self.geom).is_point
                and ft.has(self.dtg) and ft.attr(self.dtg).type == "date")

    def plan(self, ft, f, ranges_target=None):
        """None when the filter has no time bound (z3 cannot serve it)."""
        ranges_target = _ranges_target(ranges_target)
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
        ranges = _per_geom_ranges(
            lambda b: self.sfc.ranges((b[0], b[2]), (b[1], b[3]), (0.0, max_off),
                                      ranges_target),
            xy, ranges_target,
        )
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
        cov = _coverage(ranges, 63) * min(1.0, len(bins) / max(len(bins), 1))
        return KeyPlan(
            self, ranges=ranges, bins=bins.astype(np.int32), coverage=cov,
            edge={b: _merge_zranges(rs, ranges_target) for b, rs in edge.items()},
        )

    def resolve_windows(self, plan, shard_cols, n, cap):
        bins_col = shard_cols["__z3_bin"]
        z_col = shard_cols["__z3"]
        sh = _shift_of(shard_cols, "__z3")
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
                b: _merge_zranges([(lo >> sh, hi >> sh) for lo, hi in rs], per_bin_cap)
                for b, rs in plan.edge.items()
            }
            sets = cache[(sh, cap)] = (base, esets)
        base, esets = sets
        starts: List[int] = []
        ends: List[int] = []
        plain = np.asarray([b for b in bins.tolist() if b not in esets], np.int32)
        ws, we = _range_bin_windows(bins_col, z_col, plain, base)
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
            return _empty_windows()
        return _cap_windows(np.asarray(starts, np.int64), np.asarray(ends, np.int64), cap)


class Z2KeySpace(KeySpace):
    """z2 keys over point geometry."""

    name = "z2"
    kind = "z2"

    def __init__(self, geom: str):
        self.geom = geom
        self.sfc = Z2SFC()
        self.key_cols = ("__z2",)

    def index_keys(self, ft, cols):
        return {"__z2": self.sfc.index(cols[self.geom + "__x"], cols[self.geom + "__y"])}

    def sort_order(self, cols):
        return np.argsort(cols["__z2"], kind="stable")

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__z2")
        out = packsort.pack_sort(cols["__z2"], 62, force_shift=fs)
        if out is None:
            return None
        perm, zq, _, shift = out
        return perm, {"__z2": zq}, {"__z2": shift}

    def supports(self, ft):
        return ft.has(self.geom) and ft.attr(self.geom).is_point

    def plan(self, ft, f, ranges_target=None):
        """A full scan when the filter has no spatial bound."""
        ranges_target = _ranges_target(ranges_target)
        geoms = ir.extract_geometries(f, self.geom)
        if geoms.disjoint:
            return KeyPlan(self, disjoint=True)
        if geoms.is_empty:
            return KeyPlan(self, full_scan=True)
        ranges = _per_geom_ranges(
            lambda b: self.sfc.ranges(*b, ranges_target),
            [g.bounds() for g in geoms.values], ranges_target,
        )
        return KeyPlan(self, ranges=ranges, coverage=_coverage(ranges, 62))

    def resolve_windows(self, plan, shard_cols, n, cap):
        # every range its own window: disjoint query boxes scan only
        # their own covers, not the [zmin, zmax] envelope
        z_col = shard_cols["__z2"]
        sh = _shift_of(shard_cols, "__z2")
        rs = _merge_zranges([(r.lo >> sh, r.hi >> sh) for r in plan.ranges], cap)
        if not rs:
            return _empty_windows()
        los = np.asarray([r[0] for r in rs], z_col.dtype)
        his = np.asarray([r[1] for r in rs], z_col.dtype)
        ws = np.searchsorted(z_col, los, side="left")
        we = np.searchsorted(z_col, his, side="right")
        keep = we > ws
        if not keep.any():
            return _empty_windows()
        return _cap_windows(ws[keep].astype(np.int64), we[keep].astype(np.int64), cap)


class XZ2KeySpace(KeySpace):
    """xz2 codes over extent geometries' bounds."""

    name = "xz2"
    kind = "xz2"

    def __init__(self, geom: str, g: int = 12):
        self.geom = geom
        self.sfc = XZ2SFC(g=g)
        self.key_cols = ("__xz2",)

    def supports(self, ft):
        a = ft.attr(self.geom) if ft.has(self.geom) else None
        return a is not None and a.is_geom and not a.is_point

    def index_keys(self, ft, cols):
        return {"__xz2": self.sfc.index(
            cols[self.geom + "__xmin"], cols[self.geom + "__ymin"],
            cols[self.geom + "__xmax"], cols[self.geom + "__ymax"])}

    def sort_order(self, cols):
        return np.argsort(cols["__xz2"], kind="stable")

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__xz2")
        code = cols["__xz2"].astype(np.uint64)  # sequence codes, nonnegative
        bits = int(self.sfc.subtree_size[0]).bit_length()
        out = packsort.pack_sort(code, bits, force_shift=fs)
        if out is None:
            return None
        perm, cq, _, shift = out
        return perm, {"__xz2": cq}, {"__xz2": shift}

    def plan(self, ft, f, ranges_target=None):
        """One cover of the query geometries' bounding box (the xz covers
        keep their own 2000-range budget)."""
        geoms = ir.extract_geometries(f, self.geom)
        if geoms.disjoint:
            return KeyPlan(self, disjoint=True)
        if geoms.is_empty:
            return KeyPlan(self, full_scan=True)
        bs = np.asarray([g.bounds() for g in geoms.values])
        bbox = (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())
        ranges = self.sfc.ranges(*bbox)
        span = sum(r.hi - r.lo + 1 for r in ranges)
        return KeyPlan(self, ranges=ranges, coverage=span / self.sfc.subtree_size[0])

    def resolve_windows(self, plan, shard_cols, n, cap):
        # xz ranges are not contiguous (singleton parent codes interleave):
        # each merged range resolves to its own window, capped at
        # MAX_WINDOW_BINS by uniting the smallest gaps
        col = shard_cols["__xz2"]
        sh = _shift_of(shard_cols, "__xz2")
        starts, ends = [], []
        for r in plan.ranges:
            s = np.searchsorted(col, r.lo >> sh, side="left")
            e = np.searchsorted(col, r.hi >> sh, side="right")
            if e > s:
                starts.append(s)
                ends.append(e)
        if not starts:
            return _empty_windows()
        return _cap_windows(np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                            MAX_WINDOW_BINS)


class XZ3KeySpace(KeySpace):
    """(bin, xz3) codes over extent geometries' bounds + time."""

    name = "xz3"
    kind = "xz3"

    def __init__(self, geom: str, dtg: str,
                 period: "str | TimePeriod" = TimePeriod.WEEK, g: int = 12):
        self.geom = geom
        self.dtg = dtg
        self.sfc = XZ3SFC(period, g=g)
        self.binned = self.sfc.binned
        self.key_cols = ("__xz3_bin", "__xz3")

    def supports(self, ft):
        a = ft.attr(self.geom) if ft.has(self.geom) else None
        return (a is not None and a.is_geom and not a.is_point
                and ft.has(self.dtg) and ft.attr(self.dtg).type == "date")

    def index_keys(self, ft, cols):
        """Reuses the batch's ``<dtg>__bin`` column when its period
        matches."""
        bin_col = self.dtg + "__bin"
        if bin_col in cols and ft.time_period == self.binned.period:
            b = cols[bin_col]
            off = self.binned.offset_from_bin(cols[self.dtg], b)
        else:
            b, off = self.binned.to_bin_and_offset(cols[self.dtg])
        code = self.sfc.index(
            cols[self.geom + "__xmin"], cols[self.geom + "__ymin"], off,
            cols[self.geom + "__xmax"], cols[self.geom + "__ymax"], off)
        return {"__xz3_bin": np.asarray(b, np.int32), "__xz3": code}

    def sort_order(self, cols):
        return np.lexsort((cols["__xz3"], cols["__xz3_bin"]))

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__xz3")
        bits = int(self.sfc.subtree_size[0]).bit_length()
        out = packsort.pack_sort(cols["__xz3"].astype(np.uint64), bits,
                                 prefix=cols["__xz3_bin"], force_shift=fs)
        if out is None:
            return None
        perm, cq, bins_sorted, shift = out
        return perm, {"__xz3_bin": bins_sorted, "__xz3": cq}, {"__xz3": shift}

    def plan(self, ft, f, ranges_target=None):
        """None when the filter has no time bound; one cover of the
        geometries' bounding box over the whole offset span."""
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
        if geoms.is_empty:
            bbox = (-180.0, -90.0, 180.0, 90.0)
        else:
            bs = np.asarray([g.bounds() for g in geoms.values])
            bbox = (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())
        ranges = self.sfc.ranges((bbox[0], bbox[2]), (bbox[1], bbox[3]),
                                 (0.0, float(self.binned.max_offset_ms)))
        span = sum(r.hi - r.lo + 1 for r in ranges)
        return KeyPlan(self, ranges=ranges, bins=bins.astype(np.int32),
                       coverage=span / self.sfc.subtree_size[0])

    def resolve_windows(self, plan, shard_cols, n, cap):
        bins_col = shard_cols["__xz3_bin"]
        code_col = shard_cols["__xz3"]
        sh = _shift_of(shard_cols, "__xz3")
        bins = plan.bins
        if len(bins) > 8:  # xz windows multiply per bin: collapse earlier
            s = np.searchsorted(bins_col, bins[0], side="left")
            e = np.searchsorted(bins_col, bins[-1], side="right")
            return np.asarray([s], np.int64), np.asarray([e], np.int64)
        starts, ends = [], []
        for b in bins.tolist():
            s = np.searchsorted(bins_col, b, side="left")
            e = np.searchsorted(bins_col, b, side="right")
            if e <= s:
                continue
            seg = code_col[s:e]
            for r in plan.ranges:
                s2 = s + np.searchsorted(seg, r.lo >> sh, side="left")
                e2 = s + np.searchsorted(seg, r.hi >> sh, side="right")
                if e2 > s2:
                    starts.append(s2)
                    ends.append(e2)
        if not starts:
            return _empty_windows()
        return _cap_windows(np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                            MAX_WINDOW_BINS)


#: the S2 key space's extent: 6 faces of 2^60 Hilbert positions (the
#: coverage divisor of an s2 / s3 plan)
_S2_SPAN = float(6 << 60)


def _s2_cover(keyspace, f) -> Tuple[Optional[List[ZRange]], bool]:
    """(ranges, disjoint) of a filter's geometries over S2 leaf ids: one
    cover of the geometries' common bounding box; (None, False) when the
    filter bounds no geometry."""
    geoms = ir.extract_geometries(f, keyspace.geom)
    if geoms.disjoint:
        return None, True
    if geoms.is_empty:
        return None, False
    bs = np.asarray([g.bounds() for g in geoms.values])
    bbox = (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())
    return keyspace.sfc.ranges(*bbox), False


def _s2_windows(col: np.ndarray, ranges, sh: int, base: int = 0):
    """Row windows of each leaf-id range over a sorted (quantized) key
    segment, the non-empty ones, in range order."""
    starts, ends = [], []
    for r in ranges:
        s = base + np.searchsorted(col, np.uint64(r.lo >> sh), side="left")
        e = base + np.searchsorted(col, np.uint64(r.hi >> sh), side="right")
        if e > s:
            starts.append(s)
            ends.append(e)
    return starts, ends


class S2KeySpace(KeySpace):
    """S2 cell-id keys over point geometry (the reference's S2Index; the cell
    math is ``curves/s2.py``). Covers ignore the planner's range budget and
    windows cap at :data:`MAX_WINDOW_BINS`, as the JAX package's do."""

    name = "s2"
    kind = "s2"

    def __init__(self, geom: str):
        self.geom = geom
        self.sfc = S2SFC(max_cells=64)
        self.key_cols = ("__s2",)

    def supports(self, ft):
        return ft.has(self.geom) and ft.attr(self.geom).is_point

    def index_keys(self, ft, cols):
        return {"__s2": self.sfc.index(cols[self.geom + "__x"], cols[self.geom + "__y"])}

    def sort_order(self, cols):
        return np.argsort(cols["__s2"], kind="stable")

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__s2")
        out = packsort.pack_sort(cols["__s2"], 64, force_shift=fs)
        if out is None:
            return None
        perm, cq, _, shift = out
        return perm, {"__s2": cq}, {"__s2": shift}

    def plan(self, ft, f, ranges_target=None):
        ranges, disjoint = _s2_cover(self, f)
        if disjoint:
            return KeyPlan(self, disjoint=True)
        if ranges is None:
            return KeyPlan(self, full_scan=True)
        span = sum(r.hi - r.lo + 1 for r in ranges)
        return KeyPlan(self, ranges=ranges, coverage=span / _S2_SPAN)

    def resolve_windows(self, plan, shard_cols, n, cap):
        starts, ends = _s2_windows(shard_cols["__s2"], plan.ranges,
                                   _shift_of(shard_cols, "__s2"))
        if not starts:
            return _empty_windows()
        return _cap_windows(np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                            MAX_WINDOW_BINS)


class S3KeySpace(KeySpace):
    """(time bin, S2 cell id) keys: the reference's S3Index (S2 space and
    BinnedTime period bins). More than 8 bins, or no geometry bound, scan
    the bins' whole run."""

    name = "s3"
    kind = "s3"

    def __init__(self, geom: str, dtg: str, period: "str | TimePeriod" = TimePeriod.WEEK):
        self.geom = geom
        self.dtg = dtg
        self.sfc = S2SFC(max_cells=64)
        self.binned = BinnedTime(period)
        self.key_cols = ("__s3_bin", "__s3")

    def supports(self, ft):
        return (ft.has(self.geom) and ft.attr(self.geom).is_point
                and ft.has(self.dtg) and ft.attr(self.dtg).type == "date")

    def index_keys(self, ft, cols):
        """Reuses the batch's ``<dtg>__bin`` column when its period matches."""
        bin_col = self.dtg + "__bin"
        if bin_col in cols and ft.time_period == self.binned.period:
            b = cols[bin_col]
        else:
            b, _ = self.binned.to_bin_and_offset(cols[self.dtg])
        return {
            "__s3_bin": np.asarray(b, np.int32),
            "__s3": self.sfc.index(cols[self.geom + "__x"], cols[self.geom + "__y"]),
        }

    def sort_order(self, cols):
        return np.lexsort((cols["__s3"], cols["__s3_bin"]))

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__s3")
        out = packsort.pack_sort(cols["__s3"], 64, prefix=cols["__s3_bin"],
                                 force_shift=fs)
        if out is None:
            return None
        perm, cq, bins_sorted, shift = out
        return perm, {"__s3_bin": bins_sorted, "__s3": cq}, {"__s3": shift}

    def plan(self, ft, f, ranges_target=None):
        """None when the filter has no time bound (s3 cannot serve it)."""
        intervals = ir.extract_intervals(f, self.dtg)
        ranges, disjoint = _s2_cover(self, f)
        if disjoint or intervals.disjoint:
            return KeyPlan(self, disjoint=True)
        if intervals.is_empty:
            return None
        CLAMP = 2**45
        iv = [(max(lo, -CLAMP), min(hi, CLAMP)) for lo, hi in intervals.values]
        bins = np.unique(
            np.concatenate([self.binned.bins_between(lo, hi) for lo, hi in iv])
        ).astype(np.int32)
        if ranges is None:
            return KeyPlan(self, ranges=[], bins=bins, coverage=1.0)
        span = sum(r.hi - r.lo + 1 for r in ranges)
        return KeyPlan(self, ranges=ranges, bins=bins, coverage=span / _S2_SPAN)

    def resolve_windows(self, plan, shard_cols, n, cap):
        bins_col = shard_cols["__s3_bin"]
        col = shard_cols["__s3"]
        bins = plan.bins
        if len(bins) > 8 or not plan.ranges:
            s = np.searchsorted(bins_col, bins[0], side="left")
            e = np.searchsorted(bins_col, bins[-1], side="right")
            return np.asarray([s], np.int64), np.asarray([e], np.int64)
        sh = _shift_of(shard_cols, "__s3")
        starts, ends = [], []
        for b in bins.tolist():
            s = np.searchsorted(bins_col, b, side="left")
            e = np.searchsorted(bins_col, b, side="right")
            if e > s:
                ws, we = _s2_windows(col[s:e], plan.ranges, sh, int(s))
                starts += ws
                ends += we
        if not starts:
            return _empty_windows()
        return _cap_windows(np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                            MAX_WINDOW_BINS)


class IdKeySpace(KeySpace):
    """Feature-id index, keyed by a 64-bit hash of the fid: the window of
    hash(fid) is a superset (collisions included) and the ``IdIn`` mask
    applies exact fid equality to the window rows."""

    name = "id"
    kind = "id"
    key_cols = ("__idhash",)

    def index_keys(self, ft, cols):
        return {"__idhash": packsort.fid_hash64(cols["__fid__"])}

    def sort_order(self, cols):
        return np.argsort(cols["__idhash"], kind="stable")

    def fast_build(self, cols, force_shifts=None):
        fs = None if force_shifts is None else force_shifts.get("__idhash")
        out = packsort.pack_sort(cols["__idhash"], 64, force_shift=fs)
        if out is None:
            return None
        perm, hq, _, shift = out
        return perm, {"__idhash": hq}, {"__idhash": shift}

    def supports(self, ft):
        return True

    def plan(self, ft, f, ranges_target=None):
        ids = ir.extract_ids(f)
        if ids is None:
            return None
        return KeyPlan(self, coverage=0.0, ids=tuple(sorted(ids)))

    def resolve_windows(self, plan, shard_cols, n, cap):
        col = shard_cols["__idhash"]
        sh = _shift_of(shard_cols, "__idhash")
        starts, ends = [], []
        for fid in plan.ids:
            h = np.uint64(packsort.fid_hash64_one(fid) >> sh)
            s = np.searchsorted(col, h, side="left")
            e = np.searchsorted(col, h, side="right")
            if e > s:
                starts.append(s)
                ends.append(e)
        if not starts:
            return _empty_windows()
        return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


class AttributeKeySpace(KeySpace):
    """Per-attribute sorted index; rows of equal value are ordered by
    their z2 key (a spatial-locality tiebreak). Strings sort by the rank
    of their value in the dictionary, which the table builds."""

    kind = "attr"
    #: string ranks re-rank on dictionary growth and the tiebreak is a
    #: second sort key: appends always rebuild
    can_insert = False

    #: attribute type -> numpy dtype of the stored column
    _NP_TYPES = {
        "int32": np.int32, "int64": np.int64, "float32": np.float32,
        "float64": np.float64, "date": np.int64, "bool": np.bool_,
    }

    def __init__(self, attr: str, geom: Optional[str] = None,
                 attr_type: Optional[str] = None):
        self.attr = attr
        self.geom = geom
        self.attr_type = attr_type
        self.name = f"attr:{attr}"
        self.key_cols = (f"__attr_{attr}",)

    @property
    def sort_col(self) -> str:
        return f"__attr_{self.attr}"

    def index_keys(self, ft, cols):
        vals = cols[self.attr]
        if ft.attr(self.attr).type == "string":
            # raw codes here; the table re-ranks them to value order
            return {self.sort_col: vals.astype(np.int64)}
        return {self.sort_col: vals}

    def sort_order(self, cols):
        if self.geom and "__z2" in cols:
            return np.lexsort((cols["__z2"], cols[self.sort_col]))
        return np.argsort(cols[self.sort_col], kind="stable")

    def fast_build(self, cols, force_shifts=None):
        col = cols[self.sort_col]
        if self.attr_type == "string":
            # rank column (small ints; -1 = null sorts first as 0)
            key = (col.astype(np.int64) + 1).astype(np.uint64)
            bits = packsort.bits_for(int(key.max()) + 1) if len(key) else 1
        else:
            try:
                key, bits = packsort.to_ordered_u64(col)
            except TypeError:
                return None
        tb, tb_bits = None, 0
        if self.geom and "__z2" in cols:
            tb = cols["__z2"].astype(np.uint64) << np.uint64(2)  # 62 bits -> top
            tb_bits = 16  # spatial-locality tiebreak, best effort
        fs = None if force_shifts is None else force_shifts.get(self.sort_col)
        out = packsort.pack_sort(key, bits, tiebreak=tb, tiebreak_bits=tb_bits,
                                 force_shift=fs)
        if out is None:
            return None
        perm, kq, _, shift = out
        return perm, {self.sort_col: kq}, {self.sort_col: shift}

    def supports(self, ft):
        return ft.has(self.attr) and not ft.attr(self.attr).is_geom

    def plan(self, ft, f, ranges_target=None):
        bounds = ir.extract_attr_bounds(f, self.attr)
        if bounds.disjoint:
            return KeyPlan(self, disjoint=True)
        if bounds.is_empty:
            return None
        return KeyPlan(self, coverage=0.1, bounds=list(bounds.values))

    def resolve_windows(self, plan, shard_cols, n, cap):
        col = shard_cols[self.sort_col]
        shifts = shard_cols.get("__shifts__") or {}
        # fast-built tables store the ordered-u64 quantized key; bounds go
        # through the same transform (presence in shifts marks the path)
        fastq = self.sort_col in shifts
        sh = shifts.get(self.sort_col, 0)
        np_type = self._NP_TYPES.get(self.attr_type)
        starts, ends = [], []
        for lo, hi in plan.bounds:
            if self.attr_type == "string":
                # bounds are strings: mapped through the rank dictionary
                rank = shard_cols.get("__rank_lookup__")
                if rank is None:
                    return np.zeros(1, np.int64), np.full(1, n, np.int64)
                lo2 = rank(lo, "lo") if lo is not None else None
                hi2 = rank(hi, "hi") if hi is not None else None
                if fastq:
                    lo2 = None if lo2 is None else np.uint64((lo2 + 1) >> sh)
                    hi2 = None if hi2 is None else np.uint64((hi2 + 1) >> sh)
            elif fastq:
                lo2 = None if lo is None else np.uint64(
                    packsort.ordered_u64_scalar(lo, np_type) >> sh)
                hi2 = None if hi is None else np.uint64(
                    packsort.ordered_u64_scalar(hi, np_type) >> sh)
            else:
                lo2, hi2 = lo, hi
                if self.attr_type == "date":
                    lo2 = None if lo is None else np.int64(lo)
                    hi2 = None if hi is None else np.int64(hi)
            s = 0 if lo2 is None else int(np.searchsorted(col, lo2, side="left"))
            e = n if hi2 is None else int(np.searchsorted(col, hi2, side="right"))
            if e > s:
                starts.append(s)
                ends.append(e)
        if not starts:
            return _empty_windows()
        return _cap_windows(np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                            MAX_WINDOW_BINS)


def keyspaces_for_schema(ft: FeatureType) -> List[KeySpace]:
    """The indices of a schema: z3 (with a date) and z2 for a point
    geometry, xz3 (with a date) and xz2 for an extent geometry, id, and an
    attribute index for every ``index=true`` attribute that is not Json.
    The ``geomesa.indices`` user-data key overrides them with a
    comma-separated list of index kinds (z3, z2, xz3, xz2, s2, s3, id,
    attr); kinds the schema cannot carry drop out."""
    geom = ft.geom_field
    dtg = ft.dtg_field
    explicit = ft.user_data.get("geomesa.indices")
    if explicit:
        wanted = [k.strip().lower() for k in explicit.split(",") if k.strip()]
    else:
        wanted = []
        if geom is not None:
            if ft.attr(geom).is_point:
                if dtg is not None:
                    wanted.append("z3")
                wanted.append("z2")
            else:
                if dtg is not None:
                    wanted.append("xz3")
                wanted.append("xz2")
        wanted += ["id", "attr"]
    out: List[KeySpace] = []
    for kind in wanted:
        if kind == "z3" and geom and dtg:
            out.append(Z3KeySpace(geom, dtg, ft.time_period))
        elif kind == "z2" and geom:
            out.append(Z2KeySpace(geom))
        elif kind == "xz3" and geom and dtg:
            out.append(XZ3KeySpace(geom, dtg, ft.time_period))
        elif kind == "xz2" and geom:
            out.append(XZ2KeySpace(geom))
        elif kind == "s2" and geom:
            out.append(S2KeySpace(geom))
        elif kind == "s3" and geom and dtg:
            out.append(S3KeySpace(geom, dtg, ft.time_period))
        elif kind == "id":
            out.append(IdKeySpace())
        elif kind == "attr":
            for a in ft.attributes:
                if a.indexed and not a.is_geom and a.type != "json":
                    out.append(AttributeKeySpace(a.name, geom, a.type))
    if not any(isinstance(k, IdKeySpace) for k in out):
        out.append(IdKeySpace())
    return [k for k in out if k.supports(ft)]
