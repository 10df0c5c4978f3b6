"""Write-time sketches the cost-based decider and ``bounds()`` read.

Copy of ``geomesa_tpu/stats/sketches.py`` cut to ``CountStat``, ``MinMax``,
``EnumerationStat`` and the Z3 / Z2 histograms, with only ``observe`` and
``estimate_count``. Sketches observe the encoded columns: strings as
dictionary codes, dates as epoch-ms, points as ``<geom>__x``/``__y``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from geomesa_tpu_torch.curves.binned_time import BinnedTime, TimePeriod
from geomesa_tpu_torch.curves.zorder import Z2SFC, Z3SFC

Columns = Dict[str, np.ndarray]


class CountStat:
    """Total observed count."""

    def __init__(self):
        self.count = 0

    def observe(self, columns: Columns) -> None:
        self.count += len(next(iter(columns.values())))

    @property
    def is_empty(self):
        return self.count == 0


class MinMax:
    """Min / max of a numeric or date column; for a geometry, its bounding
    box (min / max of x and y)."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.lo = None
        self.hi = None
        self.count = 0

    def _columns_for(self, columns: Columns) -> List[np.ndarray]:
        if self.attribute + "__x" in columns:  # geometry: track bbox
            return [columns[self.attribute + "__x"], columns[self.attribute + "__y"]]
        return [columns[self.attribute]]

    def observe(self, columns: Columns) -> None:
        cols = [np.asarray(c) for c in self._columns_for(columns)]
        if cols[0].size == 0:
            return
        self.count += int(cols[0].size)
        los = [float(np.min(c)) for c in cols]
        his = [float(np.max(c)) for c in cols]
        if len(cols) == 1:
            los, his = los[0], his[0]
        if self.lo is None:
            self.lo, self.hi = los, his
        elif len(cols) == 1:
            self.lo, self.hi = min(self.lo, los), max(self.hi, his)
        else:
            self.lo = [min(a, b) for a, b in zip(self.lo, los)]
            self.hi = [max(a, b) for a, b in zip(self.hi, his)]

    @property
    def is_empty(self):
        return self.count == 0


class EnumerationStat:
    """Exact value -> count (dictionary codes for strings)."""

    def __init__(self, attribute: str):
        self.attribute = attribute
        self.counts: Dict[Any, int] = {}

    def observe(self, columns: Columns) -> None:
        vals = np.asarray(columns[self.attribute])
        uniq, cnt = np.unique(vals, return_counts=True)
        for u, c in zip(uniq.tolist(), cnt.tolist()):
            self.counts[u] = self.counts.get(u, 0) + int(c)

    @property
    def is_empty(self):
        return not self.counts


def _range_estimate(counts: np.ndarray, shift: int, zranges) -> float:
    """Rows of a bucket histogram (bucket = key >> shift) inside z-ranges:
    fractional edge buckets plus whole middle buckets."""
    total = 0.0
    bucket_span = 1 << shift
    for r in zranges:
        b0, b1 = r.lo >> shift, r.hi >> shift
        if b0 == b1:
            total += float(counts[b0]) * ((r.hi - r.lo + 1) / bucket_span)
        else:
            total += float(counts[b0]) * (((b0 + 1) * bucket_span - r.lo) / bucket_span)
            total += float(counts[b1]) * ((r.hi - b1 * bucket_span + 1) / bucket_span)
            if b1 > b0 + 1:
                total += float(counts[b0 + 1 : b1].sum())
    return total


class Z3HistogramStat:
    """Counts per (time bin, top bits of the z3 key): the z3 index's
    selectivity estimator."""

    def __init__(self, geom: str, dtg: str,
                 period: "str | TimePeriod" = TimePeriod.WEEK, length: int = 1024):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.length = int(length)
        self.sfc = Z3SFC(self.period)
        self.binned = BinnedTime(self.period)
        # z >> shift yields a bucket in [0, length)
        self.shift = 63 - int(np.log2(self.length))
        self.bins: Dict[int, np.ndarray] = {}

    def observe(self, columns: Columns) -> None:
        # reuse the ingest's (bin, z3) keys only when the marker says they
        # were built with this sketch's time period
        if "__z3" in columns and columns.get("__z3_period") == self.period.value:
            b = np.asarray(columns["__z3_bin"])
            z = np.asarray(columns["__z3"], np.uint64)
        else:
            xs = np.asarray(columns[self.geom + "__x"])
            ys = np.asarray(columns[self.geom + "__y"])
            ts = np.asarray(columns[self.dtg])  # epoch ms
            if xs.size == 0:
                return
            b, off = self.binned.to_bin_and_offset(ts)
            z = self.sfc.index(xs, ys, off)
        if z.size == 0:
            return
        bucket = (z >> np.uint64(self.shift)).astype(np.int32)
        bmin, bmax = int(b.min()), int(b.max())
        if bmin == bmax:
            if bmin not in self.bins:
                self.bins[bmin] = np.zeros(self.length, dtype=np.int64)
            self.bins[bmin] += np.bincount(bucket, minlength=self.length)
            return
        span = bmax - bmin + 1
        if span * self.length > (1 << 22):  # sparse: one bincount per bin
            for bb in np.unique(b).tolist():
                sel = np.asarray(b) == bb
                if bb not in self.bins:
                    self.bins[bb] = np.zeros(self.length, dtype=np.int64)
                self.bins[bb] += np.bincount(bucket[sel], minlength=self.length)
            return
        # one composite bincount over (bin, bucket)
        rel = (np.asarray(b, np.int64) - bmin) * np.int64(self.length) + bucket
        counts = np.bincount(rel, minlength=span * self.length).reshape(
            span, self.length
        )
        for i in np.nonzero(counts.any(axis=1))[0].tolist():
            bb = bmin + i
            if bb not in self.bins:
                self.bins[bb] = counts[i].astype(np.int64)
            else:
                self.bins[bb] += counts[i]

    @property
    def is_empty(self):
        return not self.bins

    def estimate_count(self, time_bins: np.ndarray, zranges) -> float:
        """Estimated matches for z-ranges within the given time bins."""
        total = 0.0
        for bb in np.asarray(time_bins).tolist():
            counts = self.bins.get(int(bb))
            if counts is not None:
                total += _range_estimate(counts, self.shift, zranges)
        return total


class Z2HistogramStat:
    """Counts per top bits of the z2 key: the z2 index's selectivity
    estimator."""

    def __init__(self, geom: str, length: int = 1024):
        self.geom = geom
        self.length = int(length)
        self.sfc = Z2SFC()
        self.shift = 62 - int(np.log2(self.length))
        self.counts = np.zeros(self.length, dtype=np.int64)

    def observe(self, columns: Columns) -> None:
        if "__z2" in columns:  # ingest already computed the key column
            z = np.asarray(columns["__z2"], np.uint64)
        else:
            xs = np.asarray(columns[self.geom + "__x"])
            ys = np.asarray(columns[self.geom + "__y"])
            if xs.size == 0:
                return
            z = self.sfc.index(xs, ys)
        if z.size == 0:
            return
        bucket = (z >> np.uint64(self.shift)).astype(np.int32)
        self.counts += np.bincount(bucket, minlength=self.length)

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    def estimate_count(self, zranges) -> float:
        return _range_estimate(self.counts, self.shift, zranges)
