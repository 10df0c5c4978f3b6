"""Mergeable statistics sketches.

Copy of ``geomesa_tpu/stats/sketches.py``: Count, MinMax, Enumeration, TopK,
Histogram (binned), Frequency (count-min), DescriptiveStats, GroupBy, the
Z3 / Z2 histograms, Z3Frequency and SeqStat, each with ``observe``,
``merge``, ``value`` and ``to_json`` / ``from_json`` (``unobserve`` and
``Histogram.count_between`` stay out: nothing in the port calls them).

Contract (the reference's ``Stat`` trait):

* ``observe(columns)`` — ingest a batch (dict of column arrays + optional
  boolean mask). Vectorized; no per-row Python.
* ``merge(other)`` — combine two sketches; the cross-shard reduction.
* ``to_json()/from_json()`` — the persistence format.
* ``is_empty`` — whether anything was observed.

Sketches observe the *encoded* columns: strings as dictionary codes
(int32), dates as epoch-ms int64, points as ``<name>__x`` / ``<name>__y``
float64 columns. ``kernels/stats_scan.py`` computes the device partial
states of the kinds it supports.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.curves.binned_time import BinnedTime, TimePeriod
from geomesa_tpu_torch.curves.zorder import Z2SFC, Z3SFC


Columns = Dict[str, np.ndarray]


def _masked(values: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    if mask is None:
        return values
    return values[mask]


class Stat:
    """Base sketch."""

    kind: str = "stat"

    def observe(self, columns: Columns, mask: Optional[np.ndarray] = None) -> None:
        raise NotImplementedError

    def merge(self, other: "Stat") -> None:
        raise NotImplementedError

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    def value(self) -> Any:
        """Human-consumable result (the reference's ``toJson`` payload)."""
        raise NotImplementedError

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, **self._state()})

    def _state(self) -> Dict[str, Any]:
        raise NotImplementedError

    @staticmethod
    def from_json(s: str) -> "Stat":
        d = json.loads(s)
        cls = _KINDS[d.pop("kind")]
        return cls._from_state(d)


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


def _arr_to_b64(a: np.ndarray) -> Dict[str, Any]:
    return {
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "data": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode(),
    }


def _arr_from_b64(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])
    ).reshape(d["shape"]).copy()


class CountStat(Stat):
    """Total observed count (reference CountStat)."""

    kind = "count"

    def __init__(self, count: int = 0):
        self.count = int(count)

    def observe(self, columns, mask=None):
        n = len(next(iter(columns.values())))
        self.count += int(mask.sum()) if mask is not None else n

    def merge(self, other):
        self.count += other.count

    @property
    def is_empty(self):
        return self.count == 0

    def value(self):
        return self.count

    def _state(self):
        return {"count": self.count}

    @classmethod
    def _from_state(cls, d):
        return cls(d["count"])


class MinMax(Stat):
    """Min/max of a numeric/date column; for geometries, the bounding box
    (min/max of x and y). Reference: MinMax.scala."""

    kind = "minmax"

    def __init__(self, attribute: str, lo=None, hi=None, count: int = 0):
        self.attribute = attribute
        self.lo = lo
        self.hi = hi
        self.count = int(count)

    def _columns_for(self, columns: Columns) -> List[np.ndarray]:
        if self.attribute + "__x" in columns:  # geometry: track bbox
            return [columns[self.attribute + "__x"], columns[self.attribute + "__y"]]
        return [columns[self.attribute]]

    def observe(self, columns, mask=None):
        cols = [_masked(np.asarray(c), mask) for c in self._columns_for(columns)]
        if cols[0].size == 0:
            return
        self.count += int(cols[0].size)
        los = [float(np.min(c)) for c in cols]
        his = [float(np.max(c)) for c in cols]
        if len(cols) == 1:
            los, his = los[0], his[0]
        if self.lo is None:
            self.lo, self.hi = los, his
        else:
            if len(cols) == 1:
                self.lo, self.hi = min(self.lo, los), max(self.hi, his)
            else:
                self.lo = [min(a, b) for a, b in zip(self.lo, los)]
                self.hi = [max(a, b) for a, b in zip(self.hi, his)]

    def merge(self, other: "MinMax"):
        if other.is_empty:
            return
        if self.is_empty:
            self.lo, self.hi, self.count = other.lo, other.hi, other.count
            return
        self.count += other.count
        if isinstance(self.lo, list):
            self.lo = [min(a, b) for a, b in zip(self.lo, other.lo)]
            self.hi = [max(a, b) for a, b in zip(self.hi, other.hi)]
        else:
            self.lo, self.hi = min(self.lo, other.lo), max(self.hi, other.hi)

    @property
    def is_empty(self):
        return self.count == 0

    def value(self):
        return {"min": self.lo, "max": self.hi, "cardinality": self.count}

    def _state(self):
        return {"attribute": self.attribute, "lo": self.lo, "hi": self.hi, "count": self.count}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attribute"], d["lo"], d["hi"], d["count"])


class EnumerationStat(Stat):
    """Exact value->count (reference EnumerationStat). Operates on dictionary
    codes for strings; raw values for small-cardinality ints."""

    kind = "enumeration"

    def __init__(self, attribute: str, counts: Optional[Dict[Any, int]] = None):
        self.attribute = attribute
        self.counts: Dict[Any, int] = dict(counts or {})

    def observe(self, columns, mask=None):
        vals = _masked(np.asarray(columns[self.attribute]), mask)
        uniq, cnt = np.unique(vals, return_counts=True)
        for u, c in zip(uniq.tolist(), cnt.tolist()):
            self.counts[u] = self.counts.get(u, 0) + int(c)

    def merge(self, other: "EnumerationStat"):
        for k, v in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    @property
    def is_empty(self):
        return not self.counts

    def value(self):
        return dict(self.counts)

    def _state(self):
        return {"attribute": self.attribute,
                "counts": [[k, v] for k, v in self.counts.items()]}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attribute"], {k: v for k, v in d["counts"]})


class TopK(Stat):
    """Top-k most frequent values (reference TopK via StreamSummary; here exact
    via enumeration — dictionary-coded columns keep this bounded)."""

    kind = "topk"

    def __init__(self, attribute: str, k: int = 10, counts: Optional[Dict[Any, int]] = None):
        self.attribute = attribute
        self.k = k
        self._enum = EnumerationStat(attribute, counts)

    def observe(self, columns, mask=None):
        self._enum.observe(columns, mask)

    def merge(self, other: "TopK"):
        self._enum.merge(other._enum)

    @property
    def is_empty(self):
        return self._enum.is_empty

    def value(self):
        items = sorted(self._enum.counts.items(), key=lambda kv: (-kv[1], str(kv[0])))
        return items[: self.k]

    def _state(self):
        return {"attribute": self.attribute, "k": self.k,
                "counts": [[k, v] for k, v in self._enum.counts.items()]}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attribute"], d["k"], {k: v for k, v in d["counts"]})


class Histogram(Stat):
    """Fixed-bin histogram over [lo, hi] (reference Histogram.scala: binned,
    with endpoints). Out-of-range values clamp to the edge bins, matching the
    reference's behavior of widening only on explicit re-bin."""

    kind = "histogram"

    def __init__(self, attribute: str, bins: int, lo: float, hi: float,
                 counts: Optional[np.ndarray] = None):
        self.attribute = attribute
        self.bins = int(bins)
        self.lo = float(lo)
        self.hi = float(hi)
        self.counts = (
            np.zeros(self.bins, dtype=np.int64) if counts is None
            else np.asarray(counts, dtype=np.int64)
        )

    def bin_of(self, vals: np.ndarray) -> np.ndarray:
        scaled = (np.asarray(vals, np.float64) - self.lo) / (self.hi - self.lo) * self.bins
        return np.clip(np.floor(scaled), 0, self.bins - 1).astype(np.int64)

    def observe(self, columns, mask=None):
        vals = _masked(np.asarray(columns[self.attribute]), mask)
        if vals.size == 0:
            return
        self.counts += np.bincount(self.bin_of(vals), minlength=self.bins).astype(np.int64)

    def merge(self, other: "Histogram"):
        self.counts += other.counts

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    def value(self):
        return {"lo": self.lo, "hi": self.hi, "counts": self.counts.tolist()}

    def _state(self):
        return {"attribute": self.attribute, "bins": self.bins, "lo": self.lo,
                "hi": self.hi, "counts": _arr_to_b64(self.counts)}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attribute"], d["bins"], d["lo"], d["hi"], _arr_from_b64(d["counts"]))


class Frequency(Stat):
    """Count-min sketch (reference Frequency.scala, 308 LoC). State is a
    (depth, width) int64 grid — a pure scatter-add on device."""

    kind = "frequency"
    DEPTH = 4
    # multiplicative hashing constants (odd, 64-bit): h_i(x) = (a_i*x) >> s mod width
    _AS = np.array(
        [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x27D4EB2F165667C5],
        dtype=np.uint64,
    )

    def __init__(self, attribute: str, width: int = 1024,
                 counts: Optional[np.ndarray] = None):
        self.attribute = attribute
        self.width = int(width)
        self.counts = (
            np.zeros((self.DEPTH, self.width), dtype=np.int64) if counts is None
            else np.asarray(counts, dtype=np.int64)
        )

    def _hash(self, vals: np.ndarray) -> np.ndarray:
        """(depth, n) bucket ids."""
        x = np.asarray(vals)
        if x.dtype.kind == "f":
            x = x.view(np.uint64) if x.dtype == np.float64 else x.astype(np.float64).view(np.uint64)
        else:
            x = x.astype(np.int64).view(np.uint64)
        h = (self._AS[:, None] * x[None, :])  # wraps mod 2^64
        return ((h >> np.uint64(33)) % np.uint64(self.width)).astype(np.int64)

    def observe(self, columns, mask=None):
        vals = _masked(np.asarray(columns[self.attribute]), mask)
        if vals.size == 0:
            return
        buckets = self._hash(vals)
        for d in range(self.DEPTH):
            self.counts[d] += np.bincount(buckets[d], minlength=self.width).astype(np.int64)

    def count(self, value) -> int:
        b = self._hash(np.asarray([value]))
        return int(min(self.counts[d, b[d, 0]] for d in range(self.DEPTH)))

    def merge(self, other: "Frequency"):
        self.counts += other.counts

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    def value(self):
        return {"width": self.width, "total": int(self.counts[0].sum())}

    def _state(self):
        return {"attribute": self.attribute, "width": self.width,
                "counts": _arr_to_b64(self.counts)}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attribute"], d["width"], _arr_from_b64(d["counts"]))


class DescriptiveStats(Stat):
    """Running count/sum/sum-of-outer-products for mean/variance/covariance
    (reference DescriptiveStats). Merge is exact (sums are associative)."""

    kind = "descriptive"

    def __init__(self, attributes: List[str], count: int = 0,
                 s1: Optional[np.ndarray] = None, s2: Optional[np.ndarray] = None):
        self.attributes = list(attributes)
        d = len(self.attributes)
        self.count = int(count)
        self.s1 = np.zeros(d) if s1 is None else np.asarray(s1, np.float64)
        self.s2 = np.zeros((d, d)) if s2 is None else np.asarray(s2, np.float64)

    def observe(self, columns, mask=None):
        mat = np.stack(
            [_masked(np.asarray(columns[a], np.float64), mask) for a in self.attributes],
            axis=1,
        )
        if mat.shape[0] == 0:
            return
        self.count += mat.shape[0]
        self.s1 += mat.sum(axis=0)
        self.s2 += mat.T @ mat

    def merge(self, other: "DescriptiveStats"):
        self.count += other.count
        self.s1 += other.s1
        self.s2 += other.s2

    @property
    def is_empty(self):
        return self.count == 0

    def value(self):
        if self.count == 0:
            return {"count": 0}
        mean = self.s1 / self.count
        cov = self.s2 / self.count - np.outer(mean, mean)
        return {
            "count": self.count,
            "mean": mean.tolist(),
            "variance": np.diag(cov).tolist(),
            "stddev": np.sqrt(np.maximum(np.diag(cov), 0)).tolist(),
            "covariance": cov.tolist(),
        }

    def _state(self):
        return {"attributes": self.attributes, "count": self.count,
                "s1": _arr_to_b64(self.s1), "s2": _arr_to_b64(self.s2)}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attributes"], d["count"], _arr_from_b64(d["s1"]), _arr_from_b64(d["s2"]))


class GroupBy(Stat):
    """Per-group sub-sketches keyed by an attribute's values (reference GroupBy)."""

    kind = "groupby"

    def __init__(self, attribute: str, substat_spec: str,
                 groups: Optional[Dict[Any, Stat]] = None):
        from geomesa_tpu_torch.stats.parser import parse_stat

        self.attribute = attribute
        self.substat_spec = substat_spec
        self._parse = parse_stat
        self.groups: Dict[Any, Stat] = dict(groups or {})

    def observe(self, columns, mask=None):
        keys = np.asarray(columns[self.attribute])
        if mask is not None:
            base = mask
        else:
            base = np.ones(len(keys), dtype=bool)
        for k in np.unique(keys[base]).tolist():
            gmask = base & (keys == k)
            if k not in self.groups:
                self.groups[k] = self._parse(self.substat_spec)
            self.groups[k].observe(columns, gmask)

    def merge(self, other: "GroupBy"):
        for k, v in other.groups.items():
            if k in self.groups:
                self.groups[k].merge(v)
            else:
                self.groups[k] = v

    @property
    def is_empty(self):
        return not self.groups

    def value(self):
        return {k: v.value() for k, v in self.groups.items()}

    def _state(self):
        return {"attribute": self.attribute, "substat_spec": self.substat_spec,
                "groups": [[k, v.to_json()] for k, v in self.groups.items()]}

    @classmethod
    def _from_state(cls, d):
        return cls(d["attribute"], d["substat_spec"],
                   {k: Stat.from_json(v) for k, v in d["groups"]})


class Z3HistogramStat(Stat):
    """Spatio-temporal histogram keyed by (time bin, coarse z cell) — the
    planner's selectivity backbone (reference Z3Histogram.scala, 186 LoC).

    State per bin: counts over ``length`` buckets, where bucket = top bits of
    the Z3 value. Device-side this is a scatter-add; host keeps bins sparse.
    """

    kind = "z3histogram"

    def __init__(self, geom: str, dtg: str, period: "str | TimePeriod" = TimePeriod.WEEK,
                 length: int = 1024, bins: Optional[Dict[int, np.ndarray]] = None):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.length = int(length)
        self.sfc = Z3SFC(self.period)
        self.binned = BinnedTime(self.period)
        # z >> shift yields a bucket in [0, length)
        self.shift = 63 - int(np.log2(self.length))
        self.bins: Dict[int, np.ndarray] = {
            int(k): np.asarray(v, np.int64) for k, v in (bins or {}).items()
        }

    def observe(self, columns, mask=None):
        # reuse ingest-computed (bin, z3) keys — but only when the ingest
        # marker confirms they were built with THIS sketch's time period
        # (a DSL-requested sketch may use a different period than the schema)
        if (
            "__z3" in columns
            and columns.get("__z3_period") == self.period.value
        ):
            b = _masked(np.asarray(columns["__z3_bin"]), mask)
            z = _masked(np.asarray(columns["__z3"], np.uint64), mask)
        else:
            xs = _masked(np.asarray(columns[self.geom + "__x"]), mask)
            ys = _masked(np.asarray(columns[self.geom + "__y"]), mask)
            ts = _masked(np.asarray(columns[self.dtg]), mask)  # epoch ms
            if xs.size == 0:
                return
            b, off = self.binned.to_bin_and_offset(ts)
            z = self.sfc.index(xs, ys, off)
        if z.size == 0:
            return
        bucket = (z >> np.uint64(self.shift)).astype(np.int32)
        # one composite bincount over (bin, bucket) — per-bin masked
        # bincounts re-scan the whole batch once per distinct bin. Bin ids
        # are dense small ints, so min/max beats a full np.unique sort.
        bmin, bmax = int(b.min()), int(b.max())
        if bmin == bmax:
            if bmin not in self.bins:
                self.bins[bmin] = np.zeros(self.length, dtype=np.int64)
            self.bins[bmin] += np.bincount(bucket, minlength=self.length)
            return
        span = bmax - bmin + 1
        # dense layout allocates span*length counters: bound the PRODUCT
        # (a DSL-requested big length with a wide bin span would otherwise
        # demand GBs where the sparse loop needs length*distinct_bins)
        if span * self.length > (1 << 22):
            for bb in np.unique(b).tolist():
                sel = np.asarray(b) == bb
                if bb not in self.bins:
                    self.bins[bb] = np.zeros(self.length, dtype=np.int64)
                self.bins[bb] += np.bincount(bucket[sel], minlength=self.length)
            return
        # int64 rel: span*length stays < 2^22 but the MULTIPLY inputs are
        # per-row values — int64 keeps the composite index overflow-free
        rel = (np.asarray(b, np.int64) - bmin) * np.int64(self.length) + bucket
        counts = np.bincount(rel, minlength=span * self.length).reshape(
            span, self.length
        )
        nonzero = counts.any(axis=1)
        for i in np.nonzero(nonzero)[0].tolist():
            bb = bmin + i
            if bb not in self.bins:
                self.bins[bb] = counts[i].astype(np.int64)
            else:
                self.bins[bb] += counts[i]

    def merge(self, other: "Z3HistogramStat"):
        for k, v in other.bins.items():
            if k in self.bins:
                self.bins[k] += v
            else:
                self.bins[k] = v.copy()

    @property
    def is_empty(self):
        return not self.bins

    def value(self):
        return {int(k): int(v.sum()) for k, v in self.bins.items()}

    def estimate_count(self, time_bins: np.ndarray, zranges) -> float:
        """Estimated matches for z-ranges within the given time bins — drives
        the cost-based strategy decider (StatsBasedEstimator analog)."""
        total = 0.0
        for bb in np.asarray(time_bins).tolist():
            counts = self.bins.get(int(bb))
            if counts is not None:
                total += _range_estimate(counts, self.shift, zranges)
        return total

    def _state(self):
        return {"geom": self.geom, "dtg": self.dtg, "period": self.period.value,
                "length": self.length,
                "bins": [[k, _arr_to_b64(v)] for k, v in self.bins.items()]}

    @classmethod
    def _from_state(cls, d):
        return cls(d["geom"], d["dtg"], d["period"], d["length"],
                   {k: _arr_from_b64(v) for k, v in d["bins"]})


class Z2HistogramStat(Stat):
    """Spatial histogram over coarse z2 cells — the z2 index's selectivity
    estimator (pairs with Z3HistogramStat so the cost decider compares both
    spatial indexes on the same data distribution)."""

    kind = "z2histogram"

    def __init__(self, geom: str, length: int = 1024, counts: Optional[np.ndarray] = None):
        self.geom = geom
        self.length = int(length)
        self.sfc = Z2SFC()
        self.shift = 62 - int(np.log2(self.length))
        self.counts = (
            np.zeros(self.length, dtype=np.int64) if counts is None
            else np.asarray(counts, np.int64)
        )

    def observe(self, columns, mask=None):
        if "__z2" in columns:  # ingest already computed the key column
            z = _masked(np.asarray(columns["__z2"], np.uint64), mask)
        else:
            xs = _masked(np.asarray(columns[self.geom + "__x"]), mask)
            ys = _masked(np.asarray(columns[self.geom + "__y"]), mask)
            if xs.size == 0:
                return
            z = self.sfc.index(xs, ys)
        if z.size == 0:
            return
        bucket = (z >> np.uint64(self.shift)).astype(np.int32)
        self.counts += np.bincount(bucket, minlength=self.length)

    def merge(self, other: "Z2HistogramStat"):
        self.counts += other.counts

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    def value(self):
        return {"total": int(self.counts.sum()), "length": self.length}

    def estimate_count(self, zranges) -> float:
        return _range_estimate(self.counts, self.shift, zranges)

    def _state(self):
        return {"geom": self.geom, "length": self.length,
                "counts": _arr_to_b64(self.counts)}

    @classmethod
    def _from_state(cls, d):
        return cls(d["geom"], d["length"], _arr_from_b64(d["counts"]))


class SeqStat(Stat):
    """Multiple sketches observed together ('Stat1;Stat2' in the DSL)."""

    kind = "seq"

    def __init__(self, stats: List[Stat]):
        self.stats = stats

    def observe(self, columns, mask=None):
        for s in self.stats:
            s.observe(columns, mask)

    def merge(self, other: "SeqStat"):
        for a, b in zip(self.stats, other.stats):
            a.merge(b)

    @property
    def is_empty(self):
        return all(s.is_empty for s in self.stats)

    def value(self):
        return [s.value() for s in self.stats]

    def _state(self):
        return {"stats": [s.to_json() for s in self.stats]}

    @classmethod
    def _from_state(cls, d):
        return cls([Stat.from_json(s) for s in d["stats"]])


class Z3FrequencyStat(Stat):
    """Count-min sketch keyed by (time bin, coarse z3 cell) — approximate
    per-cell frequencies for spatio-temporal values (reference Z3Frequency,
    geomesa-utils/.../stats/Z3Frequency.scala): per time bin, a Frequency
    sketch over the truncated z value."""

    kind = "z3frequency"

    def __init__(self, geom: str, dtg: str, period: "str | TimePeriod" = TimePeriod.WEEK,
                 precision: int = 10, width: int = 1024,
                 bins: "Optional[Dict[int, Frequency]]" = None):
        self.geom = geom
        self.dtg = dtg
        self.period = TimePeriod.parse(period)
        self.precision = int(precision)  # bits of z kept (top 3*precision)
        if not 1 <= self.precision <= 21:
            raise ValueError(
                f"Z3Frequency precision must be in [1, 21], got {self.precision}"
            )
        self.width = int(width)
        self.sfc = Z3SFC(self.period)
        self.binned = BinnedTime(self.period)
        self.shift = 63 - 3 * self.precision
        self.bins: Dict[int, Frequency] = dict(bins or {})

    def _key(self, xs, ys, off) -> np.ndarray:
        z = self.sfc.index(xs, ys, off)
        return (z >> np.uint64(self.shift)).astype(np.int64)

    def observe(self, columns, mask=None):
        xs = _masked(np.asarray(columns[self.geom + "__x"]), mask)
        ys = _masked(np.asarray(columns[self.geom + "__y"]), mask)
        ts = _masked(np.asarray(columns[self.dtg]), mask)
        if xs.size == 0:
            return
        b, off = self.binned.to_bin_and_offset(ts)
        keys = self._key(xs, ys, off)
        for bb in np.unique(b).tolist():
            sel = b == bb
            fq = self.bins.get(int(bb))
            if fq is None:
                fq = self.bins[int(bb)] = Frequency("__z3__", width=self.width)
            fq.observe({"__z3__": keys[sel]})

    def merge(self, other: "Z3FrequencyStat"):
        if (
            self.period != other.period
            or self.precision != other.precision
            or self.width != other.width
        ):
            raise ValueError(
                "cannot merge Z3Frequency sketches with different "
                f"period/precision/width: {self.period.value}/{self.precision}"
                f"/{self.width} vs {other.period.value}/{other.precision}"
                f"/{other.width}"
            )
        for k, v in other.bins.items():
            if k in self.bins:
                self.bins[k].merge(v)
            else:
                self.bins[k] = Frequency(
                    "__z3__", width=v.width, counts=v.counts.copy()
                )

    @property
    def is_empty(self):
        return not self.bins

    def count(self, time_bin: int, x: float, y: float, offset_ms: float) -> int:
        """Approximate (over-)count of points in the cell containing
        (x, y, offset) within the given time bin."""
        fq = self.bins.get(int(time_bin))
        if fq is None:
            return 0
        key = self._key(
            np.asarray([x]), np.asarray([y]), np.asarray([offset_ms])
        )
        return fq.count(int(key[0]))

    def value(self):
        return {int(k): int(v.counts[0].sum()) for k, v in self.bins.items()}

    def _state(self):
        return {
            "geom": self.geom, "dtg": self.dtg, "period": self.period.value,
            "precision": self.precision, "width": self.width,
            "bins": {str(k): _arr_to_b64(v.counts) for k, v in self.bins.items()},
        }

    @classmethod
    def _from_state(cls, d):
        out = cls(d["geom"], d["dtg"], d["period"], d["precision"], d["width"])
        for k, v in d["bins"].items():
            fq = Frequency("__z3__", width=out.width)
            fq.counts = _arr_from_b64(v).reshape(fq.counts.shape)
            out.bins[int(k)] = fq
        return out


_KINDS = {
    c.kind: c
    for c in (
        CountStat, MinMax, EnumerationStat, TopK, Histogram, Frequency,
        DescriptiveStats, GroupBy, Z3HistogramStat, Z2HistogramStat,
        Z3FrequencyStat, SeqStat,
    )
}
