"""Epoch time -> (bin, offset) decomposition.

NumPy copy of ``geomesa_tpu/curves/binned_time.py`` (the native C++ fast path
is left out): timestamps split into a period bin (day/week/month/year since
epoch) and a millisecond offset within the bin. The bin leads the Z3 sort
key; the offset is the curve's time dimension.
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np

DAY_MS = 86_400_000
WEEK_MS = 7 * DAY_MS
# fixed maxima so the curve's time dimension has a static extent
MONTH_MS = 31 * DAY_MS
YEAR_MS = 366 * DAY_MS


class TimePeriod(str, enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @staticmethod
    def parse(s: "str | TimePeriod") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return TimePeriod(str(s).strip().lower())


class BinnedTime:
    """Vectorized epoch-ms <-> (bin, offset-ms) codec for a time period."""

    def __init__(self, period: "str | TimePeriod" = TimePeriod.WEEK):
        self.period = TimePeriod.parse(period)

    @property
    def max_offset_ms(self) -> int:
        return {
            TimePeriod.DAY: DAY_MS,
            TimePeriod.WEEK: WEEK_MS,
            TimePeriod.MONTH: MONTH_MS,
            TimePeriod.YEAR: YEAR_MS,
        }[self.period]

    @property
    def off_scale(self) -> int:
        """Offset quantization (ms per unit) so a scaled offset fits int32.
        Day/week are exact (1 ms); month/year quantize to 4/16 ms."""
        return {
            TimePeriod.DAY: 1,
            TimePeriod.WEEK: 1,
            TimePeriod.MONTH: 4,
            TimePeriod.YEAR: 16,
        }[self.period]

    def to_scaled(self, epoch_ms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """epoch_ms -> (bin int32, scaled-offset int32) device columns."""
        b, off = self.to_bin_and_offset(epoch_ms)
        return b, (off // self.off_scale).astype(np.int32)

    def to_bin_and_offset(self, epoch_ms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """epoch_ms (int64) -> (bin int32, offset_ms int64)."""
        t = np.asarray(epoch_ms, dtype=np.int64)
        if self.period in (TimePeriod.DAY, TimePeriod.WEEK):
            P = DAY_MS if self.period == TimePeriod.DAY else WEEK_MS
            b = np.floor_divide(t, P)
            off = t - b * P
        elif self.period == TimePeriod.MONTH:
            dt = t.astype("datetime64[ms]")
            months = dt.astype("datetime64[M]")
            b = months.astype(np.int64)  # months since 1970-01
            off = (dt - months).astype("timedelta64[ms]").astype(np.int64)
        else:  # YEAR
            dt = t.astype("datetime64[ms]")
            years = dt.astype("datetime64[Y]")
            b = years.astype(np.int64)  # years since 1970
            off = (dt - years).astype("timedelta64[ms]").astype(np.int64)
        return b.astype(np.int32), off.astype(np.int64)

    def offset_from_bin(self, epoch_ms: np.ndarray, bins: np.ndarray) -> np.ndarray:
        """offset_ms given already-computed bins."""
        t = np.asarray(epoch_ms, dtype=np.int64)
        return t - self.bin_start_ms(bins)

    def bin_start_ms(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b)
        if self.period == TimePeriod.DAY:
            return b.astype(np.int64) * DAY_MS
        if self.period == TimePeriod.WEEK:
            return b.astype(np.int64) * WEEK_MS
        if self.period == TimePeriod.MONTH:
            return b.astype("datetime64[M]").astype("datetime64[ms]").astype(np.int64)
        return b.astype("datetime64[Y]").astype("datetime64[ms]").astype(np.int64)

    def bin_of(self, epoch_ms: int) -> int:
        b, _ = self.to_bin_and_offset(np.asarray([epoch_ms], dtype=np.int64))
        return int(b[0])

    def bins_between(self, lo_ms: int, hi_ms: int) -> np.ndarray:
        """All bins touched by [lo_ms, hi_ms] inclusive."""
        return np.arange(
            self.bin_of(int(lo_ms)), self.bin_of(int(hi_ms)) + 1, dtype=np.int32
        )
