"""Z-order (Morton) curves over (lon, lat) and (lon, lat, time offset),
NumPy only.

Copy of the host half of ``geomesa_tpu/curves/zorder.py``: fixed-point
dimension normalization, the uint64 bit spreads, and the Z2 (31 bits a
dimension) and Z3 (21 bits) curves with their z-range cover entry points.
The native C++ encode is left out; the NumPy path gives the same keys bit
for bit.

Bit layout: for d dimensions, bit ``i`` of dimension ``k`` (k=0 most
significant) lands at position ``d*i + (d-1-k)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from geomesa_tpu_torch.curves.binned_time import BinnedTime, TimePeriod
from geomesa_tpu_torch.curves.cover import ZRange, zcover


@dataclass(frozen=True)
class NormalizedDimension:
    lo: float
    hi: float
    bits: int

    @property
    def max_index(self) -> int:
        return (1 << self.bits) - 1

    def normalize(self, x: np.ndarray) -> np.ndarray:
        """float -> fixed-point index (clipped to the extent)."""
        x = np.asarray(x, dtype=np.float64)
        scaled = (x - self.lo) / (self.hi - self.lo) * (1 << self.bits)
        return np.clip(np.floor(scaled), 0, self.max_index).astype(np.uint64)


def _split2(x: np.ndarray) -> np.ndarray:
    """Spread the low 31 bits of x so bit i lands at position 2i (uint64)."""
    x = np.asarray(x, dtype=np.uint64) & np.uint64(0x7FFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _combine2(z: np.ndarray) -> np.ndarray:
    """Inverse of _split2: gather every 2nd bit (starting at 0) down."""
    z = np.asarray(z, dtype=np.uint64) & np.uint64(0x5555555555555555)
    z = (z | (z >> np.uint64(1))) & np.uint64(0x3333333333333333)
    z = (z | (z >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    z = (z | (z >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    z = (z | (z >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    z = (z | (z >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return z


def interleave2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Morton-interleave two 31-bit indices; x the higher bit of each pair."""
    return (_split2(x) << np.uint64(1)) | _split2(y)


def deinterleave2(z: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    z = np.asarray(z, np.uint64)
    return _combine2(z >> np.uint64(1)), _combine2(z)


def _split3(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so bit i lands at position 3i (uint64)."""
    x = np.asarray(x, dtype=np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _combine3(z: np.ndarray) -> np.ndarray:
    """Inverse of _split3: gather every 3rd bit (starting at 0) down."""
    z = np.asarray(z, dtype=np.uint64) & np.uint64(0x1249249249249249)
    z = (z | (z >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    z = (z | (z >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    z = (z | (z >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    z = (z | (z >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    z = (z | (z >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return z


def interleave3(x: np.ndarray, y: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Morton-interleave three 21-bit indices; x highest within each triple."""
    return (_split3(x) << np.uint64(2)) | (_split3(y) << np.uint64(1)) | _split3(t)


def deinterleave3(z: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    z = np.asarray(z, np.uint64)
    return (
        _combine3(z >> np.uint64(2)),
        _combine3(z >> np.uint64(1)),
        _combine3(z),
    )


class Z2SFC:
    """2D Z-order curve over (lon, lat), 31 bits per dimension."""

    BITS = 31

    def __init__(self):
        self.lon = NormalizedDimension(-180.0, 180.0, self.BITS)
        self.lat = NormalizedDimension(-90.0, 90.0, self.BITS)

    def index(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """(lon, lat) -> z (uint64)."""
        return interleave2(self.lon.normalize(x), self.lat.normalize(y))

    def ranges(self, xmin: float, ymin: float, xmax: float, ymax: float,
               max_ranges: int) -> List[ZRange]:
        """Cover the bbox with z-ranges (plan time)."""
        lo = (int(self.lon.normalize(xmin)), int(self.lat.normalize(ymin)))
        hi = (int(self.lon.normalize(xmax)), int(self.lat.normalize(ymax)))
        return zcover(lo, hi, bits=self.BITS, dims=2, max_ranges=max_ranges)


class Z3SFC:
    """3D Z-order curve over (lon, lat, time-offset-in-bin), 21 bits per dim."""

    BITS = 21

    def __init__(self, period: "str | TimePeriod" = TimePeriod.WEEK):
        self.binned = BinnedTime(period)
        self.lon = NormalizedDimension(-180.0, 180.0, self.BITS)
        self.lat = NormalizedDimension(-90.0, 90.0, self.BITS)
        self.time = NormalizedDimension(0.0, float(self.binned.max_offset_ms), self.BITS)

    def index(self, x: np.ndarray, y: np.ndarray, t_offset_ms: np.ndarray) -> np.ndarray:
        """(lon, lat, offset-ms-within-bin) -> z (uint64)."""
        return interleave3(
            self.lon.normalize(x), self.lat.normalize(y), self.time.normalize(t_offset_ms)
        )

    def ranges(
        self,
        xbounds: Tuple[float, float],
        ybounds: Tuple[float, float],
        tbounds_ms: Tuple[float, float],
        max_ranges: int,
    ) -> List[ZRange]:
        """Cover (bbox x time-offset window) with z-ranges (plan time)."""
        lo = (
            int(self.lon.normalize(xbounds[0])),
            int(self.lat.normalize(ybounds[0])),
            int(self.time.normalize(tbounds_ms[0])),
        )
        hi = (
            int(self.lon.normalize(xbounds[1])),
            int(self.lat.normalize(ybounds[1])),
            int(self.time.normalize(tbounds_ms[1])),
        )
        return zcover(lo, hi, bits=self.BITS, dims=3, max_ranges=max_ranges)
