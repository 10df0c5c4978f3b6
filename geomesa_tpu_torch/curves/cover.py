"""Z-range cover: decompose an axis-aligned query box into Morton-order ranges.

Copy of the Python cover in ``geomesa_tpu/curves/cover.py`` (the native C++
cover is left out; both give the same ranges). BFS over z-prefix cells: cells
fully inside the box emit their whole block, intersecting cells subdivide
until ``max_ranges`` would be exceeded, and the remaining frontier is then
emitted whole (an over-cover; the fine mask restores exactness).
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Sequence


class ZRange(NamedTuple):
    lo: int  # inclusive
    hi: int  # inclusive


def _merge(ranges: List[ZRange]) -> List[ZRange]:
    if not ranges:
        return []
    ranges.sort()
    out = [ranges[0]]
    for r in ranges[1:]:
        last = out[-1]
        if r.lo <= last.hi + 1:
            if r.hi > last.hi:
                out[-1] = ZRange(last.lo, r.hi)
        else:
            out.append(r)
    return out


def zcover(
    lo: Sequence[int],
    hi: Sequence[int],
    bits: int,
    dims: int,
    max_ranges: int = 2000,
) -> List[ZRange]:
    """Cover the integer box [lo, hi] (inclusive, per dim) with merged,
    sorted, inclusive z-value ranges."""
    d = dims
    qlo = [int(v) for v in lo]
    qhi = [int(v) for v in hi]
    for k in range(d):
        if qlo[k] > qhi[k]:
            raise ValueError(f"inverted query box on dim {k}: {qlo[k]} > {qhi[k]}")

    # frontier entries: (zmin, level, mins, maxs)
    full = (1 << bits) - 1
    frontier = deque([(0, 0, tuple([0] * d), tuple([full] * d))])
    out: List[ZRange] = []

    def cell_span(level: int) -> int:
        return (1 << (d * (bits - level))) - 1

    while frontier:
        zmin, level, mins, maxs = frontier.popleft()
        if any(maxs[k] < qlo[k] or mins[k] > qhi[k] for k in range(d)):
            continue
        if all(qlo[k] <= mins[k] and maxs[k] <= qhi[k] for k in range(d)):
            out.append(ZRange(zmin, zmin + cell_span(level)))
            continue
        if level == bits:
            out.append(ZRange(zmin, zmin))
            continue
        # budget: if splitting would exceed it, emit the frontier whole
        if len(out) + len(frontier) + (1 << d) > max_ranges:
            out.append(ZRange(zmin, zmin + cell_span(level)))
            while frontier:
                zm, lv, mn, mx = frontier.popleft()
                if any(mx[k] < qlo[k] or mn[k] > qhi[k] for k in range(d)):
                    continue
                out.append(ZRange(zm, zm + cell_span(lv)))
            break
        # subdivide: fix the next bit (b = bits-1-level) of each dim
        b = bits - 1 - level
        half = 1 << b
        group_shift = d * b
        for combo in range(1 << d):
            c_mins, c_maxs = [], []
            zadd = 0
            for k in range(d):
                bit = (combo >> (d - 1 - k)) & 1
                if bit:
                    c_mins.append(mins[k] + half)
                    c_maxs.append(maxs[k])
                    zadd |= 1 << (group_shift + (d - 1 - k))
                else:
                    c_mins.append(mins[k])
                    c_maxs.append(maxs[k] - half)
            frontier.append((zmin + zadd, level + 1, tuple(c_mins), tuple(c_maxs)))

    return _merge(out)
