"""Z-range cover: decompose an axis-aligned query box into Morton-order ranges.

The Python cover of ``geomesa_tpu/curves/cover.py`` (the native C++ cover
is left out; all give the same ranges), vectorized a BFS level at a time.
BFS over z-prefix cells: cells fully inside the box emit their whole block,
intersecting cells subdivide until ``max_ranges`` would be exceeded, and
the remaining frontier is then emitted whole (an over-cover; the fine mask
restores exactness).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np


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
    sorted, inclusive z-value ranges.

    The reference's BFS pops one cell at a time; this runs it a level at a
    time over arrays and gives the same ranges. Within a level, cell i
    sees ``len(out)`` = the ranges emitted before it and ``len(frontier)``
    = the cells after it in its level plus the children of the splits
    before it, so the first split that would exceed the budget is found by
    prefix sums; from there the reference emits every remaining frontier
    cell whole (the merge sorts, so the order of emission does not
    matter)."""
    d = dims
    qlo = np.array([int(v) for v in lo], np.int64)
    qhi = np.array([int(v) for v in hi], np.int64)
    for k in range(d):
        if qlo[k] > qhi[k]:
            raise ValueError(f"inverted query box on dim {k}: {qlo[k]} > {qhi[k]}")
    fan = 1 << d
    # bit k of a child's combo (most significant first) picks dim k's half
    combo_bits = (np.arange(fan)[:, None] >> (d - 1 - np.arange(d))[None, :]) & 1
    full = (1 << bits) - 1
    # while the box lies inside one cell, each level holds that cell and
    # its disjoint siblings, which emit nothing; with a budget of at least
    # 2^(d+1) no split there can exceed it, so the BFS may start at the
    # deepest such cell
    level = 0
    zmin0, cell_lo = 0, [0] * d
    if max_ranges >= 2 * fan:
        while level < bits:
            b = bits - 1 - level
            sides = [(int(qlo[k]) >> b) & 1 for k in range(d)]
            if any(((int(qhi[k]) >> b) & 1) != sides[k] for k in range(d)):
                break
            for k in range(d):
                zmin0 |= sides[k] << (d * b + d - 1 - k)
                cell_lo[k] |= sides[k] << b
            level += 1
    span0 = (1 << (bits - level)) - 1
    zmin = np.array([zmin0], np.int64)
    mins = np.array([cell_lo], np.int64)
    maxs = mins + span0
    out: List[np.ndarray] = []
    n_out = 0

    def disjoint(mn, mx):
        return ((mx < qlo) | (mn > qhi)).any(axis=1)

    def children(z, mn, mx, lvl):
        b = bits - 1 - lvl
        half = np.int64(1 << b)
        zadd = (combo_bits << (d * b + (d - 1 - np.arange(d)))[None, :]).sum(axis=1)
        cz = (z[:, None] + zadd[None, :].astype(np.int64)).reshape(-1)
        cmn = (mn[:, None, :] + combo_bits[None] * half).reshape(-1, d)
        cmx = (mx[:, None, :] - (1 - combo_bits[None]) * half).reshape(-1, d)
        return cz, cmn, cmx

    def emit(z, lvl):
        span = np.int64((1 << (d * (bits - lvl))) - 1)
        out.append(np.stack([z, z + span], axis=1))

    while len(zmin):
        L = len(zmin)
        dis = disjoint(mins, maxs)
        inside = ((qlo <= mins) & (maxs <= qhi)).all(axis=1) & ~dis
        done = inside | (~dis & (level == bits))
        split = ~dis & ~done
        idx = np.arange(L)
        before_done = np.cumsum(done) - done
        before_split = np.cumsum(split) - split
        over = split & (n_out + before_done + (L - idx - 1) + fan * before_split + fan
                        > max_ranges)
        if over.any():
            t = int(np.argmax(over))
            emit(zmin[(done & (idx < t)) | ((idx >= t) & ~dis)], level)
            sp = split & (idx < t)
            cz, cmn, cmx = children(zmin[sp], mins[sp], maxs[sp], level)
            emit(cz[~disjoint(cmn, cmx)], level + 1)
            break
        emit(zmin[done], level)
        n_out += int(done.sum())
        if not split.any():
            break
        zmin, mins, maxs = children(zmin[split], mins[split], maxs[split], level)
        level += 1

    r = np.concatenate(out)
    if not len(r):
        return []
    # _merge over arrays: sort, then a range starts a group unless it
    # touches the running end of the ranges before it
    r = r[np.lexsort((r[:, 1], r[:, 0]))]
    end = np.maximum.accumulate(r[:, 1])
    first = np.ones(len(r), bool)
    first[1:] = r[1:, 0] - 1 > end[:-1]
    starts = np.flatnonzero(first)
    ends = end[np.append(starts[1:] - 1, len(r) - 1)]
    return [ZRange(a, b) for a, b in zip(r[starts, 0].tolist(), ends.tolist())]
