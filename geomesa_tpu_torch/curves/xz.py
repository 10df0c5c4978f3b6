"""XZ-ordering curves for geometries with extent (polygons, lines).

Copy of ``geomesa_tpu/curves/xz.py``. Capability parity with the reference's XZ2SFC (geomesa-z3/.../XZ2SFC.scala:25)
and XZ3SFC (XZ3SFC.scala:26), which implement Böhm's XZ-ordering: an element is
stored at the quadtree/octree node whose cell contains the element's min corner
and whose *enlarged* (doubled-extent) cell contains the whole element. Node ids
are a preorder (DFS) numbering, so a subtree is one contiguous id range.

Everything here is host-side: `index()` is vectorized numpy over ingest
batches; `ranges()` is per-query plan-time traversal.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from geomesa_tpu_torch.curves.binned_time import BinnedTime, TimePeriod
from geomesa_tpu_torch.curves.cover import ZRange, _merge


class _XZBase:
    """Shared machinery for d-dimensional XZ ordering with resolution g."""

    def __init__(self, dims: int, g: int, los, his):
        self.d = dims
        self.g = g
        self.los = np.asarray(los, dtype=np.float64)
        self.his = np.asarray(his, dtype=np.float64)
        self.fan = 1 << dims  # children per node
        # subtree_size[depth] = node count of a subtree rooted at that depth
        # (inclusive), depth 0 = root. s(g) = 1; s(k) = 1 + fan*s(k+1).
        sizes = [0] * (g + 2)
        sizes[g] = 1
        for k in range(g - 1, -1, -1):
            sizes[k] = 1 + self.fan * sizes[k + 1]
        sizes[g + 1] = 0
        self.subtree_size = sizes

    # -- normalization ----------------------------------------------------
    def _norm(self, vals, k: int) -> np.ndarray:
        """Dim k float -> integer grid coordinate at resolution 2^g."""
        v = np.asarray(vals, dtype=np.float64)
        scaled = (v - self.los[k]) / (self.his[k] - self.los[k]) * (1 << self.g)
        return np.clip(np.floor(scaled), 0, (1 << self.g) - 1).astype(np.int64)

    def _norm_f(self, vals, k: int) -> np.ndarray:
        """Dim k float -> continuous [0, 2^g] grid coordinate (for fit tests)."""
        v = np.asarray(vals, dtype=np.float64)
        scaled = (v - self.los[k]) / (self.his[k] - self.los[k]) * (1 << self.g)
        return np.clip(scaled, 0.0, float(1 << self.g))

    # -- encode -----------------------------------------------------------
    def index_boxes(self, mins: List[np.ndarray], maxs: List[np.ndarray]) -> np.ndarray:
        """Vectorized: per-element bounding boxes -> XZ sequence codes (int64).

        ``mins[k]``/``maxs[k]`` are arrays of the k-th dim's bounds.
        """
        n = np.asarray(mins[0]).shape[0]
        fmins = [self._norm_f(mins[k], k) for k in range(self.d)]
        fmaxs = [self._norm_f(maxs[k], k) for k in range(self.d)]
        # Element's grid extent (in cells of size 1 at finest resolution 2^g).
        w = np.zeros(n, dtype=np.float64)
        for k in range(self.d):
            w = np.maximum(w, fmaxs[k] - fmins[k])
        # Deepest level whose cell side (2^(g-l) at finest units) >= ... an
        # element of extent w fits an enlarged cell at level l iff the doubled
        # cell (side 2*2^(g-l)) can contain it given the min corner lies in the
        # cell: sufficient & necessary check below mirrors XZ2SFC.scala:25ff.
        with np.errstate(divide="ignore"):
            l_guess = np.floor(-np.log2(np.maximum(w, 1e-300) / (1 << self.g))).astype(np.int64)
        l_guess = np.clip(l_guess, 0, self.g)
        # Verify fit at l_guess: the min corner's cell at level l must, when
        # doubled, contain the max corner; else back off one level.
        lvl = l_guess
        for _ in range(2):  # at most one back-off needed; loop twice for safety
            side = (1 << self.g) / (2.0 ** lvl)  # cell side in finest units
            fits = np.ones(n, dtype=bool)
            for k in range(self.d):
                cell_lo = np.floor(fmins[k] / side) * side
                fits &= fmaxs[k] <= cell_lo + 2 * side
            lvl = np.where(fits, lvl, np.maximum(lvl - 1, 0))
        # Sequence code: walk the tree to depth lvl following the min corner.
        imins = [np.minimum(np.floor(fmins[k]).astype(np.int64), (1 << self.g) - 1)
                 for k in range(self.d)]
        code = np.zeros(n, dtype=np.int64)
        for level in range(self.g):
            active = level < lvl
            bit_pos = self.g - 1 - level
            child = np.zeros(n, dtype=np.int64)
            for k in range(self.d):
                child = (child << 1) | ((imins[k] >> bit_pos) & 1)
            step = 1 + child * self.subtree_size[level + 1]
            code = np.where(active, code + step, code)
        return code

    # -- query ------------------------------------------------------------
    def ranges_box(self, qlo, qhi, max_ranges: int = 2000) -> List[ZRange]:
        """Sequence-code ranges of nodes whose elements may intersect [qlo,qhi].

        Emits whole-subtree ranges where every element in the subtree is
        guaranteed to intersect the query, and singleton ranges for boundary
        nodes (resolved by the downstream fine filter) — the same contract as
        XZ2SFC.ranges in the reference.
        """
        qlo = [self._norm_f([qlo[k]], k)[0] for k in range(self.d)]
        qhi = [self._norm_f([qhi[k]], k)[0] for k in range(self.d)]
        out: List[ZRange] = []
        # node: (code, depth, cell mins in finest units)
        frontier = deque([(0, 0, tuple([0.0] * self.d))])
        while frontier:
            code, depth, mins = frontier.popleft()
            side = (1 << self.g) / (2.0 ** depth)
            # Enlarged cell = doubled extent.
            if any(mins[k] > qhi[k] or mins[k] + 2 * side < qlo[k] for k in range(self.d)):
                continue  # no element in this subtree can touch the query
            if all(qlo[k] <= mins[k] and mins[k] + 2 * side <= qhi[k] for k in range(self.d)):
                # Every element in the subtree lies inside the query.
                out.append(ZRange(code, code + self.subtree_size[depth] - 1))
                continue
            out.append(ZRange(code, code))  # elements AT this node: maybe
            if depth == self.g:
                continue
            if len(out) + len(frontier) + self.fan > max_ranges:
                # Budget: over-cover remaining subtrees whole.
                out.append(ZRange(code, code + self.subtree_size[depth] - 1))
                while frontier:
                    c2, d2, m2 = frontier.popleft()
                    s2 = (1 << self.g) / (2.0 ** d2)
                    if any(m2[k] > qhi[k] or m2[k] + 2 * s2 < qlo[k] for k in range(self.d)):
                        continue
                    out.append(ZRange(c2, c2 + self.subtree_size[d2] - 1))
                break
            half = side / 2.0
            for combo in range(self.fan):
                c_mins = []
                for k in range(self.d):
                    bit = (combo >> (self.d - 1 - k)) & 1
                    c_mins.append(mins[k] + bit * half)
                frontier.append(
                    (code + 1 + combo * self.subtree_size[depth + 1], depth + 1, tuple(c_mins))
                )
        return _merge(out)


class XZ2SFC(_XZBase):
    """XZ ordering over (lon, lat) bounding boxes. Reference: XZ2SFC.scala:25."""

    def __init__(self, g: int = 12):
        super().__init__(dims=2, g=g, los=[-180.0, -90.0], his=[180.0, 90.0])

    def index(self, xmin, ymin, xmax, ymax) -> np.ndarray:
        return self.index_boxes([xmin, ymin], [xmax, ymax])

    def ranges(self, xmin: float, ymin: float, xmax: float, ymax: float,
               max_ranges: int = 2000) -> List[ZRange]:
        return self.ranges_box([xmin, ymin], [xmax, ymax], max_ranges)


class XZ3SFC(_XZBase):
    """XZ ordering over (lon, lat, binned-time-offset). Reference: XZ3SFC.scala:26.

    Like Z3, keys are per time-bin: the offset dimension spans one period.
    """

    def __init__(self, period: "str | TimePeriod" = TimePeriod.WEEK, g: int = 12):
        self.binned = BinnedTime(period)
        super().__init__(
            dims=3, g=g,
            los=[-180.0, -90.0, 0.0],
            his=[180.0, 90.0, float(self.binned.max_offset_ms)],
        )

    def index(self, xmin, ymin, tmin_off, xmax, ymax, tmax_off) -> np.ndarray:
        return self.index_boxes([xmin, ymin, tmin_off], [xmax, ymax, tmax_off])

    def ranges(self, xbounds, ybounds, tbounds_off, max_ranges: int = 2000) -> List[ZRange]:
        return self.ranges_box(
            [xbounds[0], ybounds[0], tbounds_off[0]],
            [xbounds[1], ybounds[1], tbounds_off[1]],
            max_ranges,
        )
