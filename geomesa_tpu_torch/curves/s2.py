"""S2 cell curve: a Hilbert curve on the 6 faces of a cube projected onto
the sphere.

Copy of ``geomesa_tpu/curves/s2.py`` (the reference's S2SFC, which wraps
Google S2's S2CellId / S2RegionCoverer), whole: the cell math as vectorized
NumPy, so ids and covers are bit-identical to the JAX package's. One
addition: :func:`cell_corners` is memoized per cell id, since a cover asks
for the corners of every candidate cell and one cell's corners cost a
30-level Hilbert decode (about 90% of a cover's time; neighbouring and
repeated query boxes share most of their cells).

Cell id layout (Google S2-compatible): 3 face bits, 60 Hilbert position
bits, one trailing marker bit; a level-L cell's id has its marker at bit
2*(30-L), and leaf cells (level 30) are odd. Tokens are the id's hex with
trailing zeros stripped. The quadratic ST projection and the canonical
Hilbert orientation tables follow the published S2 geometry definition.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.cover import ZRange, _merge

MAX_LEVEL = 30
POS_BITS = 2 * MAX_LEVEL + 1  # 61

# canonical Hilbert tables: traversal order per orientation
# orientation bits: 1 = swap i/j, 2 = invert
_POS_TO_IJ = np.array(
    [[0, 1, 3, 2], [0, 2, 3, 1], [3, 2, 0, 1], [3, 1, 0, 2]], np.int64
)
_IJ_TO_POS = np.array(
    [[0, 1, 3, 2], [0, 3, 1, 2], [2, 3, 1, 0], [2, 1, 3, 0]], np.int64
)
_POS_TO_ORI = np.array([1, 0, 0, 3], np.int64)  # swap, 0, 0, invert|swap


# -- projections ------------------------------------------------------------

def _lnglat_to_xyz(x, y):
    lam = np.radians(np.asarray(x, np.float64))
    phi = np.radians(np.asarray(y, np.float64))
    cphi = np.cos(phi)
    return cphi * np.cos(lam), cphi * np.sin(lam), np.sin(phi)


def _xyz_to_face_uv(px, py, pz):
    comps = np.stack([px, py, pz])
    f = np.argmax(np.abs(comps), axis=0)
    major = np.take_along_axis(comps, f[None], axis=0)[0]
    face = f + np.where(major < 0, 3, 0)
    # per-face (u, v) = ratios of the two minor axes over the major axis
    # (np.select evaluates all branches; zero divisors only occur in the
    # branches that are not selected)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.select(
            [face == 0, face == 1, face == 2, face == 3, face == 4, face == 5],
            [py / px, -px / py, -px / pz, pz / px, pz / py, -py / pz],
        )
        v = np.select(
            [face == 0, face == 1, face == 2, face == 3, face == 4, face == 5],
            [pz / px, pz / py, -py / pz, py / px, -px / py, -px / pz],
        )
    return face.astype(np.int64), u, v


def _face_uv_to_xyz(face: int, u, v):
    if face == 0:
        return np.ones_like(u), u, v
    if face == 1:
        return -u, np.ones_like(u), v
    if face == 2:
        return -u, -v, np.ones_like(u)
    if face == 3:
        return -np.ones_like(u), -v, -u
    if face == 4:
        return v, -np.ones_like(u), -u
    return v, u, -np.ones_like(u)


def _uv_to_st(u):
    with np.errstate(invalid="ignore"):
        return np.where(
            u >= 0, 0.5 * np.sqrt(1 + 3 * u), 1 - 0.5 * np.sqrt(1 - 3 * u)
        )


def _st_to_uv(s):
    s = np.asarray(s, np.float64)
    return np.where(
        s >= 0.5, (1.0 / 3.0) * (4 * s * s - 1), (1.0 / 3.0) * (1 - 4 * (1 - s) ** 2)
    )


def _st_to_ij(s):
    return np.clip(
        (np.asarray(s, np.float64) * (1 << MAX_LEVEL)).astype(np.int64),
        0, (1 << MAX_LEVEL) - 1,
    )


# -- Hilbert encode/decode ---------------------------------------------------

def face_ij_to_id(face, i, j) -> np.ndarray:
    """(face, i, j) at leaf level -> uint64 cell id, vectorized."""
    face = np.asarray(face, np.int64)
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    pos = np.zeros(face.shape, np.uint64)
    ori = face & 1  # initial orientation carries the face's swap bit
    for k in range(MAX_LEVEL - 1, -1, -1):
        ij = 2 * ((i >> k) & 1) + ((j >> k) & 1)
        p = _IJ_TO_POS[ori, ij]
        pos = (pos << np.uint64(2)) | p.astype(np.uint64)
        ori = ori ^ _POS_TO_ORI[p]
    return (
        (face.astype(np.uint64) << np.uint64(POS_BITS))
        | (pos << np.uint64(1))
        | np.uint64(1)
    )


def id_to_face_ij(ids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint64 leaf cell ids -> (face, i, j), vectorized."""
    ids = np.asarray(ids, np.uint64)
    face = (ids >> np.uint64(POS_BITS)).astype(np.int64)
    pos = (ids >> np.uint64(1)) & np.uint64((1 << (2 * MAX_LEVEL)) - 1)
    i = np.zeros(ids.shape, np.int64)
    j = np.zeros(ids.shape, np.int64)
    ori = face & 1
    for k in range(MAX_LEVEL - 1, -1, -1):
        p = ((pos >> np.uint64(2 * k)) & np.uint64(3)).astype(np.int64)
        ij = _POS_TO_IJ[ori, p]
        i = (i << 1) | (ij >> 1)
        j = (j << 1) | (ij & 1)
        ori = ori ^ _POS_TO_ORI[p]
    return face, i, j


def lnglat_to_id(x, y) -> np.ndarray:
    """(lon, lat) degrees -> uint64 leaf cell ids (level 30), vectorized."""
    px, py, pz = _lnglat_to_xyz(np.atleast_1d(x), np.atleast_1d(y))
    face, u, v = _xyz_to_face_uv(px, py, pz)
    return face_ij_to_id(face, _st_to_ij(_uv_to_st(u)), _st_to_ij(_uv_to_st(v)))


def id_to_lnglat(ids) -> Tuple[np.ndarray, np.ndarray]:
    """Leaf cell ids -> (lon, lat) of the cell center."""
    face, i, j = id_to_face_ij(ids)
    s = (np.asarray(i, np.float64) + 0.5) / (1 << MAX_LEVEL)
    t = (np.asarray(j, np.float64) + 0.5) / (1 << MAX_LEVEL)
    u, v = _st_to_uv(s), _st_to_uv(t)
    out_x = np.empty(face.shape, np.float64)
    out_y = np.empty(face.shape, np.float64)
    for f in range(6):
        m = face == f
        if not m.any():
            continue
        px, py, pz = _face_uv_to_xyz(f, u[m], v[m])
        out_x[m] = np.degrees(np.arctan2(py, px))
        out_y[m] = np.degrees(np.arctan2(pz, np.hypot(px, py)))
    return out_x, out_y


# -- level / hierarchy ops ---------------------------------------------------

def lsb(ids) -> np.ndarray:
    ids = np.asarray(ids, np.uint64)
    return ids & (~ids + np.uint64(1))


def level_of(ids) -> np.ndarray:
    """Cell level (0..30)."""
    low = lsb(ids).astype(np.float64)
    return (MAX_LEVEL - (np.log2(low).astype(np.int64) >> 1)).astype(np.int64)


def parent(ids, level: int) -> np.ndarray:
    ids = np.asarray(ids, np.uint64)
    new_lsb = np.uint64(1 << (2 * (MAX_LEVEL - level)))
    return (ids & (~new_lsb + np.uint64(1))) | new_lsb


def range_min(ids) -> np.ndarray:
    ids = np.asarray(ids, np.uint64)
    return ids - (lsb(ids) - np.uint64(1))


def range_max(ids) -> np.ndarray:
    ids = np.asarray(ids, np.uint64)
    return ids + (lsb(ids) - np.uint64(1))


def contains(parent_ids, child_ids) -> np.ndarray:
    return (range_min(parent_ids) <= np.asarray(child_ids, np.uint64)) & (
        np.asarray(child_ids, np.uint64) <= range_max(parent_ids)
    )


def children(cid: int) -> List[int]:
    cid = int(cid)
    step = int(lsb(cid)) >> 2  # child cells' lsb
    if step == 0:
        return []
    return [cid + m * step for m in (-3, -1, 1, 3)]


def token(cid: int) -> str:
    s = f"{int(cid):016x}".rstrip("0")
    return s or "X"


def from_token(tok: str) -> int:
    return int(tok.ljust(16, "0"), 16)


def cell_corners(cid: int) -> np.ndarray:
    """[4, 2] (lon, lat) corners of a cell (read-only: the array is the
    memo's)."""
    return _cell_corners(int(cid))


@functools.lru_cache(maxsize=1 << 16)
def _cell_corners(cid: int) -> np.ndarray:
    lo = int(range_min(cid))
    level = int(level_of(cid))
    face, i0, j0 = (int(a[0]) for a in id_to_face_ij([lo]))
    size = 1 << (MAX_LEVEL - level)
    # the first leaf in Hilbert order is *a* corner of the cell, not
    # necessarily the (min i, min j) one — mask down to the ij base corner
    i0 &= ~(size - 1)
    j0 &= ~(size - 1)
    corners = []
    for di, dj in ((0, 0), (size, 0), (size, size), (0, size)):
        s = (i0 + di) / (1 << MAX_LEVEL)
        t = (j0 + dj) / (1 << MAX_LEVEL)
        u, v = float(_st_to_uv(s)), float(_st_to_uv(t))
        px, py, pz = _face_uv_to_xyz(face, np.float64(u), np.float64(v))
        corners.append(
            (
                float(np.degrees(np.arctan2(py, px))),
                float(np.degrees(np.arctan2(pz, np.hypot(px, py)))),
            )
        )
    out = np.asarray(corners)
    out.flags.writeable = False
    return out


class S2SFC:
    """Point -> S2 leaf id; bbox -> leaf-id range cover (S2RegionCoverer
    analog: BFS subdivision of intersecting cells under a cell budget)."""

    def __init__(self, min_level: int = 0, max_level: int = 30,
                 level_mod: int = 1, max_cells: int = 8):
        self.min_level = min_level
        self.max_level = max_level
        self.level_mod = max(1, level_mod)
        self.max_cells = max_cells

    def index(self, x, y) -> np.ndarray:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if ((y < -90) | (y > 90)).any():
            raise ValueError("latitude out of range [-90, 90]")
        return lnglat_to_id(x, y)

    # -- covering ---------------------------------------------------------
    def _cell_latlng_bounds(self, cid: int) -> Tuple[float, float, float, float]:
        """Conservative (slightly padded) lon/lat bbox of a cell."""
        c = cell_corners(cid)
        level = int(level_of(cid))
        xs, ys = c[:, 0], c[:, 1]
        xmin, xmax = float(xs.min()), float(xs.max())
        ymin, ymax = float(ys.min()), float(ys.max())
        if xmax - xmin > 180.0:  # face wraps the antimeridian
            xmin, xmax = -180.0, 180.0
        # pole-adjacent cells: corners miss the pole; faces 2 (+z) and 5 (-z)
        # own the poles
        face = cid >> POS_BITS
        if level <= 1 and face == 2:
            ymax = 90.0
        if level <= 1 and face == 5:
            ymin = -90.0
        # curvature padding: cell edges bow outward in lat/lng by up to
        # ~11% of the edge span on low levels
        pad_x = (xmax - xmin) * 0.15
        pad_y = (ymax - ymin) * 0.15
        return (
            max(xmin - pad_x, -180.0), max(ymin - pad_y, -90.0),
            min(xmax + pad_x, 180.0), min(ymax + pad_y, 90.0),
        )

    def _tight_bounds(self, cid: int) -> Tuple[float, float, float, float]:
        """Under-approximated bbox (for the fully-inside test)."""
        c = cell_corners(cid)
        xs, ys = c[:, 0], c[:, 1]
        if float(xs.max() - xs.min()) > 180.0:
            return (0.0, 0.0, 0.0, 0.0)  # never 'fully inside'
        grow_x = (xs.max() - xs.min()) * 0.15
        grow_y = (ys.max() - ys.min()) * 0.15
        # the 'fully inside' box must OVER-estimate the cell so the test
        # never claims containment for a cell that sticks out
        return (
            float(xs.min() - grow_x), float(ys.min() - grow_y),
            float(xs.max() + grow_x), float(ys.max() + grow_y),
        )

    def ranges(self, xmin: float, ymin: float, xmax: float, ymax: float,
               max_cells: int = 0) -> List[ZRange]:
        """Leaf-id ranges covering a lon/lat bbox (never under-covers)."""
        budget = max_cells or self.max_cells or config.SCAN_RANGES_TARGET.to_int()
        query = (xmin, ymin, xmax, ymax)

        def intersects(b):
            return b[0] <= query[2] and b[2] >= query[0] and b[1] <= query[3] and b[3] >= query[1]

        def covered(b):
            return (
                query[0] <= b[0] and b[2] <= query[2]
                and query[1] <= b[1] and b[3] <= query[3]
            )

        out: List[int] = []
        frontier: List[int] = []
        for f in range(6):
            face_cell = (f << POS_BITS) | (1 << (POS_BITS - 1))
            if intersects(self._cell_latlng_bounds(face_cell)):
                frontier.append(face_cell)
        while frontier:
            cid = frontier.pop(0)
            level = int(level_of(cid))
            if (
                level >= self.max_level
                or (level >= self.min_level and covered(self._tight_bounds(cid)))
                or len(out) + len(frontier) >= budget
            ):
                out.append(cid)
                continue
            for ch in children(cid):
                # descend level_mod levels at a time where possible
                if intersects(self._cell_latlng_bounds(ch)):
                    frontier.append(ch)
        rngs = [ZRange(int(range_min(c)), int(range_max(c))) for c in out]
        return _merge(rngs)
