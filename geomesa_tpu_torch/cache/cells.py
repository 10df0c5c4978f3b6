"""The cell family of the lon/lat grid: a cell at ``level`` is one of the
2^level x 2^level half-open boxes ``[x0, x1) x [y0, y1)``, identified by
its z2 curve prefix (``curves/zorder.interleave2(ix, iy)``).

Copy of the part of ``geomesa_tpu/cache/cells.py`` the spatial joins use:
cell assignment, cell boxes and the classification margin. The cells are
realized as closed boxes with their open edges pulled one f64 ulp inward,
except the last column and row, which close at exactly 180 / 90, so the
cells of a level partition the whole domain. The aggregate cache's
decomposition (``decompose`` / ``decompose_region``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from geomesa_tpu_torch.curves.zorder import interleave2

Box = Tuple[float, float, float, float]

#: cell-vs-polygon classification margin (degrees): a cell is INTERIOR or
#: OUTSIDE only when the verdict holds with this much room, so the f32
#: near-edge uncertainty of the point-in-polygon test plus f32 coordinate
#: rounding can never flip a row the classification already committed;
#: near-edge rows land in BOUNDARY cells and decide through the exact test
CLASSIFY_MARGIN = 1e-3


def _prev(v: float) -> float:
    return float(np.nextafter(v, -np.inf))


def cell_box(level: int, ix: int, iy: int) -> Box:
    """The closed-box realization of the half-open cell ``(ix, iy)`` at
    ``level``: open edges one f64 ulp inward, except the domain-edge
    column / row, which closes at exactly 180 / 90."""
    n = 1 << level
    sx, sy = 360.0 / n, 180.0 / n
    xmax = 180.0 if ix == n - 1 else _prev((ix + 1) * sx - 180.0)
    ymax = 90.0 if iy == n - 1 else _prev((iy + 1) * sy - 90.0)
    return (ix * sx - 180.0, iy * sy - 90.0, xmax, ymax)


def cell_prefix(level: int, cell: Tuple[int, int]) -> int:
    """A cell's z2 curve prefix: its identity on the curve."""
    ix, iy = cell
    return int(interleave2(
        np.asarray([ix], np.uint64), np.asarray([iy], np.uint64)
    )[0])


def point_cells(x, y, level: int) -> Tuple[np.ndarray, np.ndarray]:
    """int64 ``(ix, iy)`` of each point at ``level``, clipped to the grid:
    every consumer derives the same cell for the same f64 coordinate."""
    n = 1 << level
    sx, sy = 360.0 / n, 180.0 / n
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    ix = np.clip(np.floor((x + 180.0) / sx), 0, n - 1).astype(np.int64)
    iy = np.clip(np.floor((y + 90.0) / sy), 0, n - 1).astype(np.int64)
    return ix, iy


def cell_boxes(level: int, ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Vectorized :func:`cell_box`: f64 [C, 4] closed boxes of the cells
    ``(ix, iy)``."""
    n = 1 << level
    sx, sy = 360.0 / n, 180.0 / n
    ix = np.asarray(ix, np.int64)
    iy = np.asarray(iy, np.int64)
    xmax = np.nextafter((ix + 1) * sx - 180.0, -np.inf)
    ymax = np.nextafter((iy + 1) * sy - 90.0, -np.inf)
    xmax = np.where(ix == n - 1, 180.0, xmax)
    ymax = np.where(iy == n - 1, 90.0, ymax)
    return np.stack([ix * sx - 180.0, iy * sy - 90.0, xmax, ymax], axis=1)
