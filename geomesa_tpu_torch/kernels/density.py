"""Density (heatmap) by scatter-add, and the shared pixel mapping.

Port of ``geomesa_tpu/kernels/density.py``. The JAX package leaves this
scatter to XLA; here it is plain PyTorch (``index_add_``). It serves the
padded layout and the compacted layout when no grouped schedule exists.
Cells follow the RenderingGrid convention: row 0 = ymin edge.
"""

from __future__ import annotations

import numpy as np
import torch

#: cells past the grid that take the +0.0 of rows the mask drops (a power
#: of two), spread so their atomic adds on a card do not contend
SPARE_CELLS = 1024


def grid_params(bbox) -> np.ndarray:
    """``[x0, y0, dx, dy]`` f32: origin and span of a density bbox, the
    spans taken in host f64 and every value then rounded to f32 — exactly
    the scalars the JAX kernels close over. A query-axis batch stacks one
    row per member and passes each row's values as 0-d device tensors."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    return np.asarray([xmin, ymin, xmax - xmin, ymax - ymin], np.float32)


def _pixels_at(x: torch.Tensor, y: torch.Tensor, x0, y0, dx, dy, width: int,
               height: int):
    """int32 (px, py) cells against 0-d f32 origin / span tensors."""
    w = torch.tensor(float(width), dtype=torch.float32, device=x.device)
    h = torch.tensor(float(height), dtype=torch.float32, device=x.device)
    px = ((x - x0) / dx * w).to(torch.int32).clamp_(0, width - 1)
    py = ((y - y0) / dy * h).to(torch.int32).clamp_(0, height - 1)
    return px, py


def _param_tensors(bbox, device):
    return [torch.tensor(float(v), dtype=torch.float32, device=device)
            for v in grid_params(bbox)]


def pixel_coords(x: torch.Tensor, y: torch.Tensor, bbox, width: int,
                 height: int):
    """f32 points -> int32 (px, py) cells, op for op as the reference:
    ``clip(int32((x - x0) / dx * width), 0, width - 1)``. The scalars ride
    as 0-d f32 tensors on the points' device so every step is an IEEE f32
    operation (no reciprocal shortcut for a host scalar divisor)."""
    return _pixels_at(x, y, *_param_tensors(bbox, x.device), width, height)


def density_grid_at(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    x0: torch.Tensor, y0: torch.Tensor, dx: torch.Tensor,
                    dy: torch.Tensor, width: int, height: int,
                    weight: torch.Tensor = None) -> torch.Tensor:
    """Masked 2-D histogram against an origin / span given as 0-d f32
    tensors on the points' device (a batch member's row of its ``[Mp, 4]``
    parameter tensor, or :func:`density_grid`'s own): points of any layout
    -> (height, width) f32.

    The reference scatters every row, adding +0.0 for a row the mask
    drops, into the cell its clamped pixel names, so the rows around a
    small viewport pile onto its edge and corner cells. Here a dropped row
    adds its +0.0 to one of :data:`SPARE_CELLS` cells past the grid instead
    (chosen by row number), which the result slices away: every grid cell
    receives the same non-zero additions in the same order, and no device
    sync is needed to leave the dropped rows out."""
    fm = mask.reshape(-1)
    px, py = _pixels_at(x.reshape(-1), y.reshape(-1), x0, y0, dx, dy, width,
                        height)
    cells = height * width
    spare = cells + (torch.arange(fm.numel(), device=x.device) & (SPARE_CELLS - 1))
    idx = torch.where(fm, py.to(torch.int64) * width + px, spare)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    w = fm.to(torch.float32) if weight is None else torch.where(
        fm, weight.reshape(-1).to(torch.float32), zero)
    grid = torch.zeros(cells + SPARE_CELLS, dtype=torch.float32, device=x.device)
    grid.index_add_(0, idx, w)
    return grid[:cells].reshape(height, width)


def density_grid(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, bbox,
                 width: int, height: int,
                 weight: torch.Tensor = None) -> torch.Tensor:
    """Masked 2-D histogram over a bbox: :func:`density_grid_at` with the
    bbox's f32 parameters, so serial and batched grids share one pixel
    mapping."""
    return density_grid_at(x, y, mask, *_param_tensors(bbox, x.device),
                           width, height, weight)


def density_grid_np(x: np.ndarray, y: np.ndarray, mask: np.ndarray, bbox,
                    width: int, height: int, weight=None) -> np.ndarray:
    """Host version over exact (f64) rows, as the reference's band
    correction evaluates it (``xp=np``)."""
    xmin, ymin, xmax, ymax = bbox
    fx, fy, fm = x.reshape(-1), y.reshape(-1), mask.reshape(-1)
    px = np.clip(((fx - xmin) / (xmax - xmin) * width).astype(np.int32),
                 0, width - 1)
    py = np.clip(((fy - ymin) / (ymax - ymin) * height).astype(np.int32),
                 0, height - 1)
    w = fm.astype(np.float32) if weight is None else np.where(
        fm, weight.reshape(-1).astype(np.float32), np.float32(0)
    )
    grid = np.zeros(height * width, np.float32)
    np.add.at(grid, py * width + px, w)
    return grid.reshape(height, width)


def density_grid_f64(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, bbox,
                     width: int, height: int) -> torch.Tensor:
    """:func:`density_grid_np` on the points' device: the f64 pixel mapping
    of host rows, op for op (the scalars ride as 0-d f64 tensors on the
    points' device, so a card divides and never multiplies by a
    reciprocal), and f32 counts. Unweighted: every count is an integer
    below 2**24, so the grid equals the host one bit for bit whatever the
    order of the card's atomic adds."""
    xmin, ymin, xmax, ymax = bbox
    dev = x.device

    def f64(v):
        return torch.tensor(float(v), dtype=torch.float64, device=dev)

    fx, fy = x.reshape(-1).to(torch.float64), y.reshape(-1).to(torch.float64)
    fm = mask.reshape(-1)
    px = ((fx - f64(xmin)) / f64(xmax - xmin) * f64(width)).to(torch.int32).clamp_(0, width - 1)
    py = ((fy - f64(ymin)) / f64(ymax - ymin) * f64(height)).to(torch.int32).clamp_(0, height - 1)
    grid = torch.zeros(height * width, dtype=torch.float32, device=dev)
    grid.index_add_(0, py.to(torch.int64) * width + px, fm.to(torch.float32))
    return grid.reshape(height, width)
