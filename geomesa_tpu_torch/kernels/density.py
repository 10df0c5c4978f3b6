"""Density (heatmap) by scatter-add, and the shared pixel mapping.

Port of ``geomesa_tpu/kernels/density.py``. The JAX package leaves this
scatter to XLA; here it is plain PyTorch (``index_add_``). It serves the
padded layout and the compacted layout when no grouped schedule exists.
Cells follow the RenderingGrid convention: row 0 = ymin edge.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def grid_params(bbox) -> Tuple[float, float, float, float]:
    """``(x0, y0, dx, dy)``: origin and span of a density bbox, the spans
    taken in host f64 and every value then rounded to f32 — exactly the
    scalars the JAX kernels close over."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    return tuple(
        float(np.float32(v)) for v in (xmin, ymin, xmax - xmin, ymax - ymin)
    )


def pixel_coords(x: torch.Tensor, y: torch.Tensor, bbox, width: int,
                 height: int):
    """f32 points -> int32 (px, py) cells, op for op as the reference:
    ``clip(int32((x - x0) / dx * width), 0, width - 1)``. The scalars ride
    as 0-d f32 tensors on the points' device so every step is an IEEE f32
    operation (no reciprocal shortcut for a host scalar divisor)."""
    x0, y0, dx, dy = (
        torch.tensor(v, dtype=torch.float32, device=x.device)
        for v in grid_params(bbox)
    )
    w = torch.tensor(float(width), dtype=torch.float32, device=x.device)
    h = torch.tensor(float(height), dtype=torch.float32, device=x.device)
    px = ((x - x0) / dx * w).to(torch.int32).clamp_(0, width - 1)
    py = ((y - y0) / dy * h).to(torch.int32).clamp_(0, height - 1)
    return px, py


def density_grid(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, bbox,
                 width: int, height: int,
                 weight: torch.Tensor = None) -> torch.Tensor:
    """Masked 2-D histogram: points of any layout -> (height, width) f32."""
    px, py = pixel_coords(x.reshape(-1), y.reshape(-1), bbox, width, height)
    fm = mask.reshape(-1)
    w = fm.to(torch.float32) if weight is None else torch.where(
        fm, weight.reshape(-1).to(torch.float32),
        torch.zeros((), dtype=torch.float32, device=x.device),
    )
    grid = torch.zeros(height * width, dtype=torch.float32, device=x.device)
    grid.index_add_(0, (py.to(torch.int64) * width + px), w)
    return grid.reshape(height, width)


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
