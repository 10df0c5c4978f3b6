"""k-nearest-neighbour selection.

Port of ``geomesa_tpu/kernels/knn.py``: one masked f32 haversine pass over
the scanned points and the k smallest distances, in plain PyTorch (the
reference's is XLA, not Pallas). The reference picks the lowest flat index
among equal distances (``argmin`` iteration for k <= 32, the stable
``lax.top_k`` above); :func:`lowest_k` keeps that choice, which
``torch.topk`` alone does not promise.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.utils.geometry import EARTH_RADIUS_M


def lowest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest values of 1-D ``d`` in (value, index)
    order: every value strictly below the k-th, then the lowest-index rows
    equal to it. Synchronises once (``nonzero``)."""
    k = min(int(k), d.numel())
    if k <= 0:
        return torch.zeros(0, dtype=torch.int64, device=d.device)
    kth = torch.topk(d, k, largest=False, sorted=True).values[-1]
    below = d < kth
    eq = d == kth
    need = k - below.sum()
    sel = below | (eq & (torch.cumsum(eq.to(torch.int32), 0) <= need))
    idx = torch.nonzero(sel).reshape(-1)
    return idx[torch.sort(d[idx], stable=True).indices]


def haversine_f32(x: torch.Tensor, y: torch.Tensor, qx, qy) -> torch.Tensor:
    """Great-circle metres from f32 points to (qx, qy), op for op as the
    reference's device distance."""
    q = torch.tensor([qx, qy], dtype=torch.float32, device=x.device)
    rx1, ry1 = torch.deg2rad(x), torch.deg2rad(y)
    rx2, ry2 = torch.deg2rad(q[0]), torch.deg2rad(q[1])
    a = (torch.sin((ry2 - ry1) / 2) ** 2
         + torch.cos(ry1) * torch.cos(ry2) * torch.sin((rx2 - rx1) / 2) ** 2)
    return 2 * EARTH_RADIUS_M * torch.asin(torch.sqrt(torch.clamp(a, 0, 1)))


def knn_indices(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, qx, qy,
                k: int):
    """Flat indices into the points' layout and f32 distances (metres) of
    the k nearest masked points to (qx, qy); unmasked rows have distance
    inf and may fill the k when fewer rows match."""
    d = haversine_f32(x.reshape(-1), y.reshape(-1), qx, qy)
    d = torch.where(mask.reshape(-1), d,
                    torch.full((), float("inf"), dtype=d.dtype, device=d.device))
    idx = lowest_k(d, k)
    return idx, d[idx]


def knn_indices_np(x: np.ndarray, y: np.ndarray, mask: np.ndarray, qx, qy,
                   k: int):
    """Host twin of :func:`knn_indices` over exact (f64) rows, stable among
    equal distances."""
    fx, fy, fm = x.reshape(-1), y.reshape(-1), mask.reshape(-1)
    rx1, ry1 = np.radians(fx), np.radians(fy)
    rx2, ry2 = np.radians(qx), np.radians(qy)
    a = (np.sin((ry2 - ry1) / 2) ** 2
         + np.cos(ry1) * np.cos(ry2) * np.sin((rx2 - rx1) / 2) ** 2)
    d = 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
    d = np.where(fm, d, np.inf)
    idx = np.argsort(d, kind="stable")[:k]
    return idx, d[idx]
