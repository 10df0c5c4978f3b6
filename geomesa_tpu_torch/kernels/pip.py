"""Even-odd point-in-polygon mask: edge tables, the CUDA kernel's wrapper,
and its plain PyTorch version.

Port of ``geomesa_tpu/kernels/pallas_kernels.py`` (``polygon_edge_tables``
and ``pack_edges`` copied; ``_pip_kernel`` rewritten as ``csrc/pip.cu``,
which interleaves the [4, Ep] table into float4 edge records as it stages
it). The wrapper launches the kernel for CUDA tensors and takes the plain
version only for tensors on the CPU. :func:`span_pairs` counts the crossing
tests a point set needs, for the kernel's bound.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from geomesa_tpu_torch.kernels import _build
from geomesa_tpu_torch.utils import geometry as geo

#: launches of the CUDA kernel (counted where it launches, nowhere else)
launches = 0

#: points per chunk of the plain version's [N, E] broadcast
_PLAIN_CHUNK = 1 << 20


def polygon_edge_tables(poly: geo.Polygon):
    """Edge table of one Polygon (shell + holes): ``(f64_tuple, packed)``,
    ``f64_tuple`` = ``(x1, y1, x2, y2, slope)`` for exact host evaluation
    and ``packed`` the [4, Ep] f32 table for the device. Horizontal edges
    get slope denominator 1.0 (they never satisfy the crossing test)."""
    rings = [np.asarray(geo._close_ring(poly.shell), np.float64)] + [
        np.asarray(geo._close_ring(h), np.float64) for h in poly.holes
    ]
    x1 = np.concatenate([r[:-1, 0] for r in rings])
    y1 = np.concatenate([r[:-1, 1] for r in rings])
    x2 = np.concatenate([r[1:, 0] for r in rings])
    y2 = np.concatenate([r[1:, 1] for r in rings])
    dy = np.where(y2 - y1 == 0.0, 1.0, y2 - y1)
    slope = (x2 - x1) / dy
    return (x1, y1, x2, y2, slope), pack_edges(x1, y1, y2, slope)


def pack_edges(x1, y1, y2, slope) -> np.ndarray:
    """Edge table -> [4, Ep] f32, padded to a multiple of 128. Padding
    columns have y1 == y2 == 0, so ``(y1 > y) != (y2 > y)`` is false."""
    e = len(x1)
    ep = max(128, ((e + 127) // 128) * 128)
    out = np.zeros((4, ep), np.float32)
    out[0, :e] = x1
    out[1, :e] = y1
    out[2, :e] = y2
    out[3, :e] = slope
    return out


def span_pairs(y, packed: np.ndarray, n_edges: int = None) -> int:
    """Number of (point, edge) pairs with ``(y1 > y) != (y2 > y)``: the
    crossing tests the data needs, which the kernel's exact culling cannot
    skip. For an edge that is the points with ``min(y1, y2) <= y <
    max(y1, y2)``, counted by binary search over the sorted f32 ``y`` (NaN
    sorts last and is never counted)."""
    ne = packed.shape[1] if n_edges is None else n_edges
    y1, y2 = packed[1, :ne], packed[2, :ne]
    ys = np.sort(np.asarray(y, np.float32).reshape(-1))
    lo = np.searchsorted(ys, np.minimum(y1, y2), side="left")
    hi = np.searchsorted(ys, np.maximum(y1, y2), side="left")
    return int((hi - lo).sum())


def pip_mask_plain(x: torch.Tensor, y: torch.Tensor, edges: torch.Tensor,
                   n_edges: int = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: broadcast crossing parity of
    ``geomesa_tpu/filter/compile.py`` over the packed f32 rows, chunked over
    points to bound the [N, E] intermediate."""
    ne = edges.shape[1] if n_edges is None else n_edges
    x1, y1, y2, slope = (edges[i, :ne] for i in range(4))
    xf, yf = x.reshape(-1), y.reshape(-1)
    out = torch.empty(xf.shape, dtype=torch.bool, device=x.device)
    for lo in range(0, xf.numel(), _PLAIN_CHUNK):
        xb = xf[lo:lo + _PLAIN_CHUNK, None]
        yb = yf[lo:lo + _PLAIN_CHUNK, None]
        cond = (y1 > yb) != (y2 > yb)
        xint = x1 + (yb - y1) * slope
        crossings = (cond & (xb < xint)).sum(dim=1)
        out[lo:lo + _PLAIN_CHUNK] = (crossings % 2) == 1
    return out.reshape(x.shape)


def _bind(lib):
    lib.gm_pip_launch.restype = ctypes.c_int
    lib.gm_pip_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]


def pip_mask(x: torch.Tensor, y: torch.Tensor, edges: torch.Tensor,
             n_edges: int = None) -> torch.Tensor:
    """Even-odd point-in-polygon mask of ``x``/``y`` (f32, any shape)
    against one packed [4, Ep] f32 edge table; bool of ``x``'s shape.
    ``n_edges``: real edge count (default Ep; padding never crosses)."""
    global launches
    if x.device.type == "cpu":
        return pip_mask_plain(x, y, edges, n_edges)
    if x.device.type != "cuda":
        raise ValueError(f"pip_mask: unsupported device {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32 \
            or edges.dtype != torch.float32:
        raise TypeError("pip_mask takes float32 points and edges")
    if x.shape != y.shape or edges.dim() != 2 or edges.shape[0] != 4:
        raise ValueError(f"pip_mask shapes: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}, edges {tuple(edges.shape)}")
    if not (x.is_contiguous() and y.is_contiguous() and edges.is_contiguous()):
        raise ValueError("pip_mask takes contiguous tensors")
    if y.device != x.device or edges.device != x.device:
        raise ValueError("pip_mask tensors must share one device")
    ep = edges.shape[1]
    ne = ep if n_edges is None else int(n_edges)
    if not 0 <= ne <= ep:
        raise ValueError(f"n_edges {ne} outside [0, {ep}]")
    lib = _build.load("pip", _bind)
    out = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    rc = lib.gm_pip_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), edges.data_ptr(), ep, ne,
        out.data_ptr(), _build.stream_handle(x.device),
    )
    _build.check(rc, "pip kernel")
    launches += 1
    return out
