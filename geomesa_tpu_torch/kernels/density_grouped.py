"""Grouped density over the compacted [C, B] layout: the host schedule, the
CUDA kernel's wrapper, and its plain PyTorch version.

Port of ``geomesa_tpu/kernels/density_pallas.py``: ``build_grouped`` is
copied (same (chunk, tile) pairs, sorted by tile, ladder-padded), and the
Pallas ``density_grid_grouped`` is rewritten as ``csrc/density_grouped.cu``.
:func:`tile_segments` turns the pair list into the kernel's per-tile runs of
chunk ids, each split into :data:`CLUSTER` segments: one thread-block
cluster per tile. The kernel and its plain version take the reference's
operands: the row mask and an optional weight. The wrapper launches the
kernel for CUDA tensors and takes the plain version only for tensors on the
CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from geomesa_tpu_torch.kernels import _build
from geomesa_tpu_torch.kernels.density import grid_params, pixel_coords
from geomesa_tpu_torch.kernels.density_mxu import ladder8, pair_candidates

#: fixed tile, as the reference's
TILE = 128

#: chunks per superchunk in the reference's pair encoding (sc, row)
SG = 8

#: pad-pair tile origin: off-grid, so pad pairs accumulate nothing
_OFFGRID = np.int32(1 << 20)

#: segments per tile: the kernel's thread-block cluster size (kCluster)
CLUSTER = 8

#: rows per stage of the kernel's shared-memory ring; B must be a multiple
_STAGE_ROWS = 128

#: launches of the CUDA kernel (counted where it launches, nowhere else)
launches = 0


def build_grouped(
    compact: Dict, table, keyspace, bbox, width: int, height: int,
    max_dup: float = 4.0, box_cache: Optional[Dict] = None,
) -> Optional[Dict]:
    """Host pair schedule: (superchunk, tile) pairs sorted by tile id.
    None when the index has neither a Morton (z3 / z2) key nor xz codes, or
    the pairs would duplicate rows beyond ``max_dup`` times the real chunk
    count (the caller scatters)."""
    cand = pair_candidates(
        compact, table, keyspace, bbox, width, height, TILE, TILE, box_cache,
    )
    if cand is None:
        return None
    B = compact["B"]
    # budget against the REAL chunk count (len(valid) is ladder-padded)
    C = int((compact["valid"] > 0).sum())
    P = cand["P"]
    if C == 0 or P > max_dup * C:
        return None
    ntx, nty = cand["ntx"], cand["nty"]
    ntiles = ntx * nty
    chunk_of, tx, ty = cand["chunk_of"], cand["tx"], cand["ty"]
    tile = (ty * ntx + tx).astype(np.int32)
    # stable sort keeps chunk ids ascending within each tile run
    order = np.argsort(tile, kind="stable")
    chunk = chunk_of[order]
    tile = tile[order]
    ox = (tx[order] * TILE).astype(np.int32)
    oy = (ty[order] * TILE).astype(np.int32)
    seen = np.zeros(ntiles, bool)
    seen[np.unique(tile)] = True
    Pp = ladder8(P)
    if Pp != P:
        # pad pairs aim at the last tile with an off-grid origin
        pad = Pp - P

        def _pad(a, fill):
            return np.concatenate([a, np.full(pad, fill, a.dtype)])

        chunk = _pad(chunk, 0)
        tile = _pad(tile, ntiles - 1)
        ox = _pad(ox, _OFFGRID)
        oy = _pad(oy, _OFFGRID)
    return {
        "sc": (chunk // SG).astype(np.int32),
        "row": (chunk % SG).astype(np.int32),
        "tile": tile,
        "ox": ox,
        "oy": oy,
        "seen": seen,
        "B": B,
        "ntx": ntx,
        "nty": nty,
        "n_pairs": Pp,
    }


def tile_segments(gr: Dict, cluster: int = CLUSTER) -> Dict[str, np.ndarray]:
    """The kernel's schedule from :func:`build_grouped`'s pairs: pad pairs
    dropped, and every tile of the grid, in tile order, given ``cluster``
    consecutive segments that split its chunk run evenly (a tile without
    pairs gets ``cluster`` empty segments: the kernel writes its zeros).
    Returns int32 arrays ``chunks`` (tile-sorted), ``pair_tile`` (tile of
    each chunk entry) and per segment ``seg_tile``/``seg_begin``/``seg_end``
    (``ntx * nty * cluster`` of each)."""
    real = gr["ox"] != _OFFGRID
    chunks = (gr["sc"][real].astype(np.int64) * SG + gr["row"][real])
    tiles = gr["tile"][real].astype(np.int64)
    every = np.arange(int(gr["ntx"]) * int(gr["nty"]))
    first = np.searchsorted(tiles, every, side="left")
    count = np.searchsorted(tiles, every, side="right") - first
    cuts = first[:, None] + count[:, None] * np.arange(cluster + 1) // cluster
    return {
        "chunks": chunks.astype(np.int32),
        "pair_tile": tiles.astype(np.int32),
        "seg_tile": np.repeat(every, cluster).astype(np.int32),
        "seg_begin": cuts[:, :-1].reshape(-1).astype(np.int32),
        "seg_end": cuts[:, 1:].reshape(-1).astype(np.int32),
        "ntx": int(gr["ntx"]),
    }


def density_grouped_plain(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                          weight: Optional[torch.Tensor], bbox, width: int,
                          height: int, sched: Dict) -> torch.Tensor:
    """The kernel's function in plain PyTorch: every (chunk, tile) entry of
    the schedule adds the weight (or 1) of the chunk's masked rows whose
    cell falls in that tile."""
    px, py = pixel_coords(x, y, bbox, width, height)
    ch = sched["chunks"].to(torch.int64)
    t = sched["pair_tile"].to(torch.int64)
    ntx = sched["ntx"]
    ox = ((t % ntx) * TILE)[:, None]
    oy = ((t // ntx) * TILE)[:, None]
    gx, gy = px[ch].to(torch.int64), py[ch].to(torch.int64)
    inside = mask[ch] & (gx >= ox) & (gx < ox + TILE) & (gy >= oy) & (gy < oy + TILE)
    idx = (gy * width + gx)[inside]
    vals = torch.ones(idx.shape, dtype=torch.float32, device=x.device) \
        if weight is None else weight[ch][inside]
    grid = torch.zeros(height * width, dtype=torch.float32, device=x.device)
    grid.index_add_(0, idx, vals)
    return grid.reshape(height, width)


def _bind(lib):
    lib.gm_density_grouped_cluster.restype = ctypes.c_int
    lib.gm_density_grouped_cluster.argtypes = []
    if lib.gm_density_grouped_cluster() != CLUSTER:
        raise RuntimeError("csrc/density_grouped.cu's kCluster differs from "
                           f"CLUSTER = {CLUSTER}")
    lib.gm_density_grouped_launch.restype = ctypes.c_int
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gm_density_grouped_launch.argtypes = [
        p, p, p, p, i, p, p, p, p, i, i, f, f, f, f, i, i, p, p,
    ]


def density_grouped(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    weight: Optional[torch.Tensor], bbox, width: int,
                    height: int, sched: Dict) -> torch.Tensor:
    """(height, width) f32 grid over compact [C, B] f32 ``x``/``y``: each
    row whose bool ``mask`` is true adds its f32 ``weight`` (or 1 when
    ``weight`` is None), under the schedule from :func:`tile_segments` (its
    arrays as int32 tensors on ``x``'s device)."""
    global launches
    if x.device.type == "cpu":
        return density_grouped_plain(x, y, mask, weight, bbox, width, height, sched)
    if x.device.type != "cuda":
        raise ValueError(f"density_grouped: unsupported device {x.device}")
    cols = [("x", x, torch.float32), ("y", y, torch.float32),
            ("mask", mask, torch.bool)]
    if weight is not None:
        cols.append(("weight", weight, torch.float32))
    for name, a, dt in cols:
        if a.dtype != dt or a.dim() != 2 or not a.is_contiguous() \
                or a.shape != x.shape or a.device != x.device \
                or a.data_ptr() % 16:
            raise ValueError(f"density_grouped: {name} must be a contiguous, "
                             f"16-byte aligned {dt} [C, B] like x, got "
                             f"{a.dtype} {tuple(a.shape)}")
    B = x.shape[1]
    if B % _STAGE_ROWS:
        raise ValueError(f"density_grouped: B = {B} is not a multiple of {_STAGE_ROWS}")
    keys = ("chunks", "seg_tile", "seg_begin", "seg_end")
    for k in keys:
        a = sched[k]
        if a.dtype != torch.int32 or not a.is_contiguous() or a.device != x.device:
            raise ValueError(f"density_grouped: schedule {k} must be a "
                             f"contiguous int32 tensor on {x.device}")
    nseg = sched["seg_tile"].numel()
    ntiles = -(-width // TILE) * -(-height // TILE)
    if nseg != ntiles * CLUSTER or sched["ntx"] != -(-width // TILE):
        raise ValueError(f"density_grouped: {nseg} segments do not give each of "
                         f"the {width}x{height} grid's {ntiles} tiles {CLUSTER}")
    x0, y0, dx, dy = (float(v) for v in grid_params(bbox))
    lib = _build.load("density_grouped", _bind)
    grid = torch.empty(height * width, dtype=torch.float32, device=x.device)
    rc = lib.gm_density_grouped_launch(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(),
        None if weight is None else weight.data_ptr(), B,
        sched["seg_tile"].data_ptr(), sched["seg_begin"].data_ptr(),
        sched["seg_end"].data_ptr(), sched["chunks"].data_ptr(), nseg,
        sched["ntx"], x0, y0, dx, dy, width, height, grid.data_ptr(),
        _build.stream_handle(x.device),
    )
    _build.check(rc, "density_grouped kernel")
    launches += 1
    return grid.reshape(height, width)
