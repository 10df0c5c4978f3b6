"""Density as batched one-hot matrix products over (chunk, tile) pairs: the
pair schedule of the grouped kernel and of the einsum rung, and the einsum
rung itself.

Port of ``geomesa_tpu/kernels/density_mxu.py``: ``ladder8``,
``_chunk_boxes`` and ``pair_candidates`` for the z3 and z2 key spaces (the
grouped kernel's schedule), ``tile_shape``, ``pair_batch`` and
``build_pairs`` (the einsum rung's, z3 and z2 only, as the reference's),
and ``density_grid_pairs``. Chunks are B-row runs of the z-sorted order, so
each spans a small spatial box computed from its own sorted keys; a chunk is
paired only with the grid tiles its box overlaps, and each pair adds

    tile[y, x] += sum_b onehot(py_b == y) * w_b * onehot(px_b == x)

as one [TY, B] @ [B, TX] product. The JAX package leaves that einsum to
XLA, outside any Pallas kernel, so here it is plain PyTorch (``torch.bmm``
over batches of pairs) on the card and on the CPU, not a hand kernel.

The xz3 / xz2 key spaces get chunk boxes too, which the JAX package does
not give them (it scatters there): an xz code bounds an element only by
its node's doubled cell, 0.18 x 0.09 degrees at the default resolution,
wider than a city viewport. So an xz chunk's box is taken from the f64
bounds-centroid columns the density grids, the min / max of its rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.zorder import deinterleave2, deinterleave3
from geomesa_tpu_torch.kernels.density import pixel_coords

#: rows one pair batch multiplies: PB pairs x B rows (~512 Ki)
_PAIR_ROWS = 512 * 1024

#: the einsum rung runs a pair batch in slices of at most this share of
#: the scan's compacted rows, and no fewer than :data:`_SLICE_MIN_ROWS`:
#: its f32 one-hots and their masks take about 430 bytes a row (XLA builds
#: the reference's one-hots inside the product; here they are
#: materialized), so a slice's scratch stays near the scan's own columns
#: and a partitioned store streaming its partitions keeps the memory bound
#: its residency budget sets, while each slice's dozen launches still run
#: over enough rows
_SLICE_SHARE = 8
_SLICE_MIN_ROWS = 12 * 1024


def tile_shape():
    """The einsum rung's grid tile (TY, TX) in cells:
    ``geomesa.mxu.tile.y`` / ``.x``."""
    return (config.MXU_TILE_Y.to_int() or 32, config.MXU_TILE_X.to_int() or 64)


def pair_batch(B: int) -> int:
    """Pairs per product batch for B-row chunks."""
    return max(8, min(4096, _PAIR_ROWS // max(B, 1)))


def ladder8(n: int) -> int:
    """Geometric (~1.25x) bucket ladder on multiples of 8: the shared
    bucketing rule for compact chunk counts and pair padding."""
    b = 8
    while b < n:
        b = -(-int(b * 1.25) // 8) * 8
    return b


def _chunk_boxes(compact: Dict, table, col: str, dims: int, shift: int,
                 box_cache: Optional[Dict]):
    """Exact per-chunk normalized-index boxes from the sorted key column:
    deinterleave every window row's quantized key and take the per-chunk
    min/max (each quantized cell contributes its full extent)."""
    ckey = (compact["whash"], compact["B"], col, table.n)
    if box_cache is not None:
        hit = box_cache.get(ckey)
        if hit is not None:
            return hit
    key = table.key_columns[col]
    L = table.shard_len
    cstart, lo, valid = compact["cstart"], compact["lo"], compact["valid"]
    act = valid > 0
    cs = (cstart + lo).astype(np.int64)
    s_of = cs // L
    g0 = table.shard_bounds[s_of] + (cs % L)
    segs = [key[a:a + int(v)] for a, v in zip(g0[act], valid[act])]
    if not segs:
        return None
    cat = np.concatenate(segs).astype(np.uint64)
    sh = np.uint64(shift)
    deinter = deinterleave2 if dims == 2 else deinterleave3
    lo_parts = deinter(cat << sh)
    hi_parts = deinter(((cat + np.uint64(1)) << sh) - np.uint64(1))
    starts = np.concatenate(([0], np.cumsum(valid[act].astype(np.int64))[:-1]))
    n_chunk = len(valid)
    out = []
    for d in range(2):  # x, y only (z3's time dimension is irrelevant here)
        lo_d = np.minimum.reduceat(lo_parts[d], starts)
        hi_d = np.maximum.reduceat(hi_parts[d], starts)
        full_lo = np.zeros(n_chunk, np.uint64)
        full_hi = np.zeros(n_chunk, np.uint64)
        full_lo[act] = lo_d
        full_hi[act] = hi_d
        out.append((full_lo, full_hi))
    if box_cache is not None:
        if len(box_cache) >= 64:
            box_cache.clear()
        box_cache[ckey] = out
    return out


#: where a NaN coordinate stands in a chunk box: below every grid, as the
#: device puts a NaN row in cell 0 (the int cast of NaN is 0 on the card,
#: and INT_MIN clamped to 0 on the host)
_NAN_AT = -720.0


def _chunk_data_boxes(compact: Dict, table, geom: str, box_cache: Optional[Dict]):
    """Per-chunk (x0, x1), (y0, y1) degree boxes of the f64 ``<geom>__x`` /
    ``<geom>__y`` values of each chunk's valid rows (zeros for padding
    chunks; a NaN value counts as :data:`_NAN_AT`)."""
    ckey = (compact["whash"], compact["B"], geom, table.n)
    if box_cache is not None:
        hit = box_cache.get(ckey)
        if hit is not None:
            return hit
    L = table.shard_len
    cstart, lo, valid = compact["cstart"], compact["lo"], compact["valid"]
    act = valid > 0
    if not act.any():
        return None
    cs = (cstart + lo).astype(np.int64)
    g0 = table.shard_bounds[cs // L] + (cs % L)
    lens = valid[act].astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    pos = np.repeat(g0[act], lens) + np.arange(int(lens.sum())) - np.repeat(starts, lens)
    rows = table.rows([geom + "__x", geom + "__y"], pos)
    out = []
    for c in (geom + "__x", geom + "__y"):
        v = np.asarray(rows[c], np.float64)
        v = np.where(np.isnan(v), _NAN_AT, v)
        full_lo = np.zeros(len(valid))
        full_hi = np.zeros(len(valid))
        full_lo[act] = np.minimum.reduceat(v, starts)
        full_hi[act] = np.maximum.reduceat(v, starts)
        out.append((full_lo, full_hi))
    if box_cache is not None:
        if len(box_cache) >= 64:
            box_cache.clear()
        box_cache[ckey] = out
    return out


def pair_candidates(
    compact: Dict, table, keyspace, bbox, width: int, height: int,
    TY: int, TX: int, box_cache: Optional[Dict] = None,
) -> Optional[Dict]:
    """(chunk, tile) candidate list for the compacted scan layout. Chunk
    boxes are conservative supersets (key quantization widens them by a
    cell; a one-cell pad covers the device's f32 pixel rounding). None
    when the index has neither a Morton key column nor xz codes
    (attribute and id tables take the scatter rung)."""
    kind = getattr(keyspace, "kind", None)
    valid = compact["valid"]
    act = valid > 0
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    cellw = (xmax - xmin) / width
    cellh = (ymax - ymin) / height
    if kind in ("xz3", "xz2"):
        boxes = _chunk_data_boxes(compact, table, keyspace.geom, box_cache)
        if boxes is None:
            return None
        (bx0, bx1), (by0, by1) = boxes
        lon_ext, lat_ext = 180.0, 90.0
    else:
        if kind == "z3":
            col, dims = "__z3", 3
        elif kind == "z2":
            col, dims = "__z2", 2
        else:
            return None
        key = table.key_columns.get(col)
        if key is None:
            return None
        shift = 0
        if table.key_shifts is not None:
            shift = int(table.key_shifts.get(col, 0))
        lon, lat = keyspace.sfc.lon, keyspace.sfc.lat
        bits = lon.bits
        boxes = _chunk_boxes(compact, table, col, dims, shift, box_cache)
        if boxes is None:
            return None
        (x0, x1), (y0, y1) = boxes
        scale_x = (lon.hi - lon.lo) / (1 << bits)
        scale_y = (lat.hi - lat.lo) / (1 << bits)
        x0 = x0.astype(np.float64)
        x1 = x1.astype(np.float64)
        y0 = y0.astype(np.float64)
        y1 = y1.astype(np.float64)
        # each quantized cell contributes its full extent
        bx0, bx1 = lon.lo + x0 * scale_x, lon.lo + (x1 + 1) * scale_x
        by0, by1 = lat.lo + y0 * scale_y, lat.lo + (y1 + 1) * scale_y
        lon_ext = max(abs(lon.lo), abs(lon.hi))
        lat_ext = max(abs(lat.lo), abs(lat.hi))
    # the pad covers the device's f32 px/py rounding and f32 coordinate
    # representation error (|x| * 2^-24), which at deep zoom exceeds a cell
    ulp_x = lon_ext * 2.0 ** -24
    ulp_y = lat_ext * 2.0 ** -24
    pad_x = 1 + int(np.ceil(ulp_x / max(cellw, 1e-300)))
    pad_y = 1 + int(np.ceil(ulp_y / max(cellh, 1e-300)))
    cx0 = np.floor((bx0 - xmin) / cellw).astype(np.int64) - pad_x
    cx1 = np.floor((bx1 - xmin) / cellw).astype(np.int64) + pad_x
    cy0 = np.floor((by0 - ymin) / cellh).astype(np.int64) - pad_y
    cy1 = np.floor((by1 - ymin) / cellh).astype(np.int64) + pad_y
    cx0 = np.clip(cx0, 0, width - 1)
    cx1 = np.clip(cx1, 0, width - 1)
    cy0 = np.clip(cy0, 0, height - 1)
    cy1 = np.clip(cy1, 0, height - 1)

    ntx = -(-width // TX)
    nty = -(-height // TY)
    tx0, tx1 = cx0 // TX, cx1 // TX
    ty0, ty1 = cy0 // TY, cy1 // TY
    nx = np.where(act, tx1 - tx0 + 1, 0)
    ny = np.where(act, ty1 - ty0 + 1, 0)
    per = (nx * ny).astype(np.int64)
    P = int(per.sum())
    if P == 0:
        return None
    chunk_of = np.repeat(np.arange(len(per)), per)
    j = np.arange(P) - np.repeat(np.cumsum(per) - per, per)
    tx = tx0[chunk_of] + (j % np.maximum(nx[chunk_of], 1))
    ty = ty0[chunk_of] + (j // np.maximum(nx[chunk_of], 1))
    return {
        "chunk_of": chunk_of, "tx": tx, "ty": ty,
        "ntx": ntx, "nty": nty, "P": P,
    }


def build_pairs(
    compact: Dict, table, keyspace, bbox, width: int, height: int,
    box_cache: Optional[Dict] = None,
) -> Optional[Dict]:
    """(chunk, tile) pair arrays of the einsum rung, ``n_pairs`` of each.
    ``P`` is the reference's padded pair count (a multiple of the pair
    batch above the ladder), kept only as the registry key's shape bucket.
    None for a key space other than z3 / z2 (the scan scatters) or no
    pair."""
    if getattr(keyspace, "kind", None) not in ("z3", "z2"):
        return None
    TY, TX = tile_shape()
    cand = pair_candidates(compact, table, keyspace, bbox, width, height, TY, TX,
                           box_cache)
    if cand is None:
        return None
    tx, ty, P = cand["tx"], cand["ty"], cand["P"]
    PB = pair_batch(compact["B"])
    return {
        "chunk": cand["chunk_of"].astype(np.int32),
        "px0": (tx * TX).astype(np.int32),
        "py0": (ty * TY).astype(np.int32),
        "tile": (ty * cand["ntx"] + tx).astype(np.int32),
        "P": -(-ladder8(P) // PB) * PB, "PB": PB, "ntx": cand["ntx"],
        "nty": cand["nty"], "TY": TY, "TX": TX, "n_pairs": P,
    }


def density_grid_pairs(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, bbox,
                       width: int, height: int, weight: Optional[torch.Tensor],
                       pairs: Dict) -> torch.Tensor:
    """[C, B] compact columns and :func:`build_pairs`' arrays (as tensors on
    the columns' device) -> (height, width) f32 grid.

    A slice of a pair batch (at most 1/:data:`_SLICE_SHARE` of the scan's
    [C, B] rows or :data:`_SLICE_MIN_ROWS`, whichever is more, and at
    least one pair) gathers its chunks' pixels and
    weights, builds f32 one-hots ([pb, B, TY] rows carrying the weight,
    [pb, B, TX] columns) and multiplies them into pb tiles, which
    ``index_add_`` sums into the grid's tiles; the slice's operands are
    freed before the next. The products are float32 at
    PyTorch's default matmul precision: 0/1 one-hots keep a count exact up
    to 2^24, and a weighted product rounds as an f32 dot does (TF32, where
    a caller enables it for the process, would keep about three digits of
    each weight)."""
    TY, TX, PB = pairs["TY"], pairs["TX"], pairs["PB"]
    ntx, nty, n_pairs = pairs["ntx"], pairs["nty"], pairs["n_pairs"]
    rows = max(_SLICE_MIN_ROWS, x.numel() // _SLICE_SHARE)
    step = max(1, min(PB, rows // max(x.shape[-1], 1)))
    dev = x.device
    px, py = pixel_coords(x, y, bbox, width, height)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w = mask.to(torch.float32) if weight is None else torch.where(
        mask, weight.to(torch.float32), zero)
    ix = torch.arange(TX, dtype=torch.int32, device=dev)
    iy = torch.arange(TY, dtype=torch.int32, device=dev)
    acc = torch.zeros((ntx * nty, TY * TX), dtype=torch.float32, device=dev)
    for lo in range(0, n_pairs, step):
        hi = min(lo + step, n_pairs)
        pc = pairs["chunk"][lo:hi]
        lx = px[pc] - pairs["px0"][lo:hi, None]
        ly = py[pc] - pairs["py0"][lo:hi, None]
        ohx = (lx[:, :, None] == ix).to(torch.float32)                    # [pb, B, TX]
        rows = torch.where(ly[:, :, None] == iy, w[pc][:, :, None], zero)  # [pb, B, TY]
        tiles = torch.bmm(rows.transpose(1, 2), ohx)                       # [pb, TY, TX]
        acc.index_add_(0, pairs["tile"][lo:hi], tiles.reshape(hi - lo, TY * TX))
        del ohx, rows, tiles
    grid = acc.reshape(nty, ntx, TY, TX).permute(0, 2, 1, 3)
    return grid.reshape(nty * TY, ntx * TX)[:height, :width].contiguous()
