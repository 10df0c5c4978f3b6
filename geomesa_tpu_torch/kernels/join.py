"""Spatial-join predicates: the point-point pair verdicts, the polygon
verdicts, point-in-polygon assignment, cell classification, their plain
versions and the wrappers of their CUDA kernels.

Port of ``geomesa_tpu/kernels/join.py``. Each predicate is one function
that serves both the NumPy brute-force reference (``xp=np``, copied
verbatim) and the plain PyTorch version (``xp=torch``), in the same f32
arithmetic and op order, so a co-partitioned join equals the N*M brute
force bit for bit: the cells decide only which pairs are tested, never how
a tested pair decides.

The reference runs these predicates as jitted XLA functions over padded
tiles. Here four hand-written kernels in ``csrc/join.cu`` replace them,
each with its plain version beside it (``*_plain``), which serves CPU
tensors only; a CUDA tensor launches the kernel or raises:

* :func:`pair_tiles`: ``[C, Bp, Pp]`` pair verdicts of padded tiles and a
  count per tile (``planning/join_exec.py``'s pairwise sections); the mask
  is written only when the caller wants pairs;
* :func:`pair_flat`: the same verdict over a flat ``[Kp]`` candidate list
  with its masked count (the sparse cells);
* :func:`polygon_verdict`: ``[Np, Rp]`` verdicts of points against padded
  polygon tables (``pip`` parity per part, OR over a row's parts, or
  ``poly_bbox`` containment);
* :func:`pip_assign` on CUDA tensors: each masked point's lowest
  containing polygon id, else -1 (``processes.spatial_join``).

The kernels walk edge tables in order, one point per thread, so they need
each part's (polygon's) edges contiguous and in ascending id order:
:func:`edge_tensors` and :func:`table_tensors` check that on the host as
they upload a table, and the wrappers take only tables made by them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from geomesa_tpu_torch.kernels import _build

#: launches of each CUDA kernel (counted where it launches, nowhere else)
launches = {"pair_tiles": 0, "pair_flat": 0, "polygon_verdict": 0, "pip_assign": 0}

#: crossing-matrix elements per chunk of the plain point-in-polygon versions
_PLAIN_ELEMS = 1 << 26


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def crossing_matrix(px, py, ex1, ey1, ex2, ey2, xp):
    """[N, E] even-odd ray-crossing indicators for points against edges.

    Standard upward ray: edge (p1, p2) crosses the horizontal ray from
    (x, y) iff (y1 > y) != (y2 > y) and x < x-intersect at y.
    """
    px = px[:, None]
    py = py[:, None]
    y1, y2 = ey1[None, :], ey2[None, :]
    x1, x2 = ex1[None, :], ex2[None, :]
    straddle = (y1 > py) != (y2 > py)
    denom = y2 - y1
    # guard padded/degenerate edges (denom == 0 never straddles anyway)
    denom = xp.where(denom == 0, 1.0, denom)
    xint = x1 + (py - y1) * (x2 - x1) / denom
    return straddle & (px < xint)


def _chunks(n: int, n_edges: int):
    step = max(1, _PLAIN_ELEMS // max(n_edges, 1))
    return ((lo, min(lo + step, n)) for lo in range(0, n, step))


def pip_assign(px, py, mask, edges, xp):
    """Assign each masked point its first containing polygon id, else -1.

    ``edges``: dict with float32 arrays x1/y1/x2/y2 [E], int32 poly_id [E],
    and n_polys (static python int). Returns int32 [N]. With ``xp=torch``
    a CUDA tensor launches the ``pip_assign`` kernel (``edges`` from
    :func:`edge_tensors`) and a CPU tensor takes :func:`pip_assign_plain`.
    """
    if xp is not np:
        if px.device.type == "cuda":
            return _pip_assign_kernel(px, py, mask, edges)
        if px.device.type != "cpu":
            raise ValueError(f"pip_assign: unsupported device {px.device}")
        return pip_assign_plain(px, py, mask, edges)
    P = int(edges["n_polys"])
    cross = crossing_matrix(
        px.reshape(-1), py.reshape(-1),
        edges["x1"], edges["y1"], edges["x2"], edges["y2"], xp,
    ).astype(xp.int32)
    counts = np.zeros((P, cross.shape[0]), np.int32)
    np.add.at(counts, edges["poly_id"], cross.T)
    inside = (counts % 2) == 1  # [P, N]
    first = xp.argmax(inside, axis=0).astype(xp.int32)
    any_hit = inside.any(axis=0)
    assign = xp.where(any_hit, first, -1)
    return xp.where(mask.reshape(-1), assign, -1)


def pip_assign_plain(px: torch.Tensor, py: torch.Tensor, mask: torch.Tensor,
                     edges) -> torch.Tensor:
    """The ``pip_assign`` kernel's function in plain PyTorch: the crossing
    matrix of the masked points, parity per polygon by ``index_add_``, and
    the first odd polygon by ``argmax``, chunked over points to bound the
    matrix."""
    P = int(edges["n_polys"])
    pxf, pyf = px.reshape(-1), py.reshape(-1)
    pid = edges["poly_id"].to(torch.int64)
    out = torch.full(pxf.shape, -1, dtype=torch.int32, device=px.device)
    rows = torch.nonzero(mask.reshape(-1)).reshape(-1)  # unmasked points stay -1
    for lo, hi in _chunks(rows.numel(), int(pid.numel())):
        r = rows[lo:hi]
        cross = crossing_matrix(pxf[r], pyf[r], edges["x1"], edges["y1"],
                                edges["x2"], edges["y2"], torch).to(torch.int32)
        counts = torch.zeros((P, hi - lo), dtype=torch.int32, device=px.device)
        counts.index_add_(0, pid, cross.T)
        inside = (counts % 2) == 1
        first = torch.argmax(inside.to(torch.int32), dim=0).to(torch.int32)
        out[r] = torch.where(inside.any(dim=0), first, -1)
    return out


#: classify_cells codes — a cell wholly outside the polygon, wholly inside
#: it (with margin to spare), or touching its boundary
CELL_OUTSIDE, CELL_INTERIOR, CELL_BOUNDARY = 0, 1, 2


def _poly_edges(g) -> "list[np.ndarray]":
    """Per-polygon [E, 4] f64 ring segments (shell + holes) of a
    (multi)polygon literal — the edge tables the crossing test runs on."""
    from geomesa_tpu_torch.utils import geometry as geo

    polys = g.polygons if isinstance(g, geo.MultiPolygon) else (g,)
    out = []
    for p in polys:
        segs = []
        for r in p.rings():
            segs.append(np.concatenate([r[:-1], r[1:]], axis=1))
        out.append(np.concatenate(segs, axis=0).astype(np.float64))
    return out


def classify_cells(boxes: np.ndarray, g, margin: float) -> np.ndarray:
    """Classify axis-aligned cells against a (multi)polygon literal:
    int8 [C] of CELL_OUTSIDE / CELL_INTERIOR / CELL_BOUNDARY for ``boxes``
    [C, 4] = (xmin, ymin, xmax, ymax), f64.

    Every box is inflated by ``margin`` before testing, so INTERIOR and
    OUTSIDE verdicts hold for every point the scan kernel could place in
    the cell even under its f32 edge arithmetic — near-edge rows always
    land in BOUNDARY cells, which the caller tests through the exact
    polygon predicate.

    The segment-vs-box test is an exact SAT (box axes + the segment's
    normal); insidedness of edge-free cells reuses :func:`crossing_matrix`
    on the cell centers, per polygon part, matching the per-polygon
    even-odd OR semantics for multipolygons."""
    boxes = np.asarray(boxes, np.float64)
    C = len(boxes)
    x0 = boxes[:, 0] - margin
    y0 = boxes[:, 1] - margin
    x1 = boxes[:, 2] + margin
    y1 = boxes[:, 3] + margin
    codes = np.zeros(C, np.int8)
    inside = np.zeros(C, bool)
    on_boundary = np.zeros(C, bool)
    cx = (x0 + x1) * 0.5
    cy = (y0 + y1) * 0.5
    for E in _poly_edges(g):
        ex1, ey1, ex2, ey2 = E[:, 0], E[:, 1], E[:, 2], E[:, 3]
        # SAT axis 1+2 (the box normals): segment bbox vs inflated box
        overlap = (
            (np.minimum(ex1, ex2)[None, :] <= x1[:, None])
            & (np.maximum(ex1, ex2)[None, :] >= x0[:, None])
            & (np.minimum(ey1, ey2)[None, :] <= y1[:, None])
            & (np.maximum(ey1, ey2)[None, :] >= y0[:, None])
        )
        # SAT axis 3 (the segment normal): all four box corners strictly
        # on one side of the segment's line => separated
        dx = (ex2 - ex1)[None, :]
        dy = (ey2 - ey1)[None, :]
        cross = [
            dx * (by[:, None] - ey1[None, :]) - dy * (bx[:, None] - ex1[None, :])
            for bx, by in ((x0, y0), (x1, y0), (x0, y1), (x1, y1))
        ]
        straddle = ~(
            np.all([c > 0 for c in cross], axis=0)
            | np.all([c < 0 for c in cross], axis=0)
        )
        on_boundary |= (overlap & straddle).any(axis=1)
        # even-odd insidedness of the cell center for THIS polygon part;
        # only meaningful for edge-free cells (the caller's margin makes
        # the whole cell share the center's verdict)
        crossings = crossing_matrix(cx, cy, ex1, ey1, ex2, ey2, np)
        inside |= (crossings.sum(axis=1) % 2) == 1
    codes[inside] = CELL_INTERIOR
    codes[on_boundary] = CELL_BOUNDARY
    return codes


# ---------------------------------------------------------------------------
# Pairwise point-point join predicates: the exact test the co-partitioned
# join runs on same-cell (+ boundary-strip) candidate pairs, and the NumPy
# brute force, in the same f32 arithmetic and op order.
# ---------------------------------------------------------------------------

#: pairwise predicate kinds
JOIN_BBOX, JOIN_DWITHIN = "bbox", "dwithin"
JOIN_DWITHIN_METERS = "dwithin_meters"

#: the kernels' predicate codes
_PRED_CODE = {JOIN_BBOX: 0, JOIN_DWITHIN: 1, JOIN_DWITHIN_METERS: 2}

#: mean earth radius (meters) — the haversine sphere every
#: ``dwithin_meters`` computation shares (IUGG mean radius R1)
EARTH_RADIUS_M = 6371008.8


def unit_vectors(lon, lat):
    """Points as f32 unit-sphere 3-vectors ``(ux, uy, uz)``. The trig
    runs ONCE, on the host, in f64 (then rounds to f32) — the kernels and
    the NumPy brute force consume these SAME f32 arrays, so the
    ``dwithin_meters`` predicate stays bit-identical: the pairwise test
    itself (:func:`pair_mask`) is pure exactly-rounded arithmetic
    (subtract/multiply/add/compare) on these vectors."""
    lam = np.deg2rad(np.asarray(lon, np.float64))
    phi = np.deg2rad(np.asarray(lat, np.float64))
    cphi = np.cos(phi)
    return (
        (cphi * np.cos(lam)).astype(np.float32),
        (cphi * np.sin(lam)).astype(np.float32),
        np.sin(phi).astype(np.float32),
    )


def pair_params(predicate: str, distance=None, dx=None, dy=None):
    """Canonical f32 parameter pair ``(p0, p1)`` for one predicate:
    ``bbox`` -> (dx, dy) half-widths; ``dwithin`` -> (d^2, 0) with the
    square computed in f32 on the host, so kernel and reference compare
    against the identical value; ``dwithin_meters`` -> (c^2, 0) where
    ``c = 2 sin(d / 2R)`` is the unit-sphere CHORD length of great-circle
    distance ``d`` meters — ``|u_l - u_r|^2 <= c^2`` is exactly the
    haversine ``<= d`` verdict, with the one trig evaluation on the host
    in f64 (rounded to f32 once, shared by kernel and reference)."""
    if predicate == JOIN_BBOX:
        if dx is None or dy is None:
            raise ValueError("bbox join needs dx and dy half-widths")
        return np.float32(dx), np.float32(dy)
    if predicate == JOIN_DWITHIN:
        if distance is None:
            raise ValueError("dwithin join needs a distance")
        d = np.float32(distance)
        return np.float32(d * d), np.float32(0.0)
    if predicate == JOIN_DWITHIN_METERS:
        if distance is None:
            raise ValueError("dwithin_meters join needs a distance "
                             "(meters)")
        half = min(float(distance) / (2.0 * EARTH_RADIUS_M), np.pi / 2)
        c = np.float32(2.0 * np.sin(half))  # chord of the antipode = 2
        return np.float32(c * c), np.float32(0.0)
    raise ValueError(f"unknown join predicate {predicate!r} "
                     f"(have: {JOIN_BBOX}, {JOIN_DWITHIN}, "
                     f"{JOIN_DWITHIN_METERS})")


def pair_mask(lx, ly, rx, ry, predicate: str, p0, p1, xp,
              lz=None, rz=None):
    """Pairwise predicate verdicts under broadcasting (f32, inclusive
    edges). ``bbox``: the two points' (p0, p1)-half-width envelopes
    intersect, i.e. |lx-rx| <= p0 and |ly-ry| <= p1. ``dwithin``: planar
    degree distance with p0 = d^2 (sum of squares, one compare, no sqrt).
    ``dwithin_meters``: haversine meters via the unit-sphere chord —
    operands are :func:`unit_vectors` components (x, y, z per side), p0 =
    chord^2 from :func:`pair_params`; trig-free here, so it wraps the
    antimeridian and the poles for free."""
    if xp is np:
        f32 = lambda a: a.astype(np.float32)  # noqa: E731
    else:
        f32 = lambda a: a.to(torch.float32)  # noqa: E731
        p0, p1 = float(p0), float(p1)  # f32 values; compared at f32
    ddx = f32(lx) - f32(rx)
    ddy = f32(ly) - f32(ry)
    if predicate == JOIN_BBOX:
        return (xp.abs(ddx) <= p0) & (xp.abs(ddy) <= p1)
    if predicate == JOIN_DWITHIN:
        return ddx * ddx + ddy * ddy <= p0
    if predicate == JOIN_DWITHIN_METERS:
        if lz is None or rz is None:
            raise ValueError("dwithin_meters needs unit-vector z "
                             "operands (lz, rz)")
        ddz = f32(lz) - f32(rz)
        return ddx * ddx + ddy * ddy + ddz * ddz <= p0
    raise ValueError(f"unknown join predicate {predicate!r}")


def brute_force_pairs(lx, ly, rx, ry, predicate: str, p0, p1,
                      chunk: int = 4096, lz=None, rz=None):
    """The naive N*M reference (numpy, chunked): matched (left, right)
    row-index pairs in row-major order — int64 [K, 2]. For
    ``dwithin_meters``, pass the sides' :func:`unit_vectors` components as
    (lx, ly, lz) / (rx, ry, rz)."""
    lx = np.asarray(lx, np.float32)
    ly = np.asarray(ly, np.float32)
    rx = np.asarray(rx, np.float32)
    ry = np.asarray(ry, np.float32)
    lz = None if lz is None else np.asarray(lz, np.float32)
    rz = None if rz is None else np.asarray(rz, np.float32)
    out = []
    for lo in range(0, len(lx), chunk):
        hi = min(lo + chunk, len(lx))
        m = pair_mask(
            lx[lo:hi, None], ly[lo:hi, None], rx[None, :], ry[None, :],
            predicate, p0, p1, np,
            lz=None if lz is None else lz[lo:hi, None],
            rz=None if rz is None else rz[None, :],
        )
        li, rj = np.nonzero(m)
        if len(li):
            out.append(np.stack([li.astype(np.int64) + lo,
                                 rj.astype(np.int64)], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out, axis=0)


# ---------------------------------------------------------------------------
# Polygon-dataset join predicates: one side of the join is a POLYGON
# schema. Same contract as pair_mask.
# ---------------------------------------------------------------------------

#: polygon-side predicate kinds: ``pip`` — the point's even-odd crossing
#: parity against the row's (multi)polygon (holes ride their polygon's
#: parity; multipolygon parts OR) — and ``poly_bbox`` — the point lies in
#: the row's bounds (inclusive edges)
JOIN_PIP, JOIN_POLY_BBOX = "pip", "poly_bbox"
POLYGON_PREDICATES = (JOIN_PIP, JOIN_POLY_BBOX)


def polygon_tables(geoms, pad_edges=None, pad_parts=None, pad_rows=None):
    """Flattened f32 tables for a polygon join side (one (multi)polygon
    per right row): ``x1/y1/x2/y2`` [E] ring segments (shells AND holes —
    parity per part handles holes), int32 ``part_id`` [E] (flat part per
    edge; a part is one Polygon with its holes), int32 ``part_row`` [Pf]
    (right row per flat part), f32 ``boxes`` [R, 4] per-row bounds, plus
    the static counts. Optional pow2 padding for the bucketed kernel:
    padded edges are degenerate (1e30 — never straddle), padded parts map
    to row 0 with no edges (parity never true), padded rows carry
    impossible boxes (min > max)."""
    from geomesa_tpu_torch.utils import geometry as geo

    x1s, y1s, x2s, y2s, pids = [], [], [], [], []
    part_rows: "list[int]" = []
    boxes = []
    for j, g in enumerate(geoms):
        boxes.append(g.bounds())
        polys = g.polygons if isinstance(g, geo.MultiPolygon) else (g,)
        for p in polys:
            pid = len(part_rows)
            part_rows.append(j)
            for r in p.rings():
                x1s.append(r[:-1, 0]); y1s.append(r[:-1, 1])
                x2s.append(r[1:, 0]); y2s.append(r[1:, 1])
                pids.append(np.full(len(r) - 1, pid, np.int32))
    t = {
        "x1": np.concatenate(x1s).astype(np.float32),
        "y1": np.concatenate(y1s).astype(np.float32),
        "x2": np.concatenate(x2s).astype(np.float32),
        "y2": np.concatenate(y2s).astype(np.float32),
        "part_id": np.concatenate(pids),
        "part_row": np.asarray(part_rows, np.int32),
        "boxes": np.asarray(boxes, np.float32),
        "n_edges": len(np.concatenate(pids)),
        "n_parts": len(part_rows),
        "n_rows": len(geoms),
    }
    e, pf, r = t["n_edges"], t["n_parts"], t["n_rows"]
    ep = max(pad_edges or e, e)
    pp = max(pad_parts or pf, pf)
    rp = max(pad_rows or r, r)
    if ep > e:
        for k in ("x1", "y1", "x2", "y2"):
            t[k] = np.concatenate([t[k], np.full(ep - e, 1e30, np.float32)])
        t["part_id"] = np.concatenate(
            [t["part_id"], np.zeros(ep - e, np.int32)])
    if pp > pf:
        t["part_row"] = np.concatenate(
            [t["part_row"], np.zeros(pp - pf, np.int32)])
    if rp > r:
        dead = np.empty((rp - r, 4), np.float32)
        dead[:, :2], dead[:, 2:] = 1e30, -1e30
        t["boxes"] = np.concatenate([t["boxes"], dead])
    t["n_parts_padded"], t["n_rows_padded"] = pp, rp
    return t


def polygon_mask(px, py, t, predicate: str, xp):
    """[N, R] polygon-join verdict matrix (f32). ``pip``: per-part
    even-odd crossing parity via :func:`crossing_matrix`, OR over each
    row's parts (a polygon's holes share its part, so parity subtracts
    them). ``poly_bbox``: inclusive-edge containment in the row's f32
    bounds. Pure exactly-rounded f32 arithmetic on the shared tables — the
    same function IS the brute-force reference."""
    if xp is np:
        px = px.astype(xp.float32)
        py = py.astype(xp.float32)
    else:
        px = px.to(torch.float32)
        py = py.to(torch.float32)
    if predicate == JOIN_POLY_BBOX:
        b = t["boxes"]
        return (
            (px[:, None] >= b[None, :, 0]) & (py[:, None] >= b[None, :, 1])
            & (px[:, None] <= b[None, :, 2]) & (py[:, None] <= b[None, :, 3])
        )
    if predicate != JOIN_PIP:
        raise ValueError(f"unknown polygon join predicate {predicate!r}")
    P = int(t["n_parts_padded"])
    R = int(t["n_rows_padded"])
    if xp is np:
        cross = crossing_matrix(
            px, py, t["x1"], t["y1"], t["x2"], t["y2"], xp
        ).astype(xp.int32)  # [N, E]
        counts = np.zeros((P, cross.shape[0]), np.int32)
        np.add.at(counts, t["part_id"], cross.T)
        inside = (counts % 2) == 1  # [P, N]
        hits = np.zeros((R, cross.shape[0]), np.int32)
        np.add.at(hits, t["part_row"], inside.astype(np.int32))
        return (hits > 0).T  # [N, R]
    out = torch.empty((px.numel(), R), dtype=torch.bool, device=px.device)
    part_id = t["part_id"].to(torch.int64)
    part_row = t["part_row"].to(torch.int64)
    for lo, hi in _chunks(px.numel(), int(part_id.numel())):
        cross = crossing_matrix(px[lo:hi], py[lo:hi], t["x1"], t["y1"],
                                t["x2"], t["y2"], torch).to(torch.int32)
        counts = torch.zeros((P, hi - lo), dtype=torch.int32, device=px.device)
        counts.index_add_(0, part_id, cross.T)
        inside = ((counts % 2) == 1).to(torch.int32)
        hits = torch.zeros((R, hi - lo), dtype=torch.int32, device=px.device)
        hits.index_add_(0, part_row, inside)
        out[lo:hi] = (hits > 0).T
    return out


def polygon_brute_force(px, py, geoms, predicate: str, chunk: int = 2048):
    """The naive N*M polygon-join reference (numpy, chunked): matched
    (point, right-row) pairs in row-major order — int64 [K, 2], from the
    same :func:`polygon_mask` on the same tables."""
    t = polygon_tables(geoms)
    px = np.asarray(px, np.float32)
    py = np.asarray(py, np.float32)
    out = []
    for lo in range(0, len(px), chunk):
        hi = min(lo + chunk, len(px))
        m = polygon_mask(px[lo:hi], py[lo:hi], t, predicate, np)
        li, rj = np.nonzero(m)
        if len(li):
            out.append(np.stack([li.astype(np.int64) + lo,
                                 rj.astype(np.int64)], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out, axis=0)


def pip_counts(px, py, mask, edges, weights, xp):
    """Per-polygon masked point (or weight) totals: float32 [P]."""
    P = int(edges["n_polys"])
    assign = pip_assign(px, py, mask, edges, xp)
    if xp is np:
        w = (
            weights.reshape(-1).astype(xp.float32)
            if weights is not None
            else xp.ones_like(assign, dtype=xp.float32)
        )
        w = xp.where(assign >= 0, w, 0.0)
        seg = xp.clip(assign, 0, P - 1)
        out = np.zeros(P, np.float32)
        np.add.at(out, seg, w)
        return out
    w = (weights.reshape(-1).to(torch.float32) if weights is not None
         else torch.ones(assign.shape, dtype=torch.float32, device=assign.device))
    w = torch.where(assign >= 0, w, 0.0)
    seg = torch.clamp(assign, 0, P - 1).to(torch.int64)
    return torch.zeros(P, dtype=torch.float32, device=assign.device).index_add_(0, seg, w)


# ---------------------------------------------------------------------------
# Device tables and the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

def _grouped(ids: np.ndarray) -> bool:
    """Whether ``ids`` never decrease: each id's entries are one run, and
    the runs ascend."""
    ids = np.asarray(ids)
    return bool(len(ids) < 2 or (np.diff(ids) >= 0).all())


def edge_tensors(edges, device) -> dict:
    """``pip_assign``'s edge dict (f32 x1/y1/x2/y2, int32 poly_id,
    n_polys) as tensors on ``device``, with the real edge count, after
    checking that the edges are grouped by polygon in ascending id order,
    as ``utils/geometry.polygon_edge_buffers`` appends them."""
    pid = np.asarray(edges["poly_id"], np.int32)
    if not _grouped(pid):
        raise ValueError("pip_assign edges are not grouped by polygon")
    out = {"n_polys": int(edges["n_polys"]), "n_edges": len(pid), "grouped": True}
    for k in ("x1", "y1", "x2", "y2"):
        out[k] = torch.from_numpy(np.ascontiguousarray(edges[k], np.float32)).to(device)
    out["poly_id"] = torch.from_numpy(np.ascontiguousarray(pid)).to(device)
    return out


def table_tensors(t, device) -> dict:
    """:func:`polygon_tables` output as tensors on ``device`` (the static
    counts kept), after checking that its real edges are grouped by part
    in ascending order, as :func:`polygon_tables` appends them."""
    if not _grouped(t["part_id"][: t["n_edges"]]):
        raise ValueError("polygon table edges are not grouped by part")
    out = {k: v for k, v in t.items() if not isinstance(v, np.ndarray)}
    for k in ("x1", "y1", "x2", "y2", "part_id", "part_row", "boxes"):
        out[k] = torch.from_numpy(np.ascontiguousarray(t[k])).to(device)
    out["grouped"] = True
    return out


def _bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.gm_pair_tiles_launch.restype = i32
    lib.gm_pair_tiles_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, f32, f32, vp, vp, vp]
    lib.gm_pair_flat_launch.restype = i32
    lib.gm_pair_flat_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i64, i32, f32, f32, vp, vp, vp]
    lib.gm_polygon_verdict_launch.restype = i32
    lib.gm_polygon_verdict_launch.argtypes = [
        vp, vp, i64, vp, vp, vp, vp, vp, vp, i32, vp, i32, i32, vp, vp]
    lib.gm_pip_assign_launch.restype = i32
    lib.gm_pip_assign_launch.argtypes = [
        vp, vp, vp, i64, vp, vp, vp, vp, vp, i32, vp, vp]


def _check_cuda(what: str, *tensors, dtypes=None) -> torch.device:
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what}: tensors must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{what}: operand {i} is {t.dtype}, wants {dtypes[i]}")
    return dev


def _ptr(t):
    return None if t is None else t.data_ptr()


def pair_tiles_plain(lxb, lyb, rxb, ryb, lval, rval, predicate: str, p0, p1,
                     want_mask: bool = True, lzb=None, rzb=None):
    """The ``pair_tiles`` kernel's function in plain PyTorch: the
    broadcast :func:`pair_mask` over [C, Bp, Pp], the valid-row masks, and
    an int32 count per tile, chunked over tiles."""
    C, Bp = lxb.shape
    Pp = rxb.shape[1]
    iota_b = torch.arange(Bp, dtype=torch.int32, device=lxb.device)[None, :, None]
    iota_p = torch.arange(Pp, dtype=torch.int32, device=lxb.device)[None, None, :]
    mask = torch.empty((C, Bp, Pp), dtype=torch.bool, device=lxb.device)
    counts = torch.empty(C, dtype=torch.int32, device=lxb.device)
    step = max(1, _PLAIN_ELEMS // max(Bp * Pp, 1))
    for lo in range(0, C, step):  # chunks of tiles bound the intermediates
        s = slice(lo, lo + step)
        m = pair_mask(lxb[s, :, None], lyb[s, :, None], rxb[s, None, :], ryb[s, None, :],
                      predicate, p0, p1, torch,
                      lz=None if lzb is None else lzb[s, :, None],
                      rz=None if rzb is None else rzb[s, None, :])
        m = m & (iota_b < lval[s, None, None]) & (iota_p < rval[s, None, None])
        mask[s] = m
        counts[s] = m.sum(dim=(1, 2), dtype=torch.int32)
    return (mask if want_mask else None), counts


def pair_tiles(lxb, lyb, rxb, ryb, lval, rval, predicate: str, p0, p1,
               want_mask: bool = True, lzb=None, rzb=None):
    """Pair verdicts of padded tiles: ``(mask, counts)``, bool
    [C, Bp, Pp] (None unless ``want_mask``) and int32 [C]. ``lxb``/``lyb``
    are [C, Bp] f32 left blocks, ``rxb``/``ryb`` [C, Pp] right blocks,
    ``lval``/``rval`` [C] int32 valid rows; ``dwithin_meters`` takes the
    unit vectors' z blocks ``lzb``/``rzb``. CPU tensors take
    :func:`pair_tiles_plain`; CUDA tensors launch the kernel, which
    writes only the counts when no mask is wanted."""
    if lxb.device.type == "cpu":
        return pair_tiles_plain(lxb, lyb, rxb, ryb, lval, rval, predicate, p0, p1,
                                want_mask, lzb, rzb)
    if lxb.device.type != "cuda":
        raise ValueError(f"pair_tiles: unsupported device {lxb.device}")
    meters = predicate == JOIN_DWITHIN_METERS
    if predicate not in _PRED_CODE:
        raise ValueError(f"unknown join predicate {predicate!r}")
    if meters != (lzb is not None and rzb is not None):
        raise ValueError("pair_tiles: z blocks go with dwithin_meters alone")
    f, i = torch.float32, torch.int32
    dev = _check_cuda("pair_tiles", lxb, lyb, rxb, ryb, lval, rval, lzb, rzb,
                      dtypes=(f, f, f, f, i, i, f, f))
    if lxb.dim() != 2 or rxb.dim() != 2 or lyb.shape != lxb.shape \
            or ryb.shape != rxb.shape or lxb.shape[0] != rxb.shape[0] \
            or lval.shape != (lxb.shape[0],) or rval.shape != (lxb.shape[0],) \
            or (meters and (lzb.shape != lxb.shape or rzb.shape != rxb.shape)):
        raise ValueError(f"pair_tiles shapes: left {tuple(lxb.shape)}, "
                         f"right {tuple(rxb.shape)}, valid {tuple(lval.shape)}")
    C, Bp = lxb.shape
    Pp = rxb.shape[1]
    lib = _build.load("join", _bind)
    counts = torch.empty(C, dtype=torch.int32, device=dev)
    mask = torch.empty((C, Bp, Pp), dtype=torch.bool, device=dev) if want_mask else None
    if C:
        rc = lib.gm_pair_tiles_launch(
            lxb.data_ptr(), lyb.data_ptr(), _ptr(lzb), rxb.data_ptr(), ryb.data_ptr(),
            _ptr(rzb), lval.data_ptr(), rval.data_ptr(), C, Bp, Pp,
            _PRED_CODE[predicate], float(p0), float(p1), _ptr(mask), counts.data_ptr(),
            _build.stream_handle(dev))
        _build.check(rc, "pair_tiles kernel")
        launches["pair_tiles"] += 1
    return mask, counts


def pair_flat_plain(lxv, lyv, rxv, ryv, kvalid: int, predicate: str, p0, p1,
                    want_mask: bool = True, lzv=None, rzv=None):
    """The ``pair_flat`` kernel's function in plain PyTorch: the
    elementwise :func:`pair_mask` of the first ``kvalid`` slots and its
    count (an int32 tensor of one element)."""
    m = pair_mask(lxv, lyv, rxv, ryv, predicate, p0, p1, torch, lz=lzv, rz=rzv)
    m = m & (torch.arange(lxv.numel(), dtype=torch.int32, device=lxv.device) < kvalid)
    return (m if want_mask else None), m.sum(dtype=torch.int32).reshape(1)


def pair_flat(lxv, lyv, rxv, ryv, kvalid: int, predicate: str, p0, p1,
              want_mask: bool = True, lzv=None, rzv=None):
    """Pair verdicts of a flat candidate list: ``(mask, count)``, bool
    [Kp] (None unless ``want_mask``) and int32 [1], of the f32 [Kp]
    gathered sides, of which the first ``kvalid`` slots are real. CPU
    tensors take :func:`pair_flat_plain`; CUDA tensors launch the
    kernel."""
    if lxv.device.type == "cpu":
        return pair_flat_plain(lxv, lyv, rxv, ryv, kvalid, predicate, p0, p1,
                               want_mask, lzv, rzv)
    if lxv.device.type != "cuda":
        raise ValueError(f"pair_flat: unsupported device {lxv.device}")
    meters = predicate == JOIN_DWITHIN_METERS
    if predicate not in _PRED_CODE:
        raise ValueError(f"unknown join predicate {predicate!r}")
    if meters != (lzv is not None and rzv is not None):
        raise ValueError("pair_flat: z operands go with dwithin_meters alone")
    f = torch.float32
    dev = _check_cuda("pair_flat", lxv, lyv, rxv, ryv, lzv, rzv, dtypes=(f,) * 6)
    kp = lxv.numel()
    if any(t is not None and t.shape != (kp,) for t in (lxv, lyv, rxv, ryv, lzv, rzv)):
        raise ValueError(f"pair_flat takes 1-D operands of one length, got {tuple(lxv.shape)}")
    if not 0 <= int(kvalid) <= kp:
        raise ValueError(f"kvalid {kvalid} outside [0, {kp}]")
    lib = _build.load("join", _bind)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    mask = torch.empty(kp, dtype=torch.bool, device=dev) if want_mask else None
    if kp:
        rc = lib.gm_pair_flat_launch(
            lxv.data_ptr(), lyv.data_ptr(), _ptr(lzv), rxv.data_ptr(), ryv.data_ptr(),
            _ptr(rzv), kp, int(kvalid), _PRED_CODE[predicate], float(p0), float(p1),
            _ptr(mask), count.data_ptr(), _build.stream_handle(dev))
        _build.check(rc, "pair_flat kernel")
        launches["pair_flat"] += 1
    return mask, count


def polygon_verdict_plain(pxv, pyv, tables, predicate: str):
    """The ``polygon_verdict`` kernel's function in plain PyTorch:
    :func:`polygon_mask` over the tables' tensors, chunked over points."""
    return polygon_mask(pxv, pyv, tables, predicate, torch)


def polygon_verdict(pxv, pyv, tables, predicate: str):
    """[Np, Rp] bool verdicts of f32 points ``pxv``/``pyv`` [Np] against
    the padded polygon tables (:func:`table_tensors`). CPU tensors take
    :func:`polygon_verdict_plain`; CUDA tensors launch the kernel, which
    walks only the real edges."""
    if pxv.device.type == "cpu":
        return polygon_verdict_plain(pxv, pyv, tables, predicate)
    if pxv.device.type != "cuda":
        raise ValueError(f"polygon_verdict: unsupported device {pxv.device}")
    if predicate not in POLYGON_PREDICATES:
        raise ValueError(f"unknown polygon join predicate {predicate!r}")
    if not tables.get("grouped"):
        raise ValueError("polygon_verdict takes tables made by table_tensors")
    f, i = torch.float32, torch.int32
    t = tables
    dev = _check_cuda("polygon_verdict", pxv, pyv, t["x1"], t["y1"], t["x2"], t["y2"],
                      t["part_id"], t["part_row"], t["boxes"],
                      dtypes=(f, f, f, f, f, f, i, i, f))
    n = pxv.numel()
    rp = int(t["n_rows_padded"])
    if pyv.shape != pxv.shape or pxv.dim() != 1 or t["boxes"].shape != (rp, 4) \
            or int(t["n_edges"]) > t["x1"].numel():
        raise ValueError("polygon_verdict shapes")
    lib = _build.load("join", _bind)
    out = torch.zeros((n, rp), dtype=torch.bool, device=dev)
    if n:
        rc = lib.gm_polygon_verdict_launch(
            pxv.data_ptr(), pyv.data_ptr(), n, t["x1"].data_ptr(), t["y1"].data_ptr(),
            t["x2"].data_ptr(), t["y2"].data_ptr(), t["part_id"].data_ptr(),
            t["part_row"].data_ptr(), int(t["n_edges"]), t["boxes"].data_ptr(), rp,
            0 if predicate == JOIN_PIP else 1, out.data_ptr(), _build.stream_handle(dev))
        _build.check(rc, "polygon_verdict kernel")
        launches["polygon_verdict"] += 1
    return out


def _pip_assign_kernel(px, py, mask, edges):
    """``pip_assign`` on CUDA tensors: the kernel over every point of
    ``px``'s shape (``edges`` from :func:`edge_tensors`)."""
    if not edges.get("grouped"):
        raise ValueError("pip_assign on the card takes edges made by edge_tensors")
    f = torch.float32
    pxf, pyf, mf = px.reshape(-1), py.reshape(-1), mask.reshape(-1)
    dev = _check_cuda("pip_assign", pxf, pyf, mf, edges["x1"], edges["y1"], edges["x2"],
                      edges["y2"], edges["poly_id"],
                      dtypes=(f, f, torch.bool, f, f, f, f, torch.int32))
    n = pxf.numel()
    if pyf.numel() != n or mf.numel() != n:
        raise ValueError("pip_assign: points and mask differ in size")
    lib = _build.load("join", _bind)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        rc = lib.gm_pip_assign_launch(
            pxf.data_ptr(), pyf.data_ptr(), mf.data_ptr(), n, edges["x1"].data_ptr(),
            edges["y1"].data_ptr(), edges["x2"].data_ptr(), edges["y2"].data_ptr(),
            edges["poly_id"].data_ptr(), int(edges["n_edges"]), out.data_ptr(),
            _build.stream_handle(dev))
        _build.check(rc, "pip_assign kernel")
        launches["pip_assign"] += 1
    return out
