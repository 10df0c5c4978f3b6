"""The cell family of the lon/lat grid and the aggregate cache's
partial-cover decomposition: a query box -> SFC cells + boundary strips,
a polygon region -> interior cells + boundary cells.

Copy of ``geomesa_tpu/cache/cells.py``. A cell at ``level`` is one of the
2^level x 2^level half-open boxes ``[x0, x1) x [y0, y1)``, identified by
its z2 curve prefix (``curves/zorder.interleave2(ix, iy)``), so cell keys
are absolute: a panned query derives the same cell ids for the overlap
and pays only for the newly exposed strip.

Exactness (what lets cached and fresh partials merge bit-identically with
a whole scan):

* cells are half-open, realized as closed boxes with their open edges
  pulled one f64 ulp inward, so the cells of a level partition the plane
  and no row is counted twice or dropped;
* the cell edges ``i * (360 / 2^level) - 180`` are exact in f64, so every
  query derives byte-identical cell boxes;
* interior cells satisfy ``[x0, x1) x [y0, y1) ⊆ Q`` by direct f64
  comparison against the query box, so a cell query (residual ∧ cell box)
  returns exactly the query's rows inside that cell;
* the rest of Q is covered by at most four disjoint strips.

Decomposition applies when the schema's geometry is a POINT and the
filter constrains it with exactly one BBox conjunct at the top level (the
pan / zoom shape). Extent geometries (a feature straddling cells would
count once per cell), spatial predicates under OR / NOT and several boxes
fall back to whole-result caching.

Polygon-region queries (one INTERSECTS / WITHIN polygon-literal conjunct
on a point column) decompose by :func:`decompose_region`: the covering
cells classify against the polygon (``kernels/join.classify_cells``) into
interior cells (served from the same cell entries box queries fill: the
polygon conjunct is a tautology over them), boundary cells (scanned under
the original polygon predicate, through the same kernel an undecomposed
query runs) and outside cells (nothing).

The last cell column and row close at exactly 180 / 90, so the cells of
a level partition the whole domain, and a domain-spanning zoom-out
decomposes with no strips: a warm one launches nothing on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.zorder import interleave2
from geomesa_tpu_torch.filter import ir

Box = Tuple[float, float, float, float]

#: cell-vs-polygon classification margin (degrees): a cell is INTERIOR or
#: OUTSIDE only when the verdict holds with this much room, so the f32
#: near-edge uncertainty of the point-in-polygon test plus f32 coordinate
#: rounding can never flip a row the classification already committed;
#: near-edge rows land in BOUNDARY cells and decide through the exact test
CLASSIFY_MARGIN = 1e-3

#: polygon ops decomposable for POINT columns: the predicate is constant
#: over any cell that clears the margin
_REGION_OPS = ("intersects", "within")


def _has_spatial(node: ir.Filter, geom: str) -> bool:
    """Does this subtree constrain (or mention) the geometry?"""
    if isinstance(node, (ir.BBox, ir.Spatial, ir.DWithin)):
        return node.prop == geom
    if isinstance(node, (ir.And, ir.Or)):
        return any(_has_spatial(c, geom) for c in node.children)
    if isinstance(node, ir.Not):
        return _has_spatial(node.child, geom)
    if isinstance(node, ir.ExprCompare):
        return geom in node.props()
    return getattr(node, "prop", None) == geom


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
    """A cell's z2 curve prefix: its identity on the curve, and the key of
    the hierarchy's child / parent lookups. A Python int, so cache keys
    stay literal-evaluable."""
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


@dataclass
class _CellCover:
    """A partial-cover plan: the interior cells (served from and stored
    into the cache, and assembled by the hierarchy) and the residual
    filter every cell query ANDs with."""

    level: int
    #: the filter without its spatial conjunct
    residual: ir.Filter
    #: canonical text of the residual, part of every cell key
    residual_key: str
    #: interior cell ids, absolute (ix, iy) at ``level``
    cells: List[Tuple[int, int]]
    #: (ix, iy) -> the closed box realizing the half-open cell
    cell_boxes: Dict[Tuple[int, int], Box]

    def cell_filter(self, cell: Tuple[int, int], geom: str) -> ir.Filter:
        return _and(self.residual, ir.BBox(geom, *self.cell_boxes[cell]))

    def cell_prefix(self, cell: Tuple[int, int]) -> int:
        return cell_prefix(self.level, cell)


@dataclass
class Decomposition(_CellCover):
    """One box query's partial-cover plan."""

    #: boundary strips (closed, disjoint, covering Q minus the interior)
    strips: List[Box]
    kind: str = "bbox"

    def strip_filter(self, geom: str) -> Optional[ir.Filter]:
        if not self.strips:
            return None
        boxes = tuple(ir.BBox(geom, *s) for s in self.strips)
        spatial = boxes[0] if len(boxes) == 1 else ir.Or(boxes)
        return _and(self.residual, spatial)

    #: the residual scan, named alike on both decomposition kinds
    residual_scan_filter = strip_filter

    def residual_count(self) -> int:
        return len(self.strips)


@dataclass
class RegionDecomposition(_CellCover):
    """One polygon query's partial-cover plan: interior cells and the
    boundary cells scanned under the original polygon predicate."""

    #: the polygon conjunct, verbatim (op + literal)
    spatial: ir.Filter = None  # type: ignore[assignment]
    #: boundary cell ids at ``level``
    boundary: List[Tuple[int, int]] = None  # type: ignore[assignment]
    #: disjoint closed boxes covering exactly the boundary cells (adjacent
    #: cells of a row merged into runs)
    boundary_boxes: List[Box] = None  # type: ignore[assignment]
    kind: str = "polygon"

    def residual_scan_filter(self, geom: str) -> Optional[ir.Filter]:
        """residual ∧ polygon ∧ (boundary-cell cover): the polygon
        predicate runs through the kernel an undecomposed query compiles
        to, so boundary rows decide identically."""
        if not self.boundary_boxes:
            return None
        boxes = tuple(ir.BBox(geom, *b) for b in self.boundary_boxes)
        cover = boxes[0] if len(boxes) == 1 else ir.Or(boxes)
        return _and(_and(self.residual, self.spatial), cover)

    def residual_count(self) -> int:
        return len(self.boundary)


def _and(residual: ir.Filter, spatial: ir.Filter) -> ir.Filter:
    if isinstance(residual, ir.Include):
        return spatial
    return ir.And((residual, spatial))


def _split(f: ir.Filter, geom: str, pick) -> Optional[Tuple[ir.Filter, ir.Filter]]:
    """(the one top-level conjunct ``pick`` selects, the residual), or
    None when there is not exactly one or another conjunct constrains the
    geometry."""
    conjuncts = list(f.children) if isinstance(f, ir.And) else [f]
    chosen = [c for c in conjuncts if pick(c)]
    if len(chosen) != 1:
        return None
    rest = [c for c in conjuncts if c is not chosen[0]]
    if any(_has_spatial(c, geom) for c in rest):
        return None
    if not rest:
        residual: ir.Filter = ir.Include()
    elif len(rest) == 1:
        residual = rest[0]
    else:
        residual = ir.And(tuple(rest))
    return chosen[0], residual


def split_bbox_conjunct(
    f: ir.Filter, geom: Optional[str]
) -> Optional[Tuple[ir.BBox, ir.Filter]]:
    """(bbox, residual) when the filter is ``BBOX ∧ rest`` with exactly one
    spatial constraint, all at top level; None otherwise."""
    if geom is None:
        return None
    return _split(f, geom, lambda c: isinstance(c, ir.BBox) and c.prop == geom)


def _pick_level(dx: float, dy: float) -> Optional[int]:
    per_axis = config.CACHE_CELLS_PER_AXIS.to_int() or 8
    max_level = config.CACHE_MAX_LEVEL.to_int() or 12
    if dx <= 0 or dy <= 0:
        return None
    # the finest level where the box spans at most per_axis cells an axis
    lx = int(np.floor(np.log2(per_axis * 360.0 / dx)))
    ly = int(np.floor(np.log2(per_axis * 180.0 / dy)))
    level = min(lx, ly, max_level)
    return level if level >= 1 else None


def _in_domain(xmin, ymin, xmax, ymax) -> bool:
    return bool(np.isfinite([xmin, ymin, xmax, ymax]).all()
                and -180.0 <= xmin <= xmax <= 180.0
                and -90.0 <= ymin <= ymax <= 90.0)


def _point_geom(ft) -> Optional[str]:
    """The schema's geometry field when it is a point column, else None
    (an extent feature straddles cells)."""
    geom = None if ft is None else ft.geom_field
    if geom is None or not ft.attr(geom).is_point:
        return None
    return geom


def decompose(f: ir.Filter, ft) -> Optional[Decomposition]:
    """Partial-cover plan of a filter against schema ``ft``, or None when
    it does not decompose."""
    geom = _point_geom(ft)
    if geom is None:
        return None
    split = split_bbox_conjunct(f, geom)
    if split is None:
        return None
    box, residual = split
    xmin, ymin, xmax, ymax = box.xmin, box.ymin, box.xmax, box.ymax
    if not _in_domain(xmin, ymin, xmax, ymax):
        return None
    level = _pick_level(xmax - xmin, ymax - ymin)
    if level is None:
        return None
    n = 1 << level
    sx = 360.0 / n  # 45 * 2^(3-level): exact in f64
    sy = 180.0 / n

    def xedge(i: int) -> float:
        return i * sx - 180.0

    def yedge(i: int) -> float:
        return i * sy - 90.0

    # interior cells: [edge(i), edge(i+1)) ⊆ [min, max] by f64 comparison
    ix_lo = max(0, int(np.floor((xmin + 180.0) / sx)))
    ix_hi = min(n - 1, int(np.ceil((xmax + 180.0) / sx)))
    iy_lo = max(0, int(np.floor((ymin + 90.0) / sy)))
    iy_hi = min(n - 1, int(np.ceil((ymax + 90.0) / sy)))
    xs = [i for i in range(ix_lo, ix_hi + 1)
          if xedge(i) >= xmin and xedge(i + 1) <= xmax]
    ys = [i for i in range(iy_lo, iy_hi + 1)
          if yedge(i) >= ymin and yedge(i + 1) <= ymax]
    if not xs or not ys:
        return None
    max_cells = config.CACHE_MAX_CELLS.to_int() or 256
    if len(xs) * len(ys) > max_cells:
        return None
    # the interior index ranges are contiguous by construction
    X0, X1 = xedge(xs[0]), xedge(xs[-1] + 1)
    Y0, Y1 = yedge(ys[0]), yedge(ys[-1] + 1)

    cells: List[Tuple[int, int]] = []
    boxes: Dict[Tuple[int, int], Box] = {}
    for iy in ys:
        for ix in xs:
            cells.append((ix, iy))
            boxes[(ix, iy)] = cell_box(level, ix, iy)

    # Q minus the interior as disjoint closed strips. The right strip holds
    # the rows at exactly x == X1 (the interior's open edge) even when
    # X1 == xmax, except when the interior reaches the domain-edge column,
    # whose cells close at x == 180 (likewise the top strip at y == 90).
    right_closed = xs[-1] == n - 1
    top_closed = ys[-1] == n - 1
    ix_hi_edge = 180.0 if right_closed else _prev(X1)
    strips: List[Box] = []
    if xmin < X0:
        strips.append((xmin, ymin, _prev(X0), ymax))          # left
    if not right_closed:
        strips.append((X1, ymin, xmax, ymax))                 # right
    if ymin < Y0:
        strips.append((X0, ymin, ix_hi_edge, _prev(Y0)))      # bottom
    if not top_closed:
        strips.append((X0, Y1, ix_hi_edge, ymax))             # top
    strips = [s for s in strips if s[0] <= s[2] and s[1] <= s[3]]

    return Decomposition(
        level=level, residual=residual, residual_key=repr(residual),
        cells=cells, cell_boxes=boxes, strips=strips,
    )


def split_region_conjunct(
    f: ir.Filter, geom: Optional[str]
) -> Optional[Tuple[ir.Spatial, ir.Filter]]:
    """(polygon conjunct, residual) when the filter is ``SPATIAL ∧ rest``
    with exactly one spatial constraint, an INTERSECTS / WITHIN of a
    (multi)polygon literal, at top level; None otherwise."""
    from geomesa_tpu_torch.utils import geometry as geo

    if geom is None:
        return None
    return _split(f, geom, lambda c: (
        isinstance(c, ir.Spatial) and c.prop == geom and c.op in _REGION_OPS
        and isinstance(c.geom, (geo.Polygon, geo.MultiPolygon))))


def _merge_runs(level: int, boundary: List[Tuple[int, int]]) -> List[Box]:
    """Disjoint closed boxes covering exactly the boundary cells: the
    consecutive cells of a row merge into one rectangle, so the residual
    scan's OR stays small."""
    by_row: Dict[int, List[int]] = {}
    for ix, iy in boundary:
        by_row.setdefault(iy, []).append(ix)
    out: List[Box] = []
    for iy in sorted(by_row):
        xs = sorted(by_row[iy])
        lo = prev = xs[0]
        for ix in xs[1:] + [None]:  # type: ignore[list-item]
            if ix is not None and ix == prev + 1:
                prev = ix
                continue
            b0 = cell_box(level, lo, iy)
            b1 = cell_box(level, prev, iy)
            out.append((b0[0], b0[1], b1[2], b1[3]))
            if ix is not None:
                lo = prev = ix
    return out


def decompose_region(f: ir.Filter, ft) -> Optional[RegionDecomposition]:
    """Polygon partial-cover plan: interior cells (sharing cell keys with
    box decompositions of the same residual) and boundary cells (scanned
    under the polygon predicate), or None when it does not decompose."""
    if not config.CACHE_POLYGON.to_bool():
        return None
    geom = _point_geom(ft)
    if geom is None:
        return None
    split = split_region_conjunct(f, geom)
    if split is None:
        return None
    spatial, residual = split
    xmin, ymin, xmax, ymax = spatial.geom.bounds()
    if not _in_domain(xmin, ymin, xmax, ymax):
        return None
    level = _pick_level(xmax - xmin, ymax - ymin)
    if level is None:
        return None
    n = 1 << level
    sx, sy = 360.0 / n, 180.0 / n
    ix_lo = max(0, int(np.floor((xmin + 180.0) / sx)))
    ix_hi = min(n - 1, int(np.floor((xmax + 180.0) / sx)))
    iy_lo = max(0, int(np.floor((ymin + 90.0) / sy)))
    iy_hi = min(n - 1, int(np.floor((ymax + 90.0) / sy)))
    max_cells = config.CACHE_MAX_CELLS.to_int() or 256
    if (ix_hi - ix_lo + 1) * (iy_hi - iy_lo + 1) > max_cells:
        return None

    from geomesa_tpu_torch.kernels import join as jk

    candidates = [(ix, iy) for iy in range(iy_lo, iy_hi + 1)
                  for ix in range(ix_lo, ix_hi + 1)]
    boxes = np.asarray([cell_box(level, ix, iy) for ix, iy in candidates],
                       np.float64)
    codes = jk.classify_cells(boxes, spatial.geom, CLASSIFY_MARGIN)
    cells = [c for c, k in zip(candidates, codes) if k == jk.CELL_INTERIOR]
    boundary = [c for c, k in zip(candidates, codes) if k == jk.CELL_BOUNDARY]
    if not cells:
        return None  # nothing reusable: whole-result caching is cheaper
    return RegionDecomposition(
        level=level, residual=residual, residual_key=repr(residual),
        cells=cells, cell_boxes={c: cell_box(level, *c) for c in cells},
        spatial=spatial, boundary=boundary,
        boundary_boxes=_merge_runs(level, boundary),
    )
