"""Predicate IR -> fused columnar mask.

Port of ``geomesa_tpu/filter/compile.py`` cut to the nodes this port serves.
A compiled node is ``fn(cols, xp)``: with ``xp=torch`` it builds the device
mask from f32 / int32 tensors; with ``xp=np`` it evaluates exactly on host
f64 master rows (the band certificate and its refinement). Geometry
literals become packed edge tables; polygon membership on the device goes
through the point-in-polygon kernel (``kernels/pip.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.curves.binned_time import BinnedTime
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.kernels import pip as kpip
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.utils import geometry as geo

_LATER = "ROADMAP Queue 1, index key spaces and predicates"


@dataclass
class CompiledFilter:
    """``fn(cols, xp)`` -> bool mask. ``band`` (when not None) marks rows
    whose membership is uncertain at f32 (an f64 value colliding with the
    f32 image of a query bound): the device counts ``mask & ~band`` and the
    executor adds the band rows back from their exact f64 evaluation by
    ``refine`` (``refine_only_if_band``: refine exists only for that)."""

    fn: Callable
    columns: List[str]
    refine: Optional[Callable] = None
    band: Optional[Callable] = None
    refine_only_if_band: bool = False

    def __call__(self, cols, xp=torch):
        return self.fn(cols, xp)


def _f32(a, xp):
    return a.astype(np.float32) if xp is np else a.to(torch.float32)


def _const(value: bool):
    return lambda cols, xp: xp.asarray(value)


_TRUE = _const(True)
_FALSE = _const(False)


def during_device_bounds(ft: FeatureType, lo_ms: int,
                         hi_ms: int) -> Tuple[int, int, int, int]:
    """Quantize [lo_ms, hi_ms] to the device time representation:
    ``(lo_bin, lo_off, hi_bin, hi_off)`` against the (bin, scaled offset)
    int32 column pair."""
    bt = BinnedTime(ft.time_period)
    scale = bt.off_scale
    CLAMP = 2**45  # ~±1100 years; keeps bins in int32
    lo = max(min(lo_ms, CLAMP), -CLAMP)
    hi = max(min(hi_ms, CLAMP), -CLAMP)
    lo_b, lo_o = (int(v[0]) for v in bt.to_bin_and_offset(np.asarray([lo])))
    hi_b, hi_o = (int(v[0]) for v in bt.to_bin_and_offset(np.asarray([hi])))
    return lo_b, lo_o // scale, hi_b, hi_o // scale


def _f32_box_fn(xc: str, yc: str, box, neg: bool):
    """f32 box test: inclusive bounds where a superset is needed (even
    NOT-polarity), strict where a subset is (odd)."""
    x0, y0, x1, y1 = (float(np.float32(v)) for v in box)

    def fn(cols, xp):
        x = _f32(cols[xc], xp)
        y = _f32(cols[yc], xp)
        if neg:
            return (x > x0) & (x < x1) & (y > y0) & (y < y1)
        return (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)

    return fn


def _pip_fn(g: geo.Geometry, xcol: str, ycol: str, need_band=None,
            neg: bool = False):
    """Point-in-(multi)polygon by even-odd crossing parity (holes included
    by the rule). A single axis-aligned rectangle compiles to a box test
    (band-exact when ``need_band`` registers its bounds)."""
    polys = g.polygons if isinstance(g, geo.MultiPolygon) else (g,)
    if len(polys) == 1 and polys[0].is_rectangle():
        xmin, ymin, xmax, ymax = polys[0].bounds()
        if need_band is not None:
            need_band(xcol, xmin, xmax)
            need_band(ycol, ymin, ymax)
            return _f32_box_fn(xcol, ycol, (xmin, ymin, xmax, ymax), neg)

        def rect(cols, xp):
            x, y = cols[xcol], cols[ycol]
            return (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)

        return rect

    tables = [kpip.polygon_edge_tables(p) for p in polys]
    #: packed edge tables as f32 tensors, per device
    on_device = {}

    def pip(cols, xp):
        x, y = cols[xcol], cols[ycol]
        out = None
        if xp is np:  # exact host evaluation over the f64 tables
            for (x1, y1, x2, y2, slope), _ in tables:
                yb = y[..., None]
                cond = (y1 > yb) != (y2 > yb)
                xint = x1 + (yb - y1) * slope
                crossings = (cond & (x[..., None] < xint)).sum(axis=-1)
                inside = (crossings % 2) == 1
                out = inside if out is None else (out | inside)
            return out
        edges = on_device.get(x.device)
        if edges is None:
            edges = on_device[x.device] = [
                (torch.from_numpy(packed).to(x.device), len(t[0]))
                for t, packed in tables
            ]
        for packed, n_edges in edges:
            inside = kpip.pip_mask(x, y, packed, n_edges)
            out = inside if out is None else (out | inside)
        return out

    return pip


def _point_spatial_fn(node: ir.Spatial, xc: str, yc: str, exact: bool,
                      neg: bool, need_band) -> Callable:
    """Spatial predicate of a point column against a polygon literal."""
    g, op = node.geom, node.op
    if not isinstance(g, (geo.Polygon, geo.MultiPolygon)):
        raise NotImplementedError(f"non-polygon literals: {_LATER}")
    if op in ("contains", "crosses", "overlaps", "equals"):
        return _FALSE  # a point cannot contain/cross/overlap/equal an area
    band = None if exact else need_band
    if op == "intersects":
        return _pip_fn(g, xc, yc, band, neg)
    if op == "disjoint":
        # the complement flips the rounding polarity
        pip_n = _pip_fn(g, xc, yc, band, not neg)
        return lambda cols, xp: ~pip_n(cols, xp)
    raise NotImplementedError(f"{op.upper()} on point columns: {_LATER}")


def compile_filter(f: ir.Filter, ft: FeatureType) -> CompiledFilter:
    """Compile a predicate IR tree into a columnar mask. ``neg`` tracks
    NOT-polarity so f32 compares round toward a superset of the exact
    matches under even nesting and a subset under odd nesting."""
    needed: List[str] = []

    def need(*cols):
        for c in cols:
            if c not in needed:
                needed.append(c)

    # f32-uncertainty bands: rows whose f64 value rounds to the f32 image
    # of a query bound, the only rows where f32 and f64 compares disagree
    bands: List[Callable] = []

    def band_eq(col: str, *bounds: float):
        b32s = sorted({float(np.float32(b)) for b in bounds})

        def bfn(cols, xp):
            c = _f32(cols[col], xp)
            m = c == b32s[0]
            for b in b32s[1:]:
                m = m | (c == b)
            return m

        bands.append(bfn)

    def geom_cols(prop: str):
        a = ft.attr(prop)
        if not a.is_point:
            raise ValueError(f"attribute {prop!r} is not a geometry")
        return prop + "__x", prop + "__y"

    def compile_node(node: ir.Filter, neg: bool = False,
                     exact: bool = False) -> Callable:
        if isinstance(node, ir.Include):
            return _TRUE
        if isinstance(node, ir.Exclude):
            return _FALSE
        if isinstance(node, (ir.And, ir.Or)):
            fns = [compile_node(c, neg, exact) for c in node.children]
            conj = isinstance(node, ir.And)

            def f_bool(cols, xp):
                m = fns[0](cols, xp)
                for fn in fns[1:]:
                    m = (m & fn(cols, xp)) if conj else (m | fn(cols, xp))
                return m

            return f_bool
        if isinstance(node, ir.Not):
            fn = compile_node(node.child, not neg, exact)
            return lambda cols, xp: ~fn(cols, xp)
        if isinstance(node, ir.BBox):
            xc, yc = geom_cols(node.prop)
            need(xc, yc)
            xmin, ymin, xmax, ymax = node.xmin, node.ymin, node.xmax, node.ymax
            if exact:

                def bbox_exact(cols, xp):
                    x, y = cols[xc], cols[yc]
                    return (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)

                return bbox_exact
            band_eq(xc, xmin, xmax)
            band_eq(yc, ymin, ymax)
            return _f32_box_fn(xc, yc, (xmin, ymin, xmax, ymax), neg)
        if isinstance(node, ir.Spatial):
            xc, yc = geom_cols(node.prop)
            need(xc, yc)
            return _point_spatial_fn(node, xc, yc, exact, neg, band_eq)
        if isinstance(node, ir.During):
            # lexicographic compare on the (bin, scaled offset) int32 pair
            lo_b, lo_o, hi_b, hi_o = during_device_bounds(
                ft, node.lo_ms, node.hi_ms
            )
            cb, co = node.prop + "__bin", node.prop + "__off"
            need(cb, co)

            def during(cols, xp):
                b, o = cols[cb], cols[co]
                ge = (b > lo_b) | ((b == lo_b) & (o >= lo_o))
                le = (b < hi_b) | ((b == hi_b) & (o <= hi_o))
                return ge & le

            return during
        raise NotImplementedError(f"filter node {type(node).__name__}: {_LATER}")

    fn = compile_node(f)
    refine = band = None
    if bands:
        bfns = list(bands)

        def band(cols, xp):  # noqa: F811
            m = bfns[0](cols, xp)
            for b in bfns[1:]:
                m = m | b(cols, xp)
            return m

        # the exact tree doubles as the refiner of band rows
        refine = compile_node(f, exact=True)
    return CompiledFilter(fn, needed, refine=refine, band=band,
                          refine_only_if_band=band is not None)
