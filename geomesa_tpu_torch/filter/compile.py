"""Predicate IR -> fused columnar mask.

Port of ``geomesa_tpu/filter/compile.py`` cut to the nodes this port
serves. A compiled node is ``fn(cols, xp)``: with ``xp=torch`` it builds the
device mask from f32 / int32 / bool tensors; with ``xp=np`` it evaluates on
host rows (the f64 master columns). String predicates resolve to dictionary
codes at compile time. Polygon membership on the device goes through the
point-in-polygon kernel (``kernels/pip.py``).

Where f32 cannot decide a row exactly, the compiled filter says so: the
``band`` marks rows whose f64 value collides with the f32 image of a query
bound (BBOX, Double compares), and ``refine`` holds the exact host tree for
coarse device masks (Long bounds beyond 2^24, point and line literals,
WITHIN / TOUCHES, DWITHIN with a line or polygon literal). The executor
corrects or refines those rows on the host.

Extent columns (LineString, Polygon, Multi*, Geometry) compile to a coarse
envelope mask over their f32 ``__xmin/__ymin/__xmax/__ymax`` device
columns, a superset of the exact matches under even NOT-polarity and a
subset under odd, plus the exact host tree over the ``__wkt`` column
(``geofn``'s ``st_*`` relations on each candidate's parsed WKT, through a
bounded, locked LRU). Under ``geomesa.loose.bbox`` a BBOX on an extent
column is the envelope overlap alone. A ``jsonPath()`` comparison, IN,
LIKE or IS NULL evaluates on the host over the Json attribute's document
text. Expression comparisons
(``ExprCompare``: arithmetic, property against property, ``st_*``
functions) get the exact host tree and, when they call no function and
read no string or geometry, an error-bounded f32 interval mask on the
device.
"""

from __future__ import annotations

import json
import math
import operator
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from threading import Lock
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config, geofn
from geomesa_tpu_torch.curves.binned_time import BinnedTime
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.kernels import pip as kpip
from geomesa_tpu_torch.kernels import registry as kreg
from geomesa_tpu_torch.schema.columns import DictionaryEncoder
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.utils import geometry as geo


@dataclass
class CompiledFilter:
    """``fn(cols, xp)`` -> bool mask over the columns ``columns``.

    ``refine`` (when not None) is the exact host tree: the executor applies
    it to the rows ``fn`` keeps, reading ``columns`` plus
    ``refine_columns``; it may clear rows, never add them. ``band`` (when
    not None) marks rows whose membership is uncertain at f32: the device
    counts ``mask & ~band`` and the executor adds the band rows back from
    ``refine``'s exact evaluation (``refine_only_if_band``: ``refine``
    exists only for that, so a device path needs no refinement)."""

    fn: Callable
    columns: List[str]
    refine: Optional[Callable] = None
    refine_columns: List[str] = field(default_factory=list)
    band: Optional[Callable] = None
    refine_only_if_band: bool = False

    def __call__(self, cols, xp=torch):
        return self.fn(cols, xp)

    def exact_mask(self, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
        """Exact 1-D host mask over ``n`` rows: ``fn``, then ``refine`` on
        the rows it keeps."""
        m = np.asarray(self.fn(cols, np))
        m = np.full(n, bool(m)) if m.ndim == 0 else m.astype(bool, copy=True)
        if self.refine is not None:
            idx = np.nonzero(m)[0]
            if len(idx):
                keep = self.refine_rows({k: v[idx] for k, v in cols.items()}, len(idx))
                m[idx[~keep]] = False
        return m

    def refine_rows(self, cols_rows: Dict[str, np.ndarray], n: int) -> np.ndarray:
        """The exact tree over already-gathered candidate rows: the keep
        mask (bool, length ``n``)."""
        keep = np.asarray(self.refine(cols_rows, np))
        if keep.ndim == 0:
            return np.full(n, bool(keep))
        return keep.astype(bool)


# -- backend helpers (xp is numpy or torch) ------------------------------------
def _f32(a, xp):
    return np.asarray(a).astype(np.float32) if xp is np else a.to(torch.float32)


def _const(value: bool):
    return lambda cols, xp: xp.asarray(value)


_TRUE = _const(True)
_FALSE = _const(False)


def _zeros(c, xp):
    if xp is np:
        return np.zeros(np.shape(c), dtype=bool)
    return torch.zeros(c.shape, dtype=torch.bool, device=c.device)


def _radians(a, xp):
    return np.radians(a) if xp is np else torch.deg2rad(a)


def _scalar(v, xp):
    """A numpy scalar as the host path reads it, a Python number for a
    tensor operand (promotes like the reference's weakly typed scalars)."""
    return v if xp is np else (v.item() if isinstance(v, np.generic) else v)


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
        # the route, noted in exec_path when a scan callable is built
        kreg.record_dispatch("pip", "cuda" if x.is_cuda else "plain")
        for packed, n_edges in edges:
            inside = kpip.pip_mask(x, y, packed, n_edges)
            out = inside if out is None else (out | inside)
        return out

    return pip


def _tensors(arrays, like):
    """f32 tensors of host constants on ``like``'s device: the f32 images
    the reference's device path computes with."""
    return [torch.as_tensor(np.asarray(a, np.float32), device=like.device)
            for a in arrays]


def _on_segments_fn(E: np.ndarray, xcol: str, ycol: str):
    """Coarse point-on-any-segment test: the collinearity threshold is
    relative to the f32 rounding error of the cross product, so on the f32
    device path it is a superset of the exact f64 test (near misses are
    cleared by the host refinement)."""
    x1, y1, x2, y2 = E[:, 0], E[:, 1], E[:, 2], E[:, 3]
    dx, dy = x2 - x1, y2 - y1
    pad = 1e-5 * np.maximum(np.abs(E).max(), 1.0)
    lox, hix = np.minimum(x1, x2) - pad, np.maximum(x1, x2) + pad
    loy, hiy = np.minimum(y1, y2) - pad, np.maximum(y1, y2) + pad
    consts = (x1, y1, dx, dy, lox, hix, loy, hiy)

    def fn(cols, xp):
        x, y = cols[xcol][..., None], cols[ycol][..., None]
        c = consts if xp is np else _tensors(consts, x)
        cx1, cy1, cdx, cdy, clox, chix, cloy, chiy = c
        cross = cdx * (y - cy1) - cdy * (x - cx1)
        err = 1e-5 * (
            xp.abs(cdx) * (xp.abs(y) + xp.abs(cy1) + 1.0)
            + xp.abs(cdy) * (xp.abs(x) + xp.abs(cx1) + 1.0)
        )
        inb = (x >= clox) & (x <= chix) & (y >= cloy) & (y <= chiy)
        hit = (xp.abs(cross) <= err) & inb
        return hit.any(axis=-1) if xp is np else hit.any(dim=-1)

    return fn


def _boundary_endpoints(g: geo.Geometry) -> np.ndarray:
    """[K, 2] mod-2 boundary points of a (multi)linestring literal."""
    lines = g.lines if isinstance(g, geo.MultiLineString) else [g]
    counts: Dict[tuple, int] = {}
    for ls in lines:
        for pt in (tuple(ls.coords[0]), tuple(ls.coords[-1])):
            counts[pt] = counts.get(pt, 0) + 1
    pts = [p for p, c in counts.items() if c % 2 == 1]
    return np.asarray(pts, np.float64).reshape(-1, 2)


def _point_eq_fn(pts: np.ndarray, xcol: str, ycol: str):
    """Point-column equality against a set of literal coordinates."""

    def fn(cols, xp):
        x, y = cols[xcol], cols[ycol]
        out = None
        for px, py in pts:
            m = (x == _scalar(px, xp)) & (y == _scalar(py, xp))
            out = m if out is None else (out | m)
        return xp.asarray(False) if out is None else out

    return fn


def _points_of(g: geo.Geometry) -> np.ndarray:
    if isinstance(g, geo.Point):
        return np.asarray([[g.x, g.y]])
    return np.asarray([[p.x, p.y] for p in g.points])


def _point_exact_fns(g: geo.Geometry, dim: int, xc: str, yc: str):
    """Exact host (f64) evaluators of a point column against a literal, by
    op: the refinement counterparts of the coarse device masks."""

    def inside(cols, xp=np):
        return g.contains_points(np.asarray(cols[xc], np.float64),
                                 np.asarray(cols[yc], np.float64))

    if dim == 0:
        eq = _point_eq_fn(_points_of(g), xc, yc)
        return {"eq": eq, "disjoint": lambda cols, xp=np: ~eq(cols, np)}
    if dim == 1:
        ends = _boundary_endpoints(g)
        at_end = _point_eq_fn(ends, xc, yc) if len(ends) else _FALSE
        return {
            "intersects": inside,  # LineString membership = exact on-segment
            "disjoint": lambda cols, xp=np: ~inside(cols, np),
            "within": lambda cols, xp=np: inside(cols, np) & ~np.asarray(at_end(cols, np)),
            "touches": at_end,
        }

    def on_bnd(cols, xp=np):
        return geofn._on_boundary_of(g, np.asarray(cols[xc], np.float64),
                                     np.asarray(cols[yc], np.float64))

    return {
        "intersects": inside,  # boundary-inclusive ring containment
        "disjoint": lambda cols, xp=np: ~inside(cols, np),
        "within": lambda cols, xp=np: inside(cols, np) & ~on_bnd(cols, np),
        "touches": on_bnd,
    }


def _point_spatial_fn(node: ir.Spatial, xc: str, yc: str, exact: bool,
                      neg: bool, need_refine, need_band) -> Callable:
    """Spatial predicate of a POINT column against a geometry literal. A
    point's interior is the point itself, so every relation reduces to
    membership or boundary tests. Polygon INTERSECTS / DISJOINT run whole
    on the device; boundary- and coincidence-sensitive ops (point and line
    literals, WITHIN, TOUCHES) emit a coarse superset plus the exact host
    refinement."""
    g, op = node.geom, node.op
    dim = (
        0 if isinstance(g, (geo.Point, geo.MultiPoint))
        else 1 if isinstance(g, (geo.LineString, geo.MultiLineString))
        else 2
    )
    if dim == 0:
        if op in ("touches", "crosses", "overlaps"):
            return _FALSE  # empty boundaries / dimension rules
        if op in ("contains", "equals") and not isinstance(g, geo.Point):
            # a single point can only contain / equal a single point
            if len({(p.x, p.y) for p in g.points}) > 1:
                return _FALSE
        ex = _point_exact_fns(g, dim, xc, yc)
        if exact:
            return ex["disjoint"] if op == "disjoint" else ex["eq"]
        need_refine(None)  # f32 equality can collide distinct f64 values
        if neg:
            return _FALSE
        if op == "disjoint":
            return _TRUE
        return _point_eq_fn(_points_of(g), xc, yc)  # f32 eq: a superset
    if dim == 1:
        if op in ("contains", "crosses", "overlaps", "equals"):
            return _FALSE  # dimension rules for a single point
        ex = _point_exact_fns(g, dim, xc, yc)
        if exact:
            return ex[op]
        need_refine(None)
        if neg:
            return _FALSE
        if op == "disjoint":
            return _TRUE
        # intersects / within / touches: all lie on the (relaxed) segments
        return _on_segments_fn(geofn._edges(g), xc, yc)
    if op in ("contains", "crosses", "overlaps", "equals"):
        return _FALSE  # a point cannot contain/cross/overlap/equal an area
    band = None if exact else need_band
    if op == "intersects":
        return _pip_fn(g, xc, yc, band, neg)
    if op == "disjoint":
        # the complement flips the rounding polarity
        pip_n = _pip_fn(g, xc, yc, band, not neg)
        return lambda cols, xp: ~pip_n(cols, xp)
    pip = _pip_fn(g, xc, yc, band, neg)
    ex = _point_exact_fns(g, dim, xc, yc)
    if exact:
        return ex[op]
    need_refine(None)  # within / touches: boundary-sensitive
    if neg:
        return _FALSE
    if op == "within":
        return pip  # superset of the interior
    return _on_segments_fn(geofn._edges(g), xc, yc)  # touches: relaxed boundary


def _geom_cols(ft: FeatureType, prop: str) -> Dict[str, str]:
    """Column names of a geometry attribute: ``x`` / ``y`` (a point, or an
    extent's bounds centroid) and, for extents, the bounds."""
    a = ft.attr(prop)
    if not a.is_geom:
        raise ValueError(f"attribute {prop!r} is not a geometry")
    if a.is_point:
        return {"x": prop + "__x", "y": prop + "__y", "point": "1"}
    return {
        "x": prop + "__x", "y": prop + "__y",
        "xmin": prop + "__xmin", "ymin": prop + "__ymin",
        "xmax": prop + "__xmax", "ymax": prop + "__ymax",
    }


#: parsed-geometry LRU of the refinement: candidate rows repeat across
#: refine calls, and parsing WKT dominates the host refine cost. Bounded
#: and evicting in LRU order; locked, since the partition pipeline's
#: worker and the query thread may refine at once.
_GEOM_CACHE: "OrderedDict[str, geo.Geometry]" = OrderedDict()
_GEOM_CACHE_MAX = 8192
_GEOM_CACHE_LOCK = Lock()


_JSON_CACHE: "OrderedDict[str, object]" = OrderedDict()
_JSON_CACHE_MAX = 8192
_JSON_CACHE_LOCK = Lock()


def _parse_json_cached(s):
    """A stored document parsed (None when it is not JSON), through a
    bounded LRU shared by every jsonPath() predicate."""
    key = str(s)
    with _JSON_CACHE_LOCK:
        if key in _JSON_CACHE:
            _JSON_CACHE.move_to_end(key)
            return _JSON_CACHE[key]
    try:
        doc = json.loads(key)
    except ValueError:
        doc = None
    with _JSON_CACHE_LOCK:
        while len(_JSON_CACHE) >= _JSON_CACHE_MAX:
            _JSON_CACHE.popitem(last=False)
        _JSON_CACHE[key] = doc
    return doc


def _json_path_pred(jp: ir.JsonPath, test) -> Callable:
    """Host evaluator of a jsonPath() predicate: parse each row's stored
    document (cached) and test the values the path extracts; a null or
    unparseable document matches nothing."""
    # convert.py imports the dataset, which imports this module
    from geomesa_tpu_torch.convert import json_path_get

    attr, path = jp.attr, jp.path

    def fn(cols, xp=np):
        col = cols[attr]
        out = np.zeros(len(col), bool)
        for i, s in enumerate(col):
            if s is None:
                continue
            doc = _parse_json_cached(s)
            if doc is None:
                continue
            out[i] = any(v is not None and test(v) for v in json_path_get(doc, path))
        return out

    return fn


def _json_test(op: str, val) -> Callable:
    """Value test with JSON-side coercion: a numeric compare when the
    literal is numeric, else a string compare; values that do not coerce
    fail the test."""
    o = {
        "=": operator.eq, "<>": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge,
    }[op]
    numeric = isinstance(val, (int, float)) and not isinstance(val, bool)

    def test(v):
        try:
            if numeric:
                return bool(o(float(v), float(val)))
            return bool(o(str(v), str(val)))
        except (TypeError, ValueError):
            return False

    return test


def _require_json_attr(ft: FeatureType, jp: ir.JsonPath):
    a = ft.attr(jp.attr)
    if a.type != "json":
        raise ValueError(
            f"jsonPath() requires a Json attribute; {jp.attr!r} is {a.type}"
        )


def _parse_wkt_cached(w) -> geo.Geometry:
    if isinstance(w, geo.Geometry):
        return w
    s = str(w)
    with _GEOM_CACHE_LOCK:
        g = _GEOM_CACHE.get(s)
        if g is not None:
            _GEOM_CACHE.move_to_end(s)
            return g
    g = geo.parse_wkt(s)
    with _GEOM_CACHE_LOCK:
        while len(_GEOM_CACHE) >= _GEOM_CACHE_MAX:
            _GEOM_CACHE.popitem(last=False)
        _GEOM_CACHE[s] = g
    return g


def _exact_extent_fn(op: str, prop: str, literal: geo.Geometry):
    """Exact host evaluator of an extent column: each candidate row's WKT
    (an object or, after a partition reload, a unicode array), parsed
    through the LRU, against the literal by the scalar ``geofn``
    relation."""
    wcol = prop + "__wkt"
    ops = {
        "intersects": geofn.st_intersects,
        "within": geofn.st_within,
        "contains": geofn.st_contains,
        "crosses": geofn.st_crosses,
        "overlaps": geofn.st_overlaps,
        "touches": geofn.st_touches,
        "equals": geofn.st_equals,
    }

    def fn(cols, xp=np):
        wkts = cols[wcol]
        out = np.zeros(len(wkts), bool)
        for i, w in enumerate(wkts):
            g = _parse_wkt_cached(w)
            if op == "disjoint":
                out[i] = not geofn.st_intersects(g, literal)
            else:
                out[i] = bool(ops[op](g, literal))
        return out

    return fn


def _exact_extent_dwithin_fn(prop: str, literal: geo.Geometry, dist_m: float):
    """Exact host DWITHIN of an extent column: the great-circle distance
    from the literal to the row geometry's closest point."""
    wcol = prop + "__wkt"

    def fn(cols, xp=np):
        wkts = cols[wcol]
        out = np.zeros(len(wkts), bool)
        for i, w in enumerate(wkts):
            g = _parse_wkt_cached(w)
            out[i] = float(geofn.st_distanceSphere(g, literal)) <= dist_m
        return out

    return fn


def _extent_overlap_fn(ks, b):
    """Envelope overlap of extent rows (bounds columns ``ks``) with the box
    ``b``; the bounds are Python floats, so a device column compares at
    f32, as the reference's weakly typed scalars do."""
    b0, b1, b2, b3 = (float(v) for v in b)

    def overlap(cols, xp):
        return ((cols[ks[0]] <= b2) & (cols[ks[2]] >= b0)
                & (cols[ks[1]] <= b3) & (cols[ks[3]] >= b1))

    return overlap


# -- expression comparisons (ExprCompare) --------------------------------------
def _expr_mark_needs(node: ir.ExprCompare, ft: FeatureType, need, need_refine) -> bool:
    """Register the columns an expression comparison reads; True when it
    can only be evaluated on the host (functions, strings or geometries)."""
    host_only = ir.expr_has_fn(node.left) or ir.expr_has_fn(node.right)
    for p in node.props():
        a = ft.attr(p)  # raises KeyError naming unknown attributes
        if a.is_geom:
            host_only = True
            if a.is_point:
                need(p + "__x", p + "__y")
            else:
                need_refine(p + "__wkt")
        elif a.type == "json":
            raise ValueError(
                f"json attribute {p!r} cannot appear in an expression; "
                "query it via jsonPath('$...', attr) instead"
            )
        elif a.type == "string":
            host_only = True
            need(p)
        else:
            need(p)
    return host_only


def _expr_resolve_fn(name: str):
    fn = getattr(geofn, name, None)
    if fn is None and not name.startswith("st_"):
        fn = getattr(geofn, "st_" + name, None)
    if fn is None or not callable(fn):
        raise ValueError(f"unknown filter function {name!r} (available: geofn st_*)")
    return fn


def _expr_eval_exact(e: ir.Expr, ft: FeatureType,
                     dicts: Dict[str, DictionaryEncoder], cols, n: int):
    """Exact host evaluation: an f64 array, an object array (strings,
    geometries), or a scalar for literal subtrees."""
    if isinstance(e, ir.Lit):
        return e.value
    if isinstance(e, ir.Prop):
        a = ft.attr(e.name)
        if a.is_geom:
            if a.is_point:
                x = np.asarray(cols[e.name + "__x"], np.float64)
                y = np.asarray(cols[e.name + "__y"], np.float64)
                out = np.empty(len(x), dtype=object)
                for i in range(len(x)):
                    out[i] = geo.Point(float(x[i]), float(y[i]))
                return out
            wkt = cols[e.name + "__wkt"]
            out = np.empty(len(wkt), dtype=object)
            for i, w in enumerate(wkt):
                out[i] = None if w is None else geo.parse_wkt(str(w))
            return out
        if a.type == "string":
            d = dicts.setdefault(e.name, DictionaryEncoder())
            codes = np.asarray(cols[e.name])
            vocab = np.array(list(d.values) + [None], dtype=object)
            return vocab[np.where(codes >= 0, codes, len(d.values))]
        col = np.asarray(cols[e.name])
        if col.dtype.kind in "iu":
            # int64 stays exact (an f64 cast loses beyond 2^53)
            return col.astype(np.int64, copy=False)
        return np.asarray(col, np.float64)
    if isinstance(e, ir.Arith):
        left = _expr_eval_exact(e.left, ft, dicts, cols, n)
        right = _expr_eval_exact(e.right, ft, dicts, cols, n)
        with np.errstate(divide="ignore", invalid="ignore"):
            if e.op == "+":
                return left + right
            if e.op == "-":
                return left - right
            if e.op == "*":
                return left * right
            # scalar / scalar divides as f64 (x / 0 -> inf / nan, as the
            # array path), not with Python's ZeroDivisionError
            if not isinstance(left, np.ndarray) and not isinstance(right, np.ndarray):
                try:
                    left, right = np.float64(left), np.float64(right)
                except (TypeError, ValueError) as exc:
                    raise ValueError(f"non-numeric operands in division: {e!r}") from exc
            return left / right
    if isinstance(e, ir.FnCall):
        return _expr_eval_fn(e, ft, dicts, cols, n)
    raise ValueError(f"cannot evaluate expression node {e!r}")


def _expr_eval_fn(e: ir.FnCall, ft: FeatureType,
                  dicts: Dict[str, DictionaryEncoder], cols, n: int):
    """A function call over rows: vectorized where ``geofn`` takes arrays
    or (xs, ys) point columns, else mapped row by row (a row whose call
    fails is null)."""
    fn = _expr_resolve_fn(e.name)
    # point-geometry arguments keep their raw (x, y) column form, so the
    # vectorized geofn paths run in one call
    xy_forms: Dict[int, tuple] = {}
    args: list = []
    for i, a in enumerate(e.args):
        if isinstance(a, ir.Prop) and ft.has(a.name) and ft.attr(a.name).is_point:
            xy_forms[i] = (np.asarray(cols[a.name + "__x"], np.float64),
                           np.asarray(cols[a.name + "__y"], np.float64))
            args.append(None)  # object array built below if needed
        else:
            args.append(_expr_eval_exact(a, ft, dicts, cols, n))
    if not xy_forms and not any(isinstance(a, np.ndarray) for a in args):
        return fn(*args)  # a literal subtree: one call
    # distance functions are symmetric and vectorize their second argument
    # as an (xs, ys) tuple: one haversine for the whole window
    if e.name in ("st_distance", "st_distanceSphere", "st_distanceSpheroid") \
            and len(e.args) == 2 and len(xy_forms) == 1:
        i = next(iter(xy_forms))
        other = args[1 - i]
        if not isinstance(other, np.ndarray):
            try:
                out = np.asarray(fn(other, xy_forms[i]), np.float64)
                if out.shape == (n,):
                    return out
            except Exception:  # the row-wise map below decides
                pass
    if xy_forms:
        try:  # some geofn functions take (xs, ys) tuples directly
            out = fn(*[xy_forms.get(i, v) for i, v in enumerate(args)])
            if isinstance(out, np.ndarray) and out.shape[:1] == (n,):
                return out if out.dtype.kind == "O" else np.asarray(out, np.float64)
        except Exception:  # the row-wise map below decides
            pass
        for i, (x, y) in xy_forms.items():
            pts = np.empty(n, dtype=object)
            for j in range(n):
                pts[j] = geo.Point(float(x[j]), float(y[j]))
            args[i] = pts
    try:
        out = fn(*args)
        if isinstance(out, np.ndarray) and out.shape[:1] == (n,):
            return out if out.dtype.kind == "O" else np.asarray(out, np.float64)
    except Exception:  # a scalar function: mapped row by row below
        pass
    vals = np.empty(n, dtype=object)
    for i in range(n):
        row = [a[i] if isinstance(a, np.ndarray) else a for a in args]
        if any(r is None for r in row):
            continue
        try:
            vals[i] = fn(*row)
        except Exception:  # a row that fails is null, so excluded
            pass
    try:
        return np.array([np.nan if v is None else float(v) for v in vals], np.float64)
    except (TypeError, ValueError):
        return vals  # geometry or string results stay objects


def _expr_const_fold(node: ir.ExprCompare, ft: FeatureType,
                     dicts: Dict[str, DictionaryEncoder]) -> bool:
    """Truth value of a property-free comparison, evaluated once at
    compile time."""
    def scalar(v):
        if isinstance(v, np.ndarray):
            return v.reshape(-1)[0] if v.size else None
        return v

    left = scalar(_expr_eval_exact(node.left, ft, dicts, {}, 1))
    right = scalar(_expr_eval_exact(node.right, ft, dicts, {}, 1))
    op = node.op
    try:
        if op == "=":
            return bool(left == right)
        if op == "<>":
            return bool(left != right)
        if left is None or right is None:
            return False
        if op == "<":
            return bool(left < right)
        if op == "<=":
            return bool(left <= right)
        if op == ">":
            return bool(left > right)
        return bool(left >= right)
    except TypeError as e:
        raise ValueError(f"incomparable constant operands in {node!r}") from e


def _expr_exact_fn(node: ir.ExprCompare, ft: FeatureType,
                   dicts: Dict[str, DictionaryEncoder]):
    """The exact host tree of an expression comparison: f64 (int64 where
    both sides are integers); NaN and null rows compare false."""
    op = node.op

    def fn(cols, xp=np):
        probe = None
        for p in node.props():
            a = ft.attr(p)
            key = p + "__x" if a.is_point else (p + "__wkt" if a.is_geom else p)
            if key in cols:
                probe = cols[key]
                break
        if probe is None:
            raise ValueError(f"expression references no resolvable column: {node!r}")
        n = len(probe)
        left = _expr_eval_exact(node.left, ft, dicts, cols, n)
        right = _expr_eval_exact(node.right, ft, dicts, cols, n)
        lobj = isinstance(left, np.ndarray) and left.dtype.kind == "O"
        robj = isinstance(right, np.ndarray) and right.dtype.kind == "O"
        if lobj or robj or isinstance(left, str) or isinstance(right, str):
            if op not in ("=", "<>"):
                raise ValueError(f"ordering comparison {op!r} is not defined for "
                                 "string/geometry expressions")
            la = left if isinstance(left, np.ndarray) else np.full(n, left, dtype=object)
            ra = right if isinstance(right, np.ndarray) else np.full(n, right, dtype=object)
            valid = np.array([a is not None and b is not None for a, b in zip(la, ra)])
            eqm = np.array([a == b for a, b in zip(la, ra)], dtype=bool)
            return (eqm if op == "=" else ~eqm) & valid
        lint = (np.asarray(left).dtype.kind in "iub" if isinstance(left, np.ndarray)
                else isinstance(left, (int, np.integer)))
        rint = (np.asarray(right).dtype.kind in "iub" if isinstance(right, np.ndarray)
                else isinstance(right, (int, np.integer)))
        if lint and rint:
            left = np.asarray(left, np.int64)
            right = np.asarray(right, np.int64)
            valid = np.asarray(True)
        else:
            left = np.asarray(left, np.float64)
            right = np.asarray(right, np.float64)
            valid = ~(np.isnan(left) | np.isnan(right))
        if op == "=":
            m = left == right
        elif op == "<>":
            m = left != right
        elif op == "<":
            m = left < right
        elif op == "<=":
            m = left <= right
        elif op == ">":
            m = left > right
        else:
            m = left >= right
        return m & valid

    return fn


#: relative f32 ulp with a 4x safety factor that absorbs the rounding of
#: the error arithmetic itself
_EXPR_EPS = 4.0 * 2.0 ** -23


def _xabs(v):
    return v.abs() if isinstance(v, torch.Tensor) else np.abs(v)


def _xmax(v, lo: float):
    return v.clamp(min=lo) if isinstance(v, torch.Tensor) else np.maximum(v, lo)


def _xwhere(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(cond, np.ndarray) and cond.ndim:
        return np.where(cond, a, b)
    return a if bool(cond) else b


def _expr_eval_coarse(e: ir.Expr, cols, xp):
    """Interval evaluation over the scan columns (f32 on the device, the
    f64 masters on the host): (value, absolute error bound)."""
    if isinstance(e, ir.Lit):
        v = float(e.value)
        return v, abs(v) * _EXPR_EPS
    if isinstance(e, ir.Prop):
        v = cols[e.name] * 1.0  # ints and bools promote to float
        return v, _xabs(v) * _EXPR_EPS
    if isinstance(e, ir.Arith):
        lv, le = _expr_eval_coarse(e.left, cols, xp)
        rv, re_ = _expr_eval_coarse(e.right, cols, xp)
        if e.op == "+":
            v = lv + rv
            return v, le + re_ + _xabs(v) * _EXPR_EPS
        if e.op == "-":
            v = lv - rv
            return v, le + re_ + _xabs(v) * _EXPR_EPS
        if e.op == "*":
            v = lv * rv
            return v, (_xabs(lv) * re_ + _xabs(rv) * le + le * re_
                       + _xabs(v) * _EXPR_EPS)
        # division: a denominator interval that holds zero makes the bound
        # infinite (the row stays a candidate); literal / literal divides
        # as f64 (x / 0 -> inf / nan), as the column path does
        if isinstance(lv, float) and isinstance(rv, float):
            with np.errstate(divide="ignore", invalid="ignore"):
                v = float(np.float64(lv) / np.float64(rv))
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                v = lv / rv
        den = _xmax(_xabs(rv) - re_, 0.0)
        err = _xwhere(den > 0,
                      (le + _xabs(v) * re_) / _xmax(den, 1e-30) + _xabs(v) * _EXPR_EPS,
                      math.inf)
        return v, err
    raise ValueError(f"cannot device-evaluate expression node {e!r}")


def _expr_coarse_fn(node: ir.ExprCompare, neg: bool):
    """Device prefilter: a superset of the exact matches under even
    NOT-polarity (every possibly-true row), a subset under odd (only the
    certainly-true rows). NaN rows compare false either way, as the exact
    tree's validity mask."""
    op = node.op

    def fn(cols, xp):
        lv, le = _expr_eval_coarse(node.left, cols, xp)
        rv, re_ = _expr_eval_coarse(node.right, cols, xp)
        slack = le + re_
        if not neg:  # possibly true
            if op == "=":
                return _xabs(lv - rv) <= slack
            if op == "<>":
                return ~((_xabs(lv - rv) == 0) & (slack == 0))
            if op in ("<", "<="):
                return lv - slack <= rv
            return lv + slack >= rv
        # certainly true (the enclosing NOT inverts it)
        if op == "=":
            return (_xabs(lv - rv) == 0) & (slack == 0)
        if op == "<>":
            return _xabs(lv - rv) > slack
        if op == "<":
            return lv + slack < rv
        if op == "<=":
            return lv + slack <= rv
        if op == ">":
            return lv - slack > rv
        return lv - slack >= rv

    return fn


def _like_regex(pattern: str, ci: bool):
    """LIKE pattern (% and _ wildcards) -> anchored compiled regex."""
    rx = "".join(
        ".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in pattern
    )
    return re.compile("^" + rx + "$", re.IGNORECASE if ci else 0)


def _like_codes(d: DictionaryEncoder, pattern: str, ci: bool) -> np.ndarray:
    """The dictionary codes whose value matches a LIKE pattern."""
    cre = _like_regex(pattern, ci)
    return np.array([i for i, v in enumerate(d.values) if cre.match(v)],
                    dtype=np.int32)


def _isin_fn(col: str, codes: np.ndarray):
    """Membership of a column in a small value set: chained compares up to
    16 values, else ``isin`` (``torch.isin`` on the device)."""
    codes = np.asarray(codes)

    def fn(cols, xp):
        c = cols[col]
        if codes.size == 0:
            return _zeros(c, xp)
        if codes.size <= 16:
            m = c == _scalar(codes[0], xp)
            for v in codes[1:]:
                m = m | (c == _scalar(v, xp))
            return m
        if xp is np:
            return np.isin(c, codes)
        return torch.isin(c, torch.as_tensor(codes, device=c.device).to(c.dtype))

    return fn


def _fid_fn(ids: List[str]):
    """Exact feature-id membership on the host-only ``__fid__`` column, in
    the column's own layout ('S' bytes, else 'U' or objects)."""

    def fid_mask(cols, xp):
        fids = np.asarray(cols["__fid__"])
        if fids.dtype.kind == "S":
            q = np.asarray([i.encode("utf-8", "surrogateescape") for i in ids])
        elif fids.dtype.kind == "U":
            q = np.asarray(ids)
        else:
            idset = set(ids)
            return np.array([f in idset for f in fids], dtype=bool)
        return np.isin(fids, q)

    return fid_mask


def _compare_fn(col: str, op: str, val):
    """Plain compare of a column with a scalar (exact on host columns, and
    on device columns whose type holds the value exactly)."""
    if op == "=":
        return lambda cols, xp: cols[col] == val
    if op == "<>":
        return lambda cols, xp: cols[col] != val
    if op == "<":
        return lambda cols, xp: cols[col] < val
    if op == "<=":
        return lambda cols, xp: cols[col] <= val
    if op == ">":
        return lambda cols, xp: cols[col] > val
    return lambda cols, xp: cols[col] >= val


def _f32_compare_fn(col: str, op: str, val, neg: bool):
    """Compare at f32 with rounding polarity: by monotone rounding,
    ``f32(x) <= f32(v)`` is a superset of ``x < v`` and ``f32(x) < f32(v)``
    a subset (symmetrically for >); f32 equality has no false negatives.
    Under odd NOT-nesting the subset is emitted."""
    v32 = float(np.float32(val))
    if op == "=":
        return _FALSE if neg else (lambda cols, xp: _f32(cols[col], xp) == v32)
    if op == "<>":
        return (lambda cols, xp: _f32(cols[col], xp) != v32) if neg else _TRUE
    if op in ("<", "<="):
        if neg:
            return lambda cols, xp: _f32(cols[col], xp) < v32
        return lambda cols, xp: _f32(cols[col], xp) <= v32
    if neg:
        return lambda cols, xp: _f32(cols[col], xp) > v32
    return lambda cols, xp: _f32(cols[col], xp) >= v32


def _f32_in_fn(col: str, vals: np.ndarray):
    """f32 membership: a superset (no equality false negatives)."""
    vals32 = np.unique(vals.astype(np.float32))

    def fn(cols, xp):
        c = _f32(cols[col], xp)
        m = c == float(vals32[0])
        for v in vals32[1:]:
            m = m | (c == float(v))
        return m

    return fn


def compile_filter(f: ir.Filter, ft: FeatureType,
                   dicts: Optional[Dict[str, DictionaryEncoder]] = None) -> CompiledFilter:
    """Compile a predicate IR tree into a columnar mask. ``neg`` tracks
    NOT-polarity so f32 compares round toward a superset of the exact
    matches under even nesting and a subset under odd nesting; ``exact``
    builds the host tree over f64 master rows."""
    dicts = {} if dicts is None else dicts
    needed: List[str] = []
    refine_needed: List[str] = []
    has_refine = [False]

    def need(*cols):
        for c in cols:
            if c not in needed:
                needed.append(c)

    def need_refine(c):
        has_refine[0] = True
        if c is not None and c not in refine_needed:
            refine_needed.append(c)

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
            gc = _geom_cols(ft, node.prop)
            xmin, ymin, xmax, ymax = node.xmin, node.ymin, node.xmax, node.ymax
            if "point" not in gc:
                if config.LOOSE_BBOX.to_bool():
                    # envelope overlap only, no refinement (exact either
                    # way when a stored geometry is its envelope)
                    ks = (gc["xmin"], gc["ymin"], gc["xmax"], gc["ymax"])
                    need(*ks)
                    return _extent_overlap_fn(ks, (xmin, ymin, xmax, ymax))
                # exact semantics: INTERSECTS with the box polygon
                return compile_node(
                    ir.Spatial("intersects", node.prop,
                               geo.bbox_polygon(xmin, ymin, xmax, ymax)),
                    neg, exact)
            xc, yc = gc["x"], gc["y"]
            need(xc, yc)
            if exact:

                def bbox_exact(cols, xp):
                    x, y = cols[xc], cols[yc]
                    return (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)

                return bbox_exact
            band_eq(xc, xmin, xmax)
            band_eq(yc, ymin, ymax)
            return _f32_box_fn(xc, yc, (xmin, ymin, xmax, ymax), neg)
        if isinstance(node, ir.Spatial):
            gc = _geom_cols(ft, node.prop)
            if "point" in gc:
                need(gc["x"], gc["y"])
                return _point_spatial_fn(node, gc["x"], gc["y"], exact, neg,
                                         need_refine, band_eq)
            return compile_extent(node, gc, neg, exact)
        if isinstance(node, ir.DWithin):
            gc = _geom_cols(ft, node.prop)
            if "point" not in gc or not isinstance(node.geom, geo.Point):
                return compile_dwithin_box(node, gc, neg, exact)
            xc, yc = gc["x"], gc["y"]
            need(xc, yc)
            # great-circle test, fused into the device mask
            px, py, dist = node.geom.x, node.geom.y, node.distance_m
            rx2, ry2 = float(np.radians(px)), float(np.radians(py))
            cos_ry2 = float(np.cos(ry2))

            def dwithin(cols, xp):
                x, y = cols[xc], cols[yc]
                rx1, ry1 = _radians(x, xp), _radians(y, xp)
                a = (xp.sin((ry2 - ry1) / 2) ** 2
                     + xp.cos(ry1) * cos_ry2 * xp.sin((rx2 - rx1) / 2) ** 2)
                d = 2 * geo.EARTH_RADIUS_M * xp.arcsin(xp.sqrt(xp.clip(a, 0, 1)))
                return d <= dist

            return dwithin
        if isinstance(node, ir.Compare):
            return compile_compare(node, neg, exact)
        if isinstance(node, ir.Between):
            inner = ir.And((ir.Compare(node.prop, ">=", node.lo),
                            ir.Compare(node.prop, "<=", node.hi)))
            return compile_node(inner, neg, exact)
        if isinstance(node, ir.In):
            return compile_in(node, neg, exact)
        if isinstance(node, ir.Like):
            if isinstance(node.prop, ir.JsonPath):
                _require_json_attr(ft, node.prop)
                need(node.prop.attr)
                cre = _like_regex(node.pattern, node.case_insensitive)
                return _json_path_pred(node.prop, lambda v: bool(cre.match(str(v))))
            a = ft.attr(node.prop)
            if a.type != "string":
                raise ValueError(f"LIKE requires a string attribute, got {a.type}")
            need(node.prop)
            d = dicts.setdefault(node.prop, DictionaryEncoder())
            return _isin_fn(node.prop, _like_codes(d, node.pattern, node.case_insensitive))
        if isinstance(node, ir.IsNull):
            if isinstance(node.prop, ir.JsonPath):
                _require_json_attr(ft, node.prop)
                need(node.prop.attr)
                exists = _json_path_pred(node.prop, lambda v: True)
                if node.negate:  # IS NOT NULL
                    return exists
                return lambda cols, xp: ~np.asarray(exists(cols, xp))
            a = ft.attr(node.prop)
            need(node.prop)
            col = node.prop
            if a.type == "string":
                fn = lambda cols, xp: cols[col] < 0  # noqa: E731
            elif a.type.startswith("float"):
                fn = lambda cols, xp: xp.isnan(cols[col])  # noqa: E731
            else:
                fn = lambda cols, xp: _zeros(cols[col], xp)  # noqa: E731
            if node.negate:
                return lambda cols, xp: ~fn(cols, xp)
            return fn
        if isinstance(node, ir.During):
            if isinstance(node.prop, ir.JsonPath):
                raise ValueError(
                    "temporal predicates (DURING/BEFORE/AFTER/TEQUALS) are "
                    "not supported on jsonPath() accessors; compare the "
                    "extracted value numerically instead"
                )
            # lexicographic compare on the (bin, scaled offset) int32 pair
            lo_b, lo_o, hi_b, hi_o = during_device_bounds(ft, node.lo_ms, node.hi_ms)
            cb, co = node.prop + "__bin", node.prop + "__off"
            need(cb, co)

            def during(cols, xp):
                b, o = cols[cb], cols[co]
                ge = (b > lo_b) | ((b == lo_b) & (o >= lo_o))
                le = (b < hi_b) | ((b == hi_b) & (o <= hi_o))
                return ge & le

            return during
        if isinstance(node, ir.IdIn):
            need("__fid__")
            return _fid_fn([str(i) for i in node.ids])
        if isinstance(node, ir.ExprCompare):
            if not node.props():
                # both sides fold to constants
                const = _expr_const_fold(node, ft, dicts)
                return compile_node(ir.Include() if const else ir.Exclude(), neg, exact)
            host_only = _expr_mark_needs(node, ft, need, need_refine)
            if exact:
                return _expr_exact_fn(node, ft, dicts)
            need_refine(None)
            if host_only:
                # functions, strings and geometries: every candidate goes
                # to the host tree
                return _FALSE if neg else _TRUE
            return _expr_coarse_fn(node, neg)
        raise ValueError(f"cannot compile filter node: {node!r}")

    def compile_extent(node: ir.Spatial, gc: Dict[str, str], neg: bool,
                       exact: bool) -> Callable:
        """A spatial relation of an extent column: the exact host tree, or
        the coarse envelope mask (a superset under even NOT-polarity, the
        certain-match subset under odd) with the refinement registered."""
        need_refine(node.prop + "__wkt")
        if exact:
            return _exact_extent_fn(node.op, node.prop, node.geom)
        ks = (gc["xmin"], gc["ymin"], gc["xmax"], gc["ymax"])
        need(*ks)
        b = tuple(float(v) for v in node.geom.bounds())
        overlap = _extent_overlap_fn(ks, b)
        op = node.op
        if neg:
            return (lambda cols, xp: ~overlap(cols, xp)) if op == "disjoint" else _FALSE
        if op == "disjoint":
            return _TRUE  # an envelope overlap cannot prove intersection
        if op == "within":  # the row's envelope inside the literal's

            def within(cols, xp):
                return ((cols[ks[0]] >= b[0]) & (cols[ks[2]] <= b[2])
                        & (cols[ks[1]] >= b[1]) & (cols[ks[3]] <= b[3]))

            return within
        if op == "contains":  # the literal's envelope inside the row's

            def contains(cols, xp):
                return ((cols[ks[0]] <= b[0]) & (cols[ks[2]] >= b[2])
                        & (cols[ks[1]] <= b[1]) & (cols[ks[3]] >= b[3]))

            return contains
        if op == "equals":

            def equals(cols, xp):
                return ((xp.abs(cols[ks[0]] - b[0]) <= 1e-9)
                        & (xp.abs(cols[ks[1]] - b[1]) <= 1e-9)
                        & (xp.abs(cols[ks[2]] - b[2]) <= 1e-9)
                        & (xp.abs(cols[ks[3]] - b[3]) <= 1e-9))

            return equals
        return overlap  # intersects / crosses / overlaps / touches

    def compile_dwithin_box(node: ir.DWithin, gc: Dict[str, str], neg: bool,
                            exact: bool) -> Callable:
        """DWITHIN of an extent column, or of a point column against a line
        or polygon literal: the coarse test against the literal's bounds
        widened by the distance (longitude by the cosine of the widest
        latitude), then the exact great-circle distance to the geometry on
        the host."""
        d_deg = node.distance_m / geo.METERS_PER_DEGREE
        bb = node.geom.bounds()
        maxlat = min(89.0, max(abs(bb[1]), abs(bb[3])))
        dxp = d_deg / max(np.cos(np.radians(maxlat)), 1e-3)
        ex = tuple(float(v) for v in
                   (bb[0] - dxp, bb[1] - d_deg, bb[2] + dxp, bb[3] + d_deg))
        if "point" in gc:
            xc, yc = gc["x"], gc["y"]
            need(xc, yc)
            if exact:
                lit, dist = node.geom, node.distance_m

                def dw_exact(cols, xp=np):
                    d = geofn.st_distanceSphere(
                        lit, (np.asarray(cols[xc], np.float64),
                              np.asarray(cols[yc], np.float64)))
                    return np.asarray(d) <= dist

                return dw_exact
            need_refine(None)
            if neg:
                return _FALSE

            def dwithin_box(cols, xp):
                x, y = cols[xc], cols[yc]
                return (x >= ex[0]) & (x <= ex[2]) & (y >= ex[1]) & (y <= ex[3])

            return dwithin_box
        need_refine(node.prop + "__wkt")
        if exact:
            return _exact_extent_dwithin_fn(node.prop, node.geom, node.distance_m)
        ks = (gc["xmin"], gc["ymin"], gc["xmax"], gc["ymax"])
        need(*ks)
        return _FALSE if neg else _extent_overlap_fn(ks, ex)

    def compile_compare(node: ir.Compare, neg: bool, exact: bool) -> Callable:
        if isinstance(node.prop, ir.JsonPath):
            _require_json_attr(ft, node.prop)
            need(node.prop.attr)
            return _json_path_pred(node.prop, _json_test(node.op, node.value))
        a = ft.attr(node.prop)
        col = node.prop
        if (a.type in ("int32", "int64")
                and isinstance(node.value, (float, np.floating))
                and not float(node.value).is_integer()
                and node.op in ("=", "<>")):
            # no integer equals a non-integral literal
            return _const(node.op == "<>")
        need(col)
        if a.type == "string":
            d = dicts.setdefault(node.prop, DictionaryEncoder())
            if node.op in ("=", "<>"):
                code = d.code_of(str(node.value))
                if node.op == "=":
                    return lambda cols, xp: cols[col] == code
                return lambda cols, xp: (cols[col] != code) & (cols[col] >= 0)
            # ordering on strings: resolved against the vocabulary
            sval = str(node.value)
            ops = {
                "<": lambda v: v < sval, "<=": lambda v: v <= sval,
                ">": lambda v: v > sval, ">=": lambda v: v >= sval,
            }[node.op]
            return _isin_fn(col, np.array(
                [i for i, v in enumerate(d.values) if ops(v)], dtype=np.int32))
        if a.type == "bool":
            bv = (node.value if isinstance(node.value, bool)
                  else str(node.value).lower() == "true")
            if node.op == "=":
                return lambda cols, xp: cols[col] == bv
            if node.op == "<>":
                return lambda cols, xp: cols[col] != bv
            raise ValueError(f"unsupported boolean comparison {node.op!r}")
        val = node.value
        if a.type == "date":
            if not isinstance(val, (int, np.integer)):
                from geomesa_tpu_torch.filter.ecql import parse_iso_ms

                val = parse_iso_ms(str(val))
            v = int(val)
            # rewrite to interval form -> (bin, off) pair compare
            iv = {
                "=": ir.During(col, v, v),
                "<>": ir.Not(ir.During(col, v, v)),
                "<": ir.During(col, ir.MIN_MS, v - 1),
                "<=": ir.During(col, ir.MIN_MS, v),
                ">": ir.During(col, v + 1, ir.MAX_MS),
                ">=": ir.During(col, v, ir.MAX_MS),
            }[node.op]
            return compile_node(iv)
        op = node.op
        if a.type in ("float32", "float64"):
            val = float(val)
        elif isinstance(val, (float, np.floating)) and not float(val).is_integer():
            # non-integral literal against an integer column: exact
            # integer bounds (= and <> were resolved above)
            fv = float(val)
            val, op = (math.floor(fv), "<=") if op in ("<", "<=") else (math.ceil(fv), ">=")
        else:
            val = int(val)
        if a.type == "float64" and not exact:
            # Double rides the device as f32: the band marks the rows
            # colliding with the bound's f32 image
            band_eq(col, val)
            return _f32_compare_fn(col, op, val, neg)
        if a.type == "int64" and not exact and abs(val) >= (1 << 24):
            # Long rides the device as f32, lossy beyond 2^24: a coarse f32
            # compare plus the exact refine on the int64 host column
            need_refine(None)
            return _f32_compare_fn(col, op, val, neg)
        return _compare_fn(col, op, val)

    def compile_in(node: ir.In, neg: bool, exact: bool) -> Callable:
        if isinstance(node.prop, ir.JsonPath):
            _require_json_attr(ft, node.prop)
            need(node.prop.attr)
            tests = [_json_test("=", v) for v in node.values]
            return _json_path_pred(node.prop, lambda v: any(t(v) for t in tests))
        a = ft.attr(node.prop)
        need(node.prop)
        if a.type == "string":
            d = dicts.setdefault(node.prop, DictionaryEncoder())
            codes = np.array([d.code_of(str(v)) for v in node.values], dtype=np.int32)
            return _isin_fn(node.prop, codes[codes >= 0])
        if a.type.startswith("float"):
            vals = np.array([float(v) for v in node.values])
        else:
            # int columns: a non-integral literal never matches; one outside
            # int64 cannot either
            vals = np.array([
                int(v) for v in node.values
                if not (isinstance(v, (float, np.floating)) and not float(v).is_integer())
                and -(2 ** 63) <= int(v) < 2 ** 63
            ], dtype=np.int64)
        if a.type == "float64" and not exact and len(vals):
            band_eq(node.prop, *vals.tolist())
            return _FALSE if neg else _f32_in_fn(node.prop, vals)
        if a.type == "int64" and not exact and np.abs(vals).max(initial=0) >= (1 << 24):
            need_refine(None)
            return _FALSE if neg else _f32_in_fn(node.prop, vals)
        return _isin_fn(node.prop, vals)

    fn = compile_node(f)
    refine = band = None
    band_only = False
    if has_refine[0]:
        refine = compile_node(f, exact=True)
    elif bands:
        # refine-bearing plans are already host-exact on candidates; only
        # the pure device path needs the f32-uncertainty band, whose rows
        # the exact tree decides
        bfns = list(bands)

        def band(cols, xp):  # noqa: F811
            m = bfns[0](cols, xp)
            for b in bfns[1:]:
                m = m | b(cols, xp)
            return m

        refine = compile_node(f, exact=True)
        band_only = True
    return CompiledFilter(fn, needed, refine=refine, refine_columns=refine_needed,
                          band=band, refine_only_if_band=band_only)
