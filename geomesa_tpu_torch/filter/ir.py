"""Predicate IR + plan-time bound extraction.

Copy of ``geomesa_tpu/filter/ir.py`` cut to the nodes this port serves:
INCLUDE / EXCLUDE, AND / OR / NOT, BBOX, spatial relations and DWITHIN
against a geometry literal, attribute comparisons (``Compare``,
``Between``, ``In``, ``Like``, ``IsNull``), DURING intervals (BEFORE /
AFTER / TEQUALS parse to DURING), feature-id ``IdIn`` and expression
comparisons (``ExprCompare`` over ``Prop`` / ``Lit`` / ``Arith`` /
``FnCall`` trees), and the ``JsonPath`` accessor a comparison, IN, LIKE
or IS NULL may take for its property; with the plan-time extraction of
geometries, intervals, ids and attribute bounds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.utils import geometry as geo

MIN_MS = -(2**62)
MAX_MS = 2**62


class Filter:
    pass


@dataclass(frozen=True)
class Include(Filter):
    """Match everything (ECQL INCLUDE)."""


@dataclass(frozen=True)
class Exclude(Filter):
    """Match nothing (ECQL EXCLUDE)."""


@dataclass(frozen=True)
class And(Filter):
    children: Sequence[Filter]


@dataclass(frozen=True)
class Or(Filter):
    children: Sequence[Filter]


@dataclass(frozen=True)
class Not(Filter):
    child: Filter


@dataclass(frozen=True)
class BBox(Filter):
    prop: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float


@dataclass(frozen=True)
class Spatial(Filter):
    """INTERSECTS / CONTAINS / WITHIN / DISJOINT / ... against a literal."""

    op: str
    prop: str
    geom: geo.Geometry


@dataclass(frozen=True)
class DWithin(Filter):
    prop: str
    geom: geo.Geometry
    distance_m: float


@dataclass(frozen=True)
class JsonPath:
    """A property reference into a stored-JSON attribute: the ECQL
    ``jsonPath('$.a.b', attr)`` accessor. It stands where a property name
    does; the filter compiler evaluates it on the host."""

    attr: str
    path: str


@dataclass(frozen=True)
class Compare(Filter):
    """=, <>, <, <=, >, >= on a scalar attribute."""

    prop: "str | JsonPath"
    op: str
    value: object  # float | int | str | bool | np.int64 epoch-ms for dates


# -- expression trees: property against property, arithmetic, functions ------
@dataclass(frozen=True)
class Expr:
    """Scalar expression node."""


@dataclass(frozen=True)
class Prop(Expr):
    name: str


@dataclass(frozen=True)
class Lit(Expr):
    value: object


@dataclass(frozen=True)
class Arith(Expr):
    """Binary arithmetic: + - * /"""

    op: str
    left: Expr
    right: Expr


@dataclass(frozen=True)
class FnCall(Expr):
    """Filter-function call, e.g. ``st_area(geom)``, resolved against
    ``geofn``'s ``st_*`` functions."""

    name: str
    args: Tuple[Expr, ...]


def expr_props(e: Expr) -> List[str]:
    """Attribute names an expression tree reads."""
    if isinstance(e, Prop):
        return [e.name]
    if isinstance(e, Arith):
        return expr_props(e.left) + expr_props(e.right)
    if isinstance(e, FnCall):
        out: List[str] = []
        for a in e.args:
            out.extend(expr_props(a))
        return out
    return []


def expr_has_fn(e: Expr) -> bool:
    if isinstance(e, FnCall):
        return True
    if isinstance(e, Arith):
        return expr_has_fn(e.left) or expr_has_fn(e.right)
    return False


@dataclass(frozen=True)
class ExprCompare(Filter):
    """A comparison where either side is more than a property or a
    literal: ``speed > heading``, ``weight * 2 < limit``,
    ``st_area(geom) > 0.5``."""

    op: str  # = <> < <= > >=
    left: Expr
    right: Expr

    def props(self) -> List[str]:
        return expr_props(self.left) + expr_props(self.right)


@dataclass(frozen=True)
class Between(Filter):
    prop: str
    lo: object
    hi: object


@dataclass(frozen=True)
class In(Filter):
    prop: str
    values: Tuple[object, ...]


@dataclass(frozen=True)
class Like(Filter):
    prop: str
    pattern: str
    case_insensitive: bool = False


@dataclass(frozen=True)
class IsNull(Filter):
    prop: str
    negate: bool = False


@dataclass(frozen=True)
class IdIn(Filter):
    """Feature-id filter (ECQL ``IN ('id1', 'id2')`` with no property)."""

    ids: Tuple[str, ...]


@dataclass(frozen=True)
class During(Filter):
    """Temporal interval, inclusive on both ends."""

    prop: str
    lo_ms: int
    hi_ms: int


@dataclass
class FilterValues:
    """Extracted values plus a 'disjoint' flag (provably-empty query)."""

    values: list
    disjoint: bool = False

    @property
    def is_empty(self):
        return not self.values and not self.disjoint


def extract_geometries(f: Filter, geom_prop: str) -> FilterValues:
    """Query geometries constraining ``geom_prop``: union bounds for Or,
    the more selective side for And; anything not understood widens to
    unbounded (empty list)."""

    def walk(node: Filter) -> Optional[List[geo.Geometry]]:
        # None = unbounded
        if isinstance(node, BBox) and node.prop == geom_prop:
            return [geo.bbox_polygon(node.xmin, node.ymin, node.xmax, node.ymax)]
        if isinstance(node, Spatial) and node.prop == geom_prop:
            return [node.geom] if node.op != "disjoint" else None
        if isinstance(node, DWithin) and node.prop == geom_prop:
            d = node.distance_m / geo.METERS_PER_DEGREE
            b = node.geom.bounds()
            # widen longitude by a latitude-dependent factor (conservative)
            maxlat = min(89.0, max(abs(b[1]), abs(b[3])))
            dx = d / max(np.cos(np.radians(maxlat)), 1e-3)
            return [geo.bbox_polygon(b[0] - dx, b[1] - d, b[2] + dx, b[3] + d)]
        if isinstance(node, And):
            bounds = None
            geoms = None
            for c in node.children:
                g = walk(c)
                if g is None:
                    continue
                if not g:
                    return []  # a provably-empty arm empties the conjunction
                if geoms is None:
                    geoms, bounds = g, _union_bounds(g)
                else:
                    nb = _union_bounds(g)
                    inter = _intersect_bounds(bounds, nb)
                    if inter is None:
                        return []  # provably disjoint
                    if _area(nb) < _area(bounds):
                        geoms = g
                    bounds = inter
            return geoms
        if isinstance(node, Or):
            out = []
            for c in node.children:
                g = walk(c)
                if g is None:
                    return None
                out.extend(g)
            return out
        if isinstance(node, Exclude):
            return []
        return None

    g = walk(f)
    if g is None:
        return FilterValues([])
    if g == []:
        return FilterValues([], disjoint=True)
    return FilterValues(g)


def extract_intervals(f: Filter, dtg_prop: str) -> FilterValues:
    """Temporal [lo_ms, hi_ms] intervals constraining ``dtg_prop``."""

    def walk(node: Filter) -> Optional[List[Tuple[int, int]]]:
        if isinstance(node, During) and node.prop == dtg_prop:
            return [(node.lo_ms, node.hi_ms)]
        if isinstance(node, Compare) and node.prop == dtg_prop:
            v = int(node.value)
            if node.op == "=":
                return [(v, v)]
            if node.op in ("<", "<="):
                return [(MIN_MS, v)]
            if node.op in (">", ">="):
                return [(v, MAX_MS)]
            return None
        if isinstance(node, Between) and node.prop == dtg_prop:
            return [(int(node.lo), int(node.hi))]
        if isinstance(node, And):
            acc = None
            for c in node.children:
                iv = walk(c)
                if iv is None:
                    continue
                if acc is None:
                    acc = iv
                else:
                    merged = []
                    for (a0, a1) in acc:
                        for (b0, b1) in iv:
                            lo, hi = max(a0, b0), min(a1, b1)
                            if lo <= hi:
                                merged.append((lo, hi))
                    if not merged:
                        return []
                    acc = merged
            return acc
        if isinstance(node, Or):
            out = []
            for c in node.children:
                iv = walk(c)
                if iv is None:
                    return None
                out.extend(iv)
            return out
        if isinstance(node, Exclude):
            return []
        return None

    iv = walk(f)
    if iv is None:
        return FilterValues([])
    if iv == []:
        return FilterValues([], disjoint=True)
    return FilterValues(_merge_intervals(iv))


def extract_ids(f: Filter) -> Optional[Tuple[str, ...]]:
    """Feature ids of an ``IdIn`` at the top or under a top-level AND."""
    if isinstance(f, IdIn):
        return f.ids
    if isinstance(f, And):
        for c in f.children:
            ids = extract_ids(c)
            if ids is not None:
                return ids
    return None


def extract_attr_bounds(f: Filter, prop: str) -> FilterValues:
    """Closed value bounds [(lo, hi)] constraining a scalar attribute (None
    = open end): the attribute index's range windows."""

    def walk(node: Filter):
        if isinstance(node, Compare) and node.prop == prop:
            v = node.value
            if node.op == "=":
                return [(v, v)]
            if node.op in ("<", "<="):
                return [(None, v)]
            if node.op in (">", ">="):
                return [(v, None)]
            return None
        if isinstance(node, Between) and node.prop == prop:
            return [(node.lo, node.hi)]
        if isinstance(node, In) and node.prop == prop:
            return [(v, v) for v in node.values]
        if isinstance(node, During) and node.prop == prop:
            return [(node.lo_ms, node.hi_ms)]
        if isinstance(node, And):
            acc = None
            for c in node.children:
                b = walk(c)
                if b is None:
                    continue
                if acc is None:
                    acc = b
                else:
                    merged = []
                    for (a0, a1) in acc:
                        for (b0, b1) in b:
                            lo = b0 if a0 is None else a0 if b0 is None else max(a0, b0)
                            hi = b1 if a1 is None else a1 if b1 is None else min(a1, b1)
                            if lo is None or hi is None or lo <= hi:
                                merged.append((lo, hi))
                    if not merged:
                        return []
                    acc = merged
            return acc
        if isinstance(node, Or):
            out = []
            for c in node.children:
                b = walk(c)
                if b is None:
                    return None
                out.extend(b)
            return out
        if isinstance(node, Exclude):
            return []
        return None

    b = walk(f)
    if b is None:
        return FilterValues([])
    if b == []:
        return FilterValues([], disjoint=True)
    return FilterValues(b)


def _merge_intervals(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    iv = sorted(iv)
    out = [iv[0]]
    for lo, hi in iv[1:]:
        if lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _union_bounds(geoms: List[geo.Geometry]):
    bs = np.asarray([g.bounds() for g in geoms])
    return (bs[:, 0].min(), bs[:, 1].min(), bs[:, 2].max(), bs[:, 3].max())


def _intersect_bounds(a, b):
    lo = (max(a[0], b[0]), max(a[1], b[1]))
    hi = (min(a[2], b[2]), min(a[3], b[3]))
    if lo[0] > hi[0] or lo[1] > hi[1]:
        return None
    return (lo[0], lo[1], hi[0], hi[1])


def _area(b) -> float:
    return max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
