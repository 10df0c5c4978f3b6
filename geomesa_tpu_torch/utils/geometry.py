"""Geometry literals for query predicates (pure NumPy).

Copy of ``geomesa_tpu/utils/geometry.py`` cut to what point-column
predicates need: ``Point`` / ``MultiPoint`` / ``LineString`` /
``MultiLineString`` / ``Polygon`` / ``MultiPolygon`` with bounds, the
rectangle test and exact f64 point membership, the great-circle constants
and ``haversine_m``, WKT parsing, and (from ``geomesa_tpu/geofn.py``) boundary edges and the
on-boundary test. Coordinates are (x=lon, y=lat) degrees.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

EARTH_RADIUS_M = 6_371_008.8
#: meters per degree of latitude (DWITHIN's degree <-> meter conversion)
METERS_PER_DEGREE = 111_319.49079327358


class Geometry:
    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax)"""
        raise NotImplementedError

    def contains_points(self, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        """Vectorized point membership (boundary-inclusive)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Point(Geometry):
    x: float
    y: float

    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    def contains_points(self, xs, ys):
        return (np.asarray(xs) == self.x) & (np.asarray(ys) == self.y)


@dataclass(frozen=True)
class MultiPoint(Geometry):
    points: Tuple[Point, ...]

    def bounds(self):
        xs = [p.x for p in self.points]
        ys = [p.y for p in self.points]
        return (min(xs), min(ys), max(xs), max(ys))

    def contains_points(self, xs, ys):
        m = np.zeros(len(np.asarray(xs)), dtype=bool)
        for p in self.points:
            m |= p.contains_points(xs, ys)
        return m


@dataclass(frozen=True)
class LineString(Geometry):
    coords: Tuple[Tuple[float, float], ...]

    def bounds(self):
        a = np.asarray(self.coords)
        return (a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max())

    def contains_points(self, xs, ys):
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        m = np.zeros(xs.shape, dtype=bool)
        a = np.asarray(self.coords)
        for i in range(len(a) - 1):
            m |= _on_segment(xs, ys, a[i], a[i + 1])
        return m


@dataclass(frozen=True)
class MultiLineString(Geometry):
    lines: Tuple[LineString, ...]

    def bounds(self):
        bs = np.asarray([ls.bounds() for ls in self.lines])
        return (float(bs[:, 0].min()), float(bs[:, 1].min()),
                float(bs[:, 2].max()), float(bs[:, 3].max()))

    def contains_points(self, xs, ys):
        m = np.zeros(np.asarray(xs).shape, dtype=bool)
        for ls in self.lines:
            m |= ls.contains_points(xs, ys)
        return m


@dataclass(frozen=True)
class Polygon(Geometry):
    shell: Tuple[Tuple[float, float], ...]  # closed or open ring
    holes: Tuple[Tuple[Tuple[float, float], ...], ...] = ()

    def bounds(self):
        a = np.asarray(self.shell)
        return (float(a[:, 0].min()), float(a[:, 1].min()),
                float(a[:, 0].max()), float(a[:, 1].max()))

    def rings(self):
        return [np.asarray(_close_ring(self.shell), np.float64)] + [
            np.asarray(_close_ring(h), np.float64) for h in self.holes
        ]

    def is_rectangle(self) -> bool:
        """Axis-aligned rectangle test (the loose-bbox fast path)."""
        if self.holes:
            return False
        r = np.asarray(_close_ring(self.shell), np.float64)
        if len(r) != 5:
            return False
        xmin, ymin, xmax, ymax = self.bounds()
        corners = {(xmin, ymin), (xmin, ymax), (xmax, ymin), (xmax, ymax)}
        return {(float(x), float(y)) for x, y in r[:4]} == corners

    def contains_points(self, xs, ys):
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        inside = _ring_contains(np.asarray(_close_ring(self.shell), np.float64), xs, ys)
        for h in self.holes:
            hr = np.asarray(_close_ring(h), np.float64)
            inside &= ~_ring_contains_open(hr, xs, ys)
        return inside


@dataclass(frozen=True)
class MultiPolygon(Geometry):
    polygons: Tuple[Polygon, ...]

    def bounds(self):
        bs = np.asarray([p.bounds() for p in self.polygons])
        return (float(bs[:, 0].min()), float(bs[:, 1].min()),
                float(bs[:, 2].max()), float(bs[:, 3].max()))

    def contains_points(self, xs, ys):
        m = np.zeros(np.asarray(xs).shape, dtype=bool)
        for p in self.polygons:
            m |= p.contains_points(xs, ys)
        return m


def _close_ring(r: Sequence[Tuple[float, float]]):
    r = list(r)
    if r[0] != r[-1]:
        r = r + [r[0]]
    return tuple(tuple(p) for p in r)


# -- exact f64 ring membership (crossing number + boundary inclusion) --------
def _ring_crossings(ring: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Crossing-number parity: True where (x, y) is strictly inside."""
    x1, y1 = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    xs = xs[:, None]
    ys = ys[:, None]
    cond = (y1[None, :] > ys) != (y2[None, :] > ys)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1[None, :] + (ys - y1[None, :]) * (x2 - x1)[None, :] / np.where(
            (y2 - y1)[None, :] == 0, 1.0, (y2 - y1)[None, :]
        )
    crossings = (cond & (xs < xint)).sum(axis=1)
    return (crossings % 2) == 1


def _on_boundary(ring: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    m = np.zeros(xs.shape, dtype=bool)
    for i in range(len(ring) - 1):
        m |= _on_segment(xs, ys, ring[i], ring[i + 1])
    return m


def _on_segment(xs, ys, a, b, eps: float = 1e-12) -> np.ndarray:
    ax, ay = float(a[0]), float(a[1])
    bx, by = float(b[0]), float(b[1])
    cross = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
    within = (
        (xs >= min(ax, bx) - eps) & (xs <= max(ax, bx) + eps)
        & (ys >= min(ay, by) - eps) & (ys <= max(ay, by) + eps)
    )
    scale = max(abs(bx - ax), abs(by - ay), 1.0)
    return within & (np.abs(cross) <= eps * scale)


def _ring_contains(ring: np.ndarray, xs, ys) -> np.ndarray:
    """Boundary-inclusive containment (INTERSECTS semantics)."""
    return _ring_crossings(ring, xs, ys) | _on_boundary(ring, xs, ys)


def _ring_contains_open(ring: np.ndarray, xs, ys) -> np.ndarray:
    """Strict interior (points on a hole's boundary stay in the polygon)."""
    return _ring_crossings(ring, xs, ys) & ~_on_boundary(ring, xs, ys)


def edges(g: Geometry) -> np.ndarray:
    """[E, 4] (x1, y1, x2, y2) boundary segments of a line or polygon."""
    if isinstance(g, LineString):
        a = np.asarray(g.coords, np.float64)
        return np.concatenate([a[:-1], a[1:]], axis=1)
    if isinstance(g, MultiLineString):
        return np.concatenate([edges(ls) for ls in g.lines])
    if isinstance(g, Polygon):
        return np.concatenate([np.concatenate([r[:-1], r[1:]], axis=1)
                               for r in g.rings()])
    if isinstance(g, MultiPolygon):
        return np.concatenate([edges(p) for p in g.polygons])
    raise ValueError(f"no edges for {type(g).__name__}")


def on_boundary_of(g: Geometry, xs, ys) -> np.ndarray:
    """Exact f64 test of points on the boundary segments of ``g``."""
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    out = np.zeros(xs.shape, dtype=bool)
    if isinstance(g, (Point, MultiPoint)):
        return out
    for e in edges(g):
        out |= _on_segment(xs, ys, e[:2], e[2:])
    return out


# -- WKT -----------------------------------------------------------------------
_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def parse_wkt(text: str) -> Geometry:
    """Parse POINT / MULTIPOINT / LINESTRING / MULTILINESTRING / POLYGON /
    MULTIPOLYGON / ENVELOPE WKT."""
    s = text.strip()
    m = re.match(r"^\s*([A-Za-z]+)\s*(.*)$", s, re.S)
    if not m:
        raise ValueError(f"invalid WKT: {text!r}")
    tag = m.group(1).upper()
    body = m.group(2).strip()

    def coords(chunk: str):
        pts = []
        for pair in chunk.split(","):
            nums = re.findall(_NUM, pair)
            if len(nums) < 2:
                raise ValueError(f"invalid WKT coordinates: {pair!r}")
            pts.append((float(nums[0]), float(nums[1])))
        return tuple(pts)

    def rings(chunk: str):
        return [coords(rm.group(1)) for rm in re.finditer(r"\(([^()]*)\)", chunk)]

    if tag == "POINT":
        nums = re.findall(_NUM, body)
        return Point(float(nums[0]), float(nums[1]))
    if tag == "MULTIPOINT":
        pts = coords(body.replace("(", " ").replace(")", " "))
        return MultiPoint(tuple(Point(x, y) for x, y in pts))
    if tag == "LINESTRING":
        return LineString(coords(body.strip("() ")))
    if tag == "MULTILINESTRING":
        return MultiLineString(tuple(LineString(r) for r in rings(body)))
    if tag == "POLYGON":
        rs = rings(body)
        if not rs:
            raise ValueError(f"invalid POLYGON WKT: {text!r}")
        return Polygon(rs[0], tuple(rs[1:]))
    if tag == "MULTIPOLYGON":
        # strip the outer paren, then split polygon groups at depth 0
        first, last = body.find("("), body.rfind(")")
        if first < 0 or last <= first:
            raise ValueError(f"invalid MULTIPOLYGON WKT: {text!r}")
        body = body[first + 1 : last]
        polys = []
        depth = 0
        start = None
        for i, ch in enumerate(body):
            if ch == "(":
                if depth == 0:
                    start = i
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    rs = rings(body[start + 1 : i])
                    polys.append(Polygon(rs[0], tuple(rs[1:])))
        if not polys:
            raise ValueError(f"invalid MULTIPOLYGON WKT: {text!r}")
        return MultiPolygon(tuple(polys))
    if tag == "ENVELOPE":  # ECQL extension: ENVELOPE(xmin, xmax, ymin, ymax)
        nums = [float(v) for v in re.findall(_NUM, body)]
        xmin, xmax, ymin, ymax = nums[:4]
        return bbox_polygon(xmin, ymin, xmax, ymax)
    raise ValueError(f"unsupported WKT type: {tag}")


def bbox_polygon(xmin: float, ymin: float, xmax: float, ymax: float) -> Polygon:
    return Polygon(((xmin, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax), (xmin, ymin)))


def haversine_m(x1, y1, x2, y2):
    """Great-circle distance in metres, vectorized (degrees in, f64)."""
    rx1, ry1, rx2, ry2 = (np.radians(np.asarray(v, np.float64)) for v in (x1, y1, x2, y2))
    dlat = ry2 - ry1
    dlon = rx2 - rx1
    a = np.sin(dlat / 2) ** 2 + np.cos(ry1) * np.cos(ry2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
