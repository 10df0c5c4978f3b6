"""Pure-numpy geometry substrate (no JTS/GEOS/shapely dependency).

Copy of ``geomesa_tpu/utils/geometry.py``.

Role parity with the reference's JTS usage (SURVEY.md §2.1 "Geometry utils"):
WKT parse/format, bounds, rectangularity, point-in-polygon, and distance — the
operations the filter compiler and processes need. Plan-time ops are scalar
Python/numpy; predicate evaluation is exposed as **padded vertex/edge buffers**
so the same test runs vectorized on device (N points × E edges).

Coordinates are (x=lon, y=lat) degrees, matching the reference's default CRS
handling (EPSG:4326).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

EARTH_RADIUS_M = 6_371_008.8
# meters per degree of latitude (used for degree<->meter conversions in
# DWITHIN, mirroring GeoTools' approximate geodesic handling for 4326)
METERS_PER_DEGREE = 111_319.49079327358


class Geometry:
    kind: str = "geometry"

    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax)"""
        raise NotImplementedError

    def wkt(self) -> str:
        raise NotImplementedError

    def contains_points(self, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
        """Vectorized point-membership test (boundary-inclusive)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Point(Geometry):
    x: float
    y: float
    kind = "point"

    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    def wkt(self):
        return f"POINT ({_fmt(self.x)} {_fmt(self.y)})"

    def contains_points(self, xs, ys):
        return (np.asarray(xs) == self.x) & (np.asarray(ys) == self.y)


@dataclass(frozen=True)
class MultiPoint(Geometry):
    points: Tuple[Point, ...]
    kind = "multipoint"

    def bounds(self):
        xs = [p.x for p in self.points]
        ys = [p.y for p in self.points]
        return (min(xs), min(ys), max(xs), max(ys))

    def wkt(self):
        inner = ", ".join(f"({_fmt(p.x)} {_fmt(p.y)})" for p in self.points)
        return f"MULTIPOINT ({inner})"

    def contains_points(self, xs, ys):
        m = np.zeros(len(np.asarray(xs)), dtype=bool)
        for p in self.points:
            m |= p.contains_points(xs, ys)
        return m


@dataclass(frozen=True)
class LineString(Geometry):
    coords: Tuple[Tuple[float, float], ...]  # ((x, y), ...)
    kind = "linestring"

    def bounds(self):
        a = np.asarray(self.coords)
        return (a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max())

    def wkt(self):
        inner = ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in self.coords)
        return f"LINESTRING ({inner})"

    def contains_points(self, xs, ys):
        # Points exactly on a segment; rarely used as a predicate — epsilon test.
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        m = np.zeros(xs.shape, dtype=bool)
        a = np.asarray(self.coords)
        for i in range(len(a) - 1):
            m |= _on_segment(xs, ys, a[i], a[i + 1])
        return m


@dataclass(frozen=True)
class MultiLineString(Geometry):
    lines: Tuple["LineString", ...]
    kind = "multilinestring"

    def bounds(self):
        bs = np.asarray([ls.bounds() for ls in self.lines])
        return (float(bs[:, 0].min()), float(bs[:, 1].min()),
                float(bs[:, 2].max()), float(bs[:, 3].max()))

    def wkt(self):
        def seg(ls: "LineString"):
            return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in ls.coords) + ")"

        return "MULTILINESTRING (" + ", ".join(seg(ls) for ls in self.lines) + ")"

    def contains_points(self, xs, ys):
        m = np.zeros(np.asarray(xs).shape, dtype=bool)
        for ls in self.lines:
            m |= ls.contains_points(xs, ys)
        return m


@dataclass(frozen=True)
class Polygon(Geometry):
    shell: Tuple[Tuple[float, float], ...]  # closed or open ring
    holes: Tuple[Tuple[Tuple[float, float], ...], ...] = ()
    kind = "polygon"

    def bounds(self):
        a = np.asarray(self.shell)
        return (float(a[:, 0].min()), float(a[:, 1].min()),
                float(a[:, 0].max()), float(a[:, 1].max()))

    def wkt(self):
        def ring(r):
            r = _close_ring(r)
            return "(" + ", ".join(f"{_fmt(x)} {_fmt(y)}" for x, y in r) + ")"

        inner = ", ".join([ring(self.shell)] + [ring(h) for h in self.holes])
        return f"POLYGON ({inner})"

    def rings(self) -> List[np.ndarray]:
        return [np.asarray(_close_ring(self.shell), np.float64)] + [
            np.asarray(_close_ring(h), np.float64) for h in self.holes
        ]

    def is_rectangle(self) -> bool:
        """Axis-aligned rectangle test — enables the reference's loose-bbox
        fast path (Z3IndexKeySpace.useFullFilter:235)."""
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
    kind = "multipolygon"

    def bounds(self):
        bs = np.asarray([p.bounds() for p in self.polygons])
        return (float(bs[:, 0].min()), float(bs[:, 1].min()),
                float(bs[:, 2].max()), float(bs[:, 3].max()))

    def wkt(self):
        def poly(p: Polygon):
            return p.wkt()[len("POLYGON "):]

        return "MULTIPOLYGON (" + ", ".join(poly(p) for p in self.polygons) + ")"

    def contains_points(self, xs, ys):
        m = np.zeros(np.asarray(xs).shape, dtype=bool)
        for p in self.polygons:
            m |= p.contains_points(xs, ys)
        return m


# ---------------------------------------------------------------------------
# Ring membership (crossing number + boundary inclusion), vectorized
# ---------------------------------------------------------------------------

def _close_ring(r: Sequence[Tuple[float, float]]):
    r = list(r)
    if r[0] != r[-1]:
        r = r + [r[0]]
    return tuple(tuple(p) for p in r)


def _ring_crossings(ring: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Crossing-number parity: True where (x, y) is strictly inside the ring."""
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
    """Boundary-inclusive containment (ECQL CONTAINS/INTERSECTS semantics)."""
    return _ring_crossings(ring, xs, ys) | _on_boundary(ring, xs, ys)


def _ring_contains_open(ring: np.ndarray, xs, ys) -> np.ndarray:
    """Strict interior (points on a hole's boundary remain in the polygon)."""
    return _ring_crossings(ring, xs, ys) & ~_on_boundary(ring, xs, ys)


# ---------------------------------------------------------------------------
# Padded edge buffers: the device representation of polygon predicates
# ---------------------------------------------------------------------------

def polygon_edge_buffers(geom: Geometry, pad_to: Optional[int] = None):
    """Flatten a (Multi)Polygon into padded edge arrays for the device PIP
    kernel: returns dict of float32 arrays ``x1,y1,x2,y2`` (shape [E]),
    ``ring_sign`` (+1 shell, -1 hole), and int32 ``poly_id`` per edge.

    The device kernel computes, per polygon, crossing parity over shell edges
    minus hole edges; padding edges are degenerate (zero-length at NaN-safe
    coords) and contribute no crossings.
    """
    polys = geom.polygons if isinstance(geom, MultiPolygon) else (geom,)
    x1s, y1s, x2s, y2s, signs, pids = [], [], [], [], [], []
    for pid, p in enumerate(polys):
        rings = [(np.asarray(_close_ring(p.shell), np.float64), 1)] + [
            (np.asarray(_close_ring(h), np.float64), -1) for h in p.holes
        ]
        for ring, sign in rings:
            x1s.append(ring[:-1, 0]); y1s.append(ring[:-1, 1])
            x2s.append(ring[1:, 0]); y2s.append(ring[1:, 1])
            signs.append(np.full(len(ring) - 1, sign, np.int32))
            pids.append(np.full(len(ring) - 1, pid, np.int32))
    out = {
        "x1": np.concatenate(x1s), "y1": np.concatenate(y1s),
        "x2": np.concatenate(x2s), "y2": np.concatenate(y2s),
        "sign": np.concatenate(signs), "poly_id": np.concatenate(pids),
        "n_polys": len(polys),
    }
    e = len(out["x1"])
    target = pad_to or e
    if target > e:
        padn = target - e
        for k in ("x1", "y1", "x2", "y2"):
            out[k] = np.concatenate([out[k], np.full(padn, 1e30)])
        out["sign"] = np.concatenate([out["sign"], np.zeros(padn, np.int32)])
        out["poly_id"] = np.concatenate([out["poly_id"], np.zeros(padn, np.int32)])
    return out


# ---------------------------------------------------------------------------
# Distance
# ---------------------------------------------------------------------------

def haversine_m(x1, y1, x2, y2):
    """Great-circle distance in meters, vectorized (degrees in)."""
    rx1, ry1, rx2, ry2 = (np.radians(np.asarray(v, np.float64)) for v in (x1, y1, x2, y2))
    dlat = ry2 - ry1
    dlon = rx2 - rx1
    a = np.sin(dlat / 2) ** 2 + np.cos(ry1) * np.cos(ry2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


# ---------------------------------------------------------------------------
# WKT
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    # shortest round-trip representation: WKT is the master store for
    # extent geometries, so formatting must never lose f64 precision
    # (exact-predicate refinement parses it back)
    return repr(float(v))


_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def parse_wkt(text: str) -> Geometry:
    """Parse POINT / MULTIPOINT / LINESTRING / POLYGON / MULTIPOLYGON WKT."""
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
        out = []
        for rm in re.finditer(r"\(([^()]*)\)", chunk):
            out.append(coords(rm.group(1)))
        return out

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
        # strip the outer wrapper paren, then split polygon groups by
        # balanced parens at depth 0
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


def bounds_intersect(a, b) -> bool:
    return a[0] <= b[2] and a[2] >= b[0] and a[1] <= b[3] and a[3] >= b[1]
