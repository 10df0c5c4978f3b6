"""Vectorized geo-function library — the ``st_*`` UDF surface.

Copy of ``geomesa_tpu/geofn.py``, with ``_shape_to_json`` (which the JAX
package keeps in ``io/geojson.py``) copied in for ``st_asGeoJSON``.

Role parity with the reference's Spark JTS UDFs
(geomesa-spark/geomesa-spark-jts/.../udf/*FunctionFactory-style modules:
GeometricConstructorFunctions, GeometricAccessorFunctions,
GeometricOutputFunctions, GeometricProcessingFunctions,
SpatialRelationFunctions, GeometricCastFunctions — ~80 ``st_*`` functions):
the same names and semantics, but implemented over this framework's pure
numpy geometry substrate, with array fast paths where the operation is a
per-point kernel (relations against a literal geometry, distance, geohash
encode) so the hot forms vectorize instead of iterating JTS objects.

Scalar forms take/return :mod:`geomesa_tpu_torch.utils.geometry` objects (or WKT
strings — every geometry argument may be WKT). Array forms accept numpy
arrays and broadcast. Object-array forms (`arr=` object ndarray of
geometries) map the scalar op.

Precision notes: planar ops (area/length/distance/intersection) are in
degree space like the JTS defaults; *Sphere variants use the haversine great
circle on WGS84's mean radius.
"""

from __future__ import annotations

import json
import math
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from geomesa_tpu_torch.utils import geometry as geo
from geomesa_tpu_torch.utils.geometry import (
    EARTH_RADIUS_M, METERS_PER_DEGREE, Geometry, LineString, MultiLineString,
    MultiPoint, MultiPolygon, Point, Polygon, bbox_polygon, haversine_m,
    parse_wkt,
)

GeomLike = Union[Geometry, str]


def _geom(g: GeomLike) -> Geometry:
    return parse_wkt(g) if isinstance(g, str) else g


def _map(fn, arr):
    """Map a scalar op over an object array of geometries (None-safe)."""
    out = np.empty(len(arr), dtype=object)
    for i, g in enumerate(arr):
        out[i] = None if g is None else fn(_geom(g))
    return out


# ===========================================================================
# Constructors (GeometricConstructorFunctions)
# ===========================================================================

def st_makePoint(x, y):
    """Scalar -> Point; arrays -> object array of Points (use raw (x, y)
    columns for device work — this is the object-level constructor)."""
    if np.ndim(x) == 0:
        return Point(float(x), float(y))
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    out = np.empty(len(x), dtype=object)
    for i in range(len(x)):
        out[i] = Point(float(x[i]), float(y[i]))
    return out


st_point = st_makePoint


def st_makePointM(x, y, m):  # measure is carried nowhere; parity signature
    return st_makePoint(x, y)


def st_makeLine(points: Sequence[GeomLike]) -> LineString:
    pts = [_geom(p) for p in points]
    return LineString(tuple((p.x, p.y) for p in pts))


def st_makePolygon(shell: GeomLike) -> Polygon:
    s = _geom(shell)
    if not isinstance(s, LineString):
        raise ValueError("st_makePolygon takes a closed LineString shell")
    return Polygon(tuple(s.coords))


def st_makeBBOX(xmin: float, ymin: float, xmax: float, ymax: float) -> Polygon:
    return bbox_polygon(float(xmin), float(ymin), float(xmax), float(ymax))


st_makeBox2D_doc = "corner points -> bbox polygon"


def st_makeBox2D(ll: GeomLike, ur: GeomLike) -> Polygon:
    a, b = _geom(ll), _geom(ur)
    return bbox_polygon(a.x, a.y, b.x, b.y)


def st_geomFromWKT(wkt) -> Geometry:
    if isinstance(wkt, np.ndarray):
        return _map(lambda g: g, wkt)
    return parse_wkt(wkt)


st_geomFromText = st_geomFromWKT
st_geometryFromText = st_geomFromWKT


def _typed_from_text(wkt, cls, name):
    g = parse_wkt(wkt) if isinstance(wkt, str) else wkt
    if not isinstance(g, cls):
        raise ValueError(f"{name}: WKT is a {type(g).__name__}")
    return g


def st_pointFromText(wkt) -> Point:
    return _typed_from_text(wkt, Point, "st_pointFromText")


def st_lineFromText(wkt) -> LineString:
    return _typed_from_text(wkt, LineString, "st_lineFromText")


def st_polygonFromText(wkt) -> Polygon:
    return _typed_from_text(wkt, Polygon, "st_polygonFromText")


st_polygon = st_polygonFromText


def st_mPointFromText(wkt) -> MultiPoint:
    return _typed_from_text(wkt, MultiPoint, "st_mPointFromText")


def st_mLineFromText(wkt) -> MultiLineString:
    return _typed_from_text(wkt, MultiLineString, "st_mLineFromText")


def st_mPolyFromText(wkt) -> MultiPolygon:
    return _typed_from_text(wkt, MultiPolygon, "st_mPolyFromText")


def st_geomFromGeoJSON(doc) -> Geometry:
    d = json.loads(doc) if isinstance(doc, str) else doc
    t = d["type"]
    c = d.get("coordinates")
    if t == "Point":
        return Point(float(c[0]), float(c[1]))
    if t == "MultiPoint":
        return MultiPoint(tuple(Point(float(p[0]), float(p[1])) for p in c))
    if t == "LineString":
        return LineString(tuple((float(p[0]), float(p[1])) for p in c))
    if t == "MultiLineString":
        return MultiLineString(
            tuple(LineString(tuple((float(p[0]), float(p[1])) for p in ls)) for ls in c)
        )
    if t == "Polygon":
        rings = [tuple((float(p[0]), float(p[1])) for p in r) for r in c]
        return Polygon(rings[0], tuple(rings[1:]))
    if t == "MultiPolygon":
        polys = []
        for pc in c:
            rings = [tuple((float(p[0]), float(p[1])) for p in r) for r in pc]
            polys.append(Polygon(rings[0], tuple(rings[1:])))
        return MultiPolygon(tuple(polys))
    raise ValueError(f"unsupported GeoJSON geometry type {t!r}")


# ===========================================================================
# WKB (GeometricOutputFunctions st_asBinary / constructors st_geomFromWKB)
# ===========================================================================

_WKB_TYPES = {
    "point": 1, "linestring": 2, "polygon": 3,
    "multipoint": 4, "multilinestring": 5, "multipolygon": 6,
}


def _wkb_encode(g: Geometry) -> bytes:
    """Little-endian ISO WKB."""
    def header(t):
        return struct.pack("<BI", 1, t)

    def pts(seq):
        return struct.pack("<I", len(seq)) + b"".join(
            struct.pack("<dd", float(x), float(y)) for x, y in seq
        )

    if isinstance(g, Point):
        return header(1) + struct.pack("<dd", g.x, g.y)
    if isinstance(g, LineString):
        return header(2) + pts(g.coords)
    if isinstance(g, Polygon):
        rings = [geo._close_ring(g.shell)] + [geo._close_ring(h) for h in g.holes]
        return header(3) + struct.pack("<I", len(rings)) + b"".join(pts(r) for r in rings)
    if isinstance(g, MultiPoint):
        return header(4) + struct.pack("<I", len(g.points)) + b"".join(
            _wkb_encode(p) for p in g.points
        )
    if isinstance(g, MultiLineString):
        return header(5) + struct.pack("<I", len(g.lines)) + b"".join(
            _wkb_encode(ls) for ls in g.lines
        )
    if isinstance(g, MultiPolygon):
        return header(6) + struct.pack("<I", len(g.polygons)) + b"".join(
            _wkb_encode(p) for p in g.polygons
        )
    raise ValueError(f"cannot WKB-encode {type(g).__name__}")


def _wkb_decode(buf: bytes, off: int = 0) -> Tuple[Geometry, int]:
    bo = "<" if buf[off] == 1 else ">"
    (t,) = struct.unpack_from(bo + "I", buf, off + 1)
    off += 5
    t &= 0xFF  # mask any SRID/dimension flags

    def pts(off):
        (n,) = struct.unpack_from(bo + "I", buf, off)
        off += 4
        out = []
        for _ in range(n):
            x, y = struct.unpack_from(bo + "dd", buf, off)
            out.append((x, y))
            off += 16
        return tuple(out), off

    if t == 1:
        x, y = struct.unpack_from(bo + "dd", buf, off)
        return Point(x, y), off + 16
    if t == 2:
        c, off = pts(off)
        return LineString(c), off
    if t == 3:
        (nr,) = struct.unpack_from(bo + "I", buf, off)
        off += 4
        rings = []
        for _ in range(nr):
            r, off = pts(off)
            rings.append(r)
        return Polygon(rings[0], tuple(rings[1:])), off
    if t in (4, 5, 6):
        (n,) = struct.unpack_from(bo + "I", buf, off)
        off += 4
        parts = []
        for _ in range(n):
            g, off = _wkb_decode(buf, off)
            parts.append(g)
        if t == 4:
            return MultiPoint(tuple(parts)), off
        if t == 5:
            return MultiLineString(tuple(parts)), off
        return MultiPolygon(tuple(parts)), off
    raise ValueError(f"unsupported WKB type {t}")


def st_asBinary(g: GeomLike) -> bytes:
    return _wkb_encode(_geom(g))


def st_byteArray(s: str) -> bytes:
    return s.encode("utf-8")


def st_geomFromWKB(buf: bytes) -> Geometry:
    return _wkb_decode(bytes(buf))[0]


def st_pointFromWKB(buf: bytes) -> Point:
    g = st_geomFromWKB(buf)
    if not isinstance(g, Point):
        raise ValueError("st_pointFromWKB: WKB is not a point")
    return g


# ===========================================================================
# Outputs (GeometricOutputFunctions)
# ===========================================================================

def st_asText(g):
    if isinstance(g, np.ndarray):
        return _map(lambda x: x.wkt(), g)
    return _geom(g).wkt()


def _shape_to_json(g: geo.Geometry) -> dict:
    if isinstance(g, geo.Point):
        return {"type": "Point", "coordinates": [g.x, g.y]}
    if isinstance(g, geo.LineString):
        return {"type": "LineString", "coordinates": [list(p) for p in g.coords]}
    if isinstance(g, geo.Polygon):
        rings = [g.shell] + list(g.holes)
        return {
            "type": "Polygon",
            "coordinates": [[list(p) for p in r] for r in rings],
        }
    if isinstance(g, geo.MultiPoint):
        return {"type": "MultiPoint", "coordinates": [[p.x, p.y] for p in g.points]}
    if isinstance(g, geo.MultiLineString):
        return {
            "type": "MultiLineString",
            "coordinates": [[list(p) for p in ls.coords] for ls in g.lines],
        }
    if isinstance(g, geo.MultiPolygon):
        return {
            "type": "MultiPolygon",
            "coordinates": [
                [[list(p) for p in ring] for ring in [poly.shell] + list(poly.holes)]
                for poly in g.polygons
            ],
        }
    raise ValueError(f"cannot encode {type(g).__name__} as GeoJSON")


def st_asGeoJSON(g: GeomLike) -> str:
    return json.dumps(_shape_to_json(_geom(g)))


def st_asLatLonText(g: GeomLike) -> str:
    p = _geom(g)
    if not isinstance(p, Point):
        raise ValueError("st_asLatLonText takes a point")

    def dms(v, pos, neg):
        h = pos if v >= 0 else neg
        v = abs(v)
        d = int(v)
        m = int((v - d) * 60)
        s = (v - d - m / 60) * 3600
        return f"{d}°{m:02d}'{s:06.3f}\"{h}"

    return f"{dms(p.y, 'N', 'S')} {dms(p.x, 'E', 'W')}"


# ===========================================================================
# GeoHash (st_geoHash family; reference utils/geohash/)
# ===========================================================================

_GH32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_GH32_INV = {c: i for i, c in enumerate(_GH32)}


def geohash_encode(x, y, precision_bits: int) -> np.ndarray:
    """Vectorized geohash of (lon, lat) arrays at ``precision_bits``
    (multiple of 5 -> precision_bits/5 base-32 chars). Bit interleave starts
    with longitude, matching the standard."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    y = np.atleast_1d(np.asarray(y, np.float64))
    nlon = (precision_bits + 1) // 2
    nlat = precision_bits // 2
    ix = np.clip(((x + 180.0) / 360.0 * (1 << nlon)).astype(np.uint64), 0, (1 << nlon) - 1)
    iy = np.clip(((y + 90.0) / 180.0 * (1 << nlat)).astype(np.uint64), 0, (1 << nlat) - 1)
    # interleave: bit k of result (from MSB, k=0 is lon MSB)
    bits = np.zeros(x.shape, np.uint64)
    for k in range(precision_bits):
        if k % 2 == 0:  # longitude bit
            src = (ix >> np.uint64(nlon - 1 - k // 2)) & np.uint64(1)
        else:
            src = (iy >> np.uint64(nlat - 1 - k // 2)) & np.uint64(1)
        bits = (bits << np.uint64(1)) | src
    nchars = precision_bits // 5
    out = np.empty(x.shape, dtype=object)
    for i in range(len(out)):
        v = int(bits[i])
        s = ""
        for c in range(nchars):
            s = _GH32[v & 31] + s
            v >>= 5
        out[i] = s
    return out


def geohash_decode_bbox(h: str) -> Tuple[float, float, float, float]:
    xmin, xmax, ymin, ymax = -180.0, 180.0, -90.0, 90.0
    lon_turn = True
    for ch in h:
        v = _GH32_INV[ch]
        for b in (16, 8, 4, 2, 1):
            if lon_turn:
                mid = (xmin + xmax) / 2
                if v & b:
                    xmin = mid
                else:
                    xmax = mid
            else:
                mid = (ymin + ymax) / 2
                if v & b:
                    ymin = mid
                else:
                    ymax = mid
            lon_turn = not lon_turn
    return xmin, ymin, xmax, ymax


def st_geoHash(g, precision_bits: int = 25):
    """Geometry (or x/y arrays via st_geoHash((x, y), bits)) -> geohash."""
    if isinstance(g, tuple) and len(g) == 2 and np.ndim(g[0]) > 0:
        return geohash_encode(g[0], g[1], precision_bits)
    p = _geom(g)
    if not isinstance(p, Point):
        xmin, ymin, xmax, ymax = p.bounds()
        p = Point((xmin + xmax) / 2, (ymin + ymax) / 2)
    return geohash_encode([p.x], [p.y], precision_bits)[0]


def st_geomFromGeoHash(h: str, prec: Optional[int] = None) -> Polygon:
    s = h if prec is None else h[: max(1, prec // 5)]
    return bbox_polygon(*geohash_decode_bbox(s))


st_box2DFromGeoHash = st_geomFromGeoHash


def st_pointFromGeoHash(h: str, prec: Optional[int] = None) -> Point:
    xmin, ymin, xmax, ymax = st_geomFromGeoHash(h, prec).bounds()
    return Point((xmin + xmax) / 2, (ymin + ymax) / 2)


# ===========================================================================
# Accessors (GeometricAccessorFunctions)
# ===========================================================================

def st_x(g):
    if isinstance(g, np.ndarray) and g.dtype == object:
        return np.array([_geom(p).x if p is not None else np.nan for p in g])
    p = _geom(g)
    return p.x if isinstance(p, Point) else None


def st_y(g):
    if isinstance(g, np.ndarray) and g.dtype == object:
        return np.array([_geom(p).y if p is not None else np.nan for p in g])
    p = _geom(g)
    return p.y if isinstance(p, Point) else None


def st_envelope(g: GeomLike) -> Geometry:
    gm = _geom(g)
    xmin, ymin, xmax, ymax = gm.bounds()
    if xmin == xmax and ymin == ymax:
        return Point(xmin, ymin)
    return bbox_polygon(xmin, ymin, xmax, ymax)


def st_exteriorRing(g: GeomLike) -> Optional[LineString]:
    gm = _geom(g)
    if not isinstance(gm, Polygon):
        return None
    return LineString(tuple(map(tuple, geo._close_ring(gm.shell))))


def st_interiorRingN(g: GeomLike, n: int) -> Optional[LineString]:
    gm = _geom(g)
    if not isinstance(gm, Polygon) or n >= len(gm.holes):
        return None
    return LineString(tuple(map(tuple, geo._close_ring(gm.holes[n]))))


def _parts(g: Geometry) -> List[Geometry]:
    if isinstance(g, MultiPoint):
        return list(g.points)
    if isinstance(g, MultiLineString):
        return list(g.lines)
    if isinstance(g, MultiPolygon):
        return list(g.polygons)
    return [g]


def st_geometryN(g: GeomLike, n: int) -> Optional[Geometry]:
    parts = _parts(_geom(g))
    return parts[n] if 0 <= n < len(parts) else None


def st_numGeometries(g: GeomLike) -> int:
    return len(_parts(_geom(g)))


def _coords_of(g: Geometry) -> np.ndarray:
    if isinstance(g, Point):
        return np.array([[g.x, g.y]])
    if isinstance(g, MultiPoint):
        return np.array([[p.x, p.y] for p in g.points])
    if isinstance(g, LineString):
        return np.asarray(g.coords, np.float64)
    if isinstance(g, MultiLineString):
        return np.concatenate([np.asarray(ls.coords, np.float64) for ls in g.lines])
    if isinstance(g, Polygon):
        return np.concatenate([r for r in g.rings()])
    if isinstance(g, MultiPolygon):
        return np.concatenate([_coords_of(p) for p in g.polygons])
    raise ValueError(type(g).__name__)


def st_numPoints(g: GeomLike) -> int:
    return len(_coords_of(_geom(g)))


def st_pointN(g: GeomLike, n: int) -> Optional[Point]:
    gm = _geom(g)
    if not isinstance(gm, LineString):
        return None
    if n < 0:
        n += len(gm.coords)
    if not (0 <= n < len(gm.coords)):
        return None
    return Point(*gm.coords[n])


def st_coordDim(g: GeomLike) -> int:
    return 2


def st_dimension(g: GeomLike) -> int:
    gm = _geom(g)
    if isinstance(gm, (Point, MultiPoint)):
        return 0
    if isinstance(gm, (LineString, MultiLineString)):
        return 1
    return 2


def st_geometryType(g: GeomLike) -> str:
    return {
        "point": "Point", "multipoint": "MultiPoint",
        "linestring": "LineString", "multilinestring": "MultiLineString",
        "polygon": "Polygon", "multipolygon": "MultiPolygon",
    }[_geom(g).kind]


def st_isClosed(g: GeomLike) -> bool:
    gm = _geom(g)
    if isinstance(gm, LineString):
        return len(gm.coords) > 2 and gm.coords[0] == gm.coords[-1]
    if isinstance(gm, MultiLineString):
        return all(st_isClosed(ls) for ls in gm.lines)
    return True  # points and polygons are closed by definition


def st_isRing(g: GeomLike) -> bool:
    gm = _geom(g)
    return isinstance(gm, LineString) and st_isClosed(gm) and st_isSimple(gm)


def st_isCollection(g: GeomLike) -> bool:
    return isinstance(_geom(g), (MultiPoint, MultiLineString, MultiPolygon))


def st_isEmpty(g: GeomLike) -> bool:
    gm = _geom(g)
    try:
        return len(_coords_of(gm)) == 0
    except ValueError:
        return True


def st_isSimple(g: GeomLike) -> bool:
    """No self-intersection (lines) / valid ring orientation (polygons)."""
    gm = _geom(g)
    if isinstance(gm, (Point, MultiPoint)):
        return True
    if isinstance(gm, LineString):
        e = _edges(gm)
        return not _segments_self_intersect(e)
    if isinstance(gm, MultiLineString):
        return all(st_isSimple(ls) for ls in gm.lines)
    return st_isValid(gm)


def st_isValid(g: GeomLike) -> bool:
    gm = _geom(g)
    if isinstance(gm, (Point, MultiPoint, LineString, MultiLineString)):
        return not st_isEmpty(gm)
    polys = gm.polygons if isinstance(gm, MultiPolygon) else (gm,)
    for p in polys:
        ring = np.asarray(geo._close_ring(p.shell), np.float64)
        if len(ring) < 4:
            return False
        if _segments_self_intersect(_ring_edges(ring)):
            return False
    return True


def st_boundary(g: GeomLike) -> Geometry:
    gm = _geom(g)
    if isinstance(gm, Polygon):
        rings = [LineString(tuple(map(tuple, r))) for r in gm.rings()]
        return rings[0] if len(rings) == 1 else MultiLineString(tuple(rings))
    if isinstance(gm, MultiPolygon):
        rings = [
            LineString(tuple(map(tuple, r)))
            for p in gm.polygons
            for r in p.rings()
        ]
        return MultiLineString(tuple(rings))
    if isinstance(gm, LineString):
        return MultiPoint((Point(*gm.coords[0]), Point(*gm.coords[-1])))
    if isinstance(gm, MultiLineString):
        pts = []
        for ls in gm.lines:
            pts += [Point(*ls.coords[0]), Point(*ls.coords[-1])]
        return MultiPoint(tuple(pts))
    return MultiPoint(())  # points have empty boundary


# ===========================================================================
# Casts (GeometricCastFunctions)
# ===========================================================================

def st_castToPoint(g: GeomLike) -> Point:
    gm = _geom(g)
    if not isinstance(gm, Point):
        raise ValueError("st_castToPoint: not a point")
    return gm


def st_castToLineString(g: GeomLike) -> LineString:
    gm = _geom(g)
    if not isinstance(gm, LineString):
        raise ValueError("st_castToLineString: not a linestring")
    return gm


def st_castToPolygon(g: GeomLike) -> Polygon:
    gm = _geom(g)
    if not isinstance(gm, Polygon):
        raise ValueError("st_castToPolygon: not a polygon")
    return gm


def st_castToGeometry(g: GeomLike) -> Geometry:
    return _geom(g)


# ===========================================================================
# Segment primitives (shared by relations & processing)
# ===========================================================================

def _edges(g: Geometry) -> np.ndarray:
    """[E, 4] (x1, y1, x2, y2) boundary segments."""
    if isinstance(g, LineString):
        a = np.asarray(g.coords, np.float64)
        return np.concatenate([a[:-1], a[1:]], axis=1)
    if isinstance(g, MultiLineString):
        return np.concatenate([_edges(ls) for ls in g.lines])
    if isinstance(g, Polygon):
        segs = []
        for r in g.rings():
            segs.append(np.concatenate([r[:-1], r[1:]], axis=1))
        return np.concatenate(segs)
    if isinstance(g, MultiPolygon):
        return np.concatenate([_edges(p) for p in g.polygons])
    raise ValueError(f"no edges for {type(g).__name__}")


def _ring_edges(ring: np.ndarray) -> np.ndarray:
    return np.concatenate([ring[:-1], ring[1:]], axis=1)


def _cross(ox, oy, ax, ay, bx, by):
    return (ax - ox) * (by - oy) - (ay - oy) * (bx - ox)


def _seg_intersect_matrix(A: np.ndarray, B: np.ndarray,
                          proper_only: bool = False) -> np.ndarray:
    """[Ea, Eb] pairwise segment intersection tests."""
    ax1, ay1, ax2, ay2 = (A[:, i][:, None] for i in range(4))
    bx1, by1, bx2, by2 = (B[:, i][None, :] for i in range(4))
    d1 = _cross(ax1, ay1, ax2, ay2, bx1, by1)
    d2 = _cross(ax1, ay1, ax2, ay2, bx2, by2)
    d3 = _cross(bx1, by1, bx2, by2, ax1, ay1)
    d4 = _cross(bx1, by1, bx2, by2, ax2, ay2)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) \
        & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)
    if proper_only:
        return proper

    def on(d, px, py, qx, qy, rx, ry):
        return (d == 0) & (np.minimum(px, qx) <= rx) & (rx <= np.maximum(px, qx)) \
            & (np.minimum(py, qy) <= ry) & (ry <= np.maximum(py, qy))

    touch = (
        on(d1, ax1, ay1, ax2, ay2, bx1, by1)
        | on(d2, ax1, ay1, ax2, ay2, bx2, by2)
        | on(d3, bx1, by1, bx2, by2, ax1, ay1)
        | on(d4, bx1, by1, bx2, by2, ax2, ay2)
    )
    return proper | touch


def _segments_self_intersect(E: np.ndarray) -> bool:
    """Any non-adjacent pair of segments intersecting. Segments from a
    closed ring (last endpoint == first start) also treat the wraparound
    pair as adjacent."""
    n = len(E)
    if n < 3:
        return False
    m = _seg_intersect_matrix(E, E)
    adj = np.zeros((n, n), dtype=bool)
    i = np.arange(n)
    adj[i, i] = True
    adj[i[:-1], i[:-1] + 1] = True
    adj[i[:-1] + 1, i[:-1]] = True
    if tuple(E[-1, 2:]) == tuple(E[0, :2]):  # closed-ring wraparound
        adj[0, n - 1] = adj[n - 1, 0] = True
    return bool((m & ~adj).any())


# ===========================================================================
# Spatial relations (SpatialRelationFunctions)
#
# Array fast path: every predicate accepts ``st_contains(g, (x, y))`` with
# coordinate arrays and returns a boolean mask — the form the filter
# compiler fuses into scan kernels. Scalar geometry-pair forms implement the
# standard predicate semantics via point-membership + segment intersection.
# ===========================================================================

def _is_xy(b) -> bool:
    return isinstance(b, tuple) and len(b) == 2 and np.ndim(b[0]) > 0


def _any_vertex_in(a: Geometry, b: Geometry, strict: bool = False) -> bool:
    c = _coords_of(a)
    m = b.contains_points(c[:, 0], c[:, 1])
    if strict and m.any() and st_dimension(b) == 2:
        onb = _on_boundary_of(b, c[:, 0], c[:, 1])
        m = m & ~onb
    return bool(m.any())


def _all_vertices_in(a: Geometry, b: Geometry) -> bool:
    c = _coords_of(a)
    return bool(b.contains_points(c[:, 0], c[:, 1]).all())


def _on_boundary_of(g: Geometry, xs, ys) -> np.ndarray:
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    out = np.zeros(xs.shape, dtype=bool)
    if st_dimension(g) == 0:
        return out
    for e in _edges(g):
        out |= geo._on_segment(xs, ys, e[:2], e[2:])
    return out


def _boundaries_cross(a: Geometry, b: Geometry, proper_only=False) -> bool:
    if st_dimension(a) == 0 or st_dimension(b) == 0:
        return False
    return bool(_seg_intersect_matrix(_edges(a), _edges(b), proper_only).any())


def st_intersects(a: GeomLike, b) -> "bool | np.ndarray":
    if _is_xy(b):
        return _geom(a).contains_points(np.asarray(b[0]), np.asarray(b[1]))
    ga, gb = _geom(a), _geom(b)
    if not geo.bounds_intersect(ga.bounds(), gb.bounds()):
        return False
    return (
        _any_vertex_in(ga, gb)
        or _any_vertex_in(gb, ga)
        or _boundaries_cross(ga, gb)
    )


def st_disjoint(a: GeomLike, b) -> "bool | np.ndarray":
    r = st_intersects(a, b)
    return ~r if isinstance(r, np.ndarray) else not r


def st_contains(a: GeomLike, b) -> "bool | np.ndarray":
    """a contains b: b entirely in a's closure, interiors intersecting.
    For the common polygon/point-array case this is exact; polygon-polygon
    uses all-vertices-in + no-boundary-crossing (exact for simple shapes)."""
    if _is_xy(b):
        return _geom(a).contains_points(np.asarray(b[0]), np.asarray(b[1]))
    ga, gb = _geom(a), _geom(b)
    if not geo.bounds_intersect(ga.bounds(), gb.bounds()):
        return False
    if st_dimension(ga) < st_dimension(gb):
        return False
    return _all_vertices_in(gb, ga) and not _boundaries_cross(ga, gb, proper_only=True)


def st_within(a: GeomLike, b: GeomLike) -> bool:
    return st_contains(_geom(b), _geom(a))


def st_covers(a: GeomLike, b) -> "bool | np.ndarray":
    # boundary-inclusive containment; our contains_points is already
    # boundary-inclusive so covers == contains here
    return st_contains(a, b)


def st_crosses(a: GeomLike, b: GeomLike) -> bool:
    """Interiors intersect and the intersection has lower dimension than the
    max operand (line x line at a point, line through polygon, ...)."""
    ga, gb = _geom(a), _geom(b)
    da, db = st_dimension(ga), st_dimension(gb)
    if da == db == 1:
        return _boundaries_cross(ga, gb, proper_only=True)
    if da == 0 or db == 0:
        pt, other = (ga, gb) if da == 0 else (gb, ga)
        c = _coords_of(pt)
        inside = other.contains_points(c[:, 0], c[:, 1])
        return bool(inside.any() and not inside.all())
    if {da, db} == {1, 2}:
        line, poly = (ga, gb) if da == 1 else (gb, ga)
        # a proper crossing of the polygon boundary means the line passes
        # between interior and exterior; else look for interior + exterior
        # vertex evidence
        if _boundaries_cross(line, poly, proper_only=True):
            return True
        c = _coords_of(line)
        inside = poly.contains_points(c[:, 0], c[:, 1])
        onb = _on_boundary_of(poly, c[:, 0], c[:, 1])
        interior = inside & ~onb
        outside = ~inside
        return bool(interior.any() and outside.any())
    return False  # polygon x polygon cannot cross


def st_overlaps(a: GeomLike, b: GeomLike) -> bool:
    """Same dimension, interiors intersect, neither contains the other."""
    ga, gb = _geom(a), _geom(b)
    if st_dimension(ga) != st_dimension(gb):
        return False
    return (
        bool(st_intersects(ga, gb))
        and not st_contains(ga, gb)
        and not st_contains(gb, ga)
    )


def st_touches(a: GeomLike, b: GeomLike) -> bool:
    """Boundaries meet but interiors do not intersect."""
    ga, gb = _geom(a), _geom(b)
    if not st_intersects(ga, gb):
        return False
    if st_dimension(ga) == 2 and st_dimension(gb) == 0:
        c = _coords_of(gb)
        onb = _on_boundary_of(ga, c[:, 0], c[:, 1])
        inside = ga.contains_points(c[:, 0], c[:, 1])
        return bool(onb.any() and not (inside & ~onb).any())
    if st_dimension(gb) == 2 and st_dimension(ga) == 0:
        return st_touches(gb, ga)
    # general: intersect but no interior-interior evidence
    return (
        not _any_vertex_in(ga, gb, strict=True)
        and not _any_vertex_in(gb, ga, strict=True)
        and not _boundaries_cross(ga, gb, proper_only=True)
    )


def st_equals(a: GeomLike, b: GeomLike) -> bool:
    ga, gb = _geom(a), _geom(b)
    if st_dimension(ga) != st_dimension(gb):
        return False
    ba, bb = np.asarray(ga.bounds()), np.asarray(gb.bounds())
    if not np.allclose(ba, bb):
        return False
    if isinstance(ga, Point) and isinstance(gb, Point):
        return ga.x == gb.x and ga.y == gb.y
    if st_dimension(ga) == 2:
        return st_contains(ga, gb) and st_contains(gb, ga)
    ca, cb = _coords_of(ga), _coords_of(gb)
    # same vertex set (tolerates ring rotation / direction)
    sa = {tuple(p) for p in ca.tolist()}
    sb = {tuple(p) for p in cb.tolist()}
    return sa == sb


def st_relate(a: GeomLike, b: GeomLike) -> str:
    """DE-9IM matrix string, derived from the predicate set (dimension
    entries are the best-available approximation: 'T' evidence uses the
    operand dimensions; refer to the individual predicates for exactness)."""
    ga, gb = _geom(a), _geom(b)
    da, db = st_dimension(ga), st_dimension(gb)
    inter = bool(st_intersects(ga, gb))
    if not inter:
        m = ["F", "F", str(da), "F", "F", _bdim(da), str(db), _bdim(db), "2"]
        return "".join(m)
    within = st_contains(gb, ga)
    contains = st_contains(ga, gb)
    ii = str(min(da, db))
    m = [ii, "F", "F", "F", "F", "F", "F", "F", "2"]
    # interior/exterior and boundary entries from the containment facts
    m[1] = _bdim(db) if not contains or db < 2 else "F"       # I(a) ∩ B(b)
    m[2] = "F" if within else str(da)                          # I(a) ∩ E(b)
    m[3] = _bdim(da) if not within or da < 2 else "F"          # B(a) ∩ I(b)
    m[4] = _bdim(min(da, db)) if da and db else "F"            # B ∩ B
    m[5] = "F" if within else _bdim(da)                        # B(a) ∩ E(b)
    m[6] = "F" if contains else str(db)                        # E(a) ∩ I(b)
    m[7] = "F" if contains else _bdim(db)                      # E(a) ∩ B(b)
    return "".join(m)


def _bdim(d: int) -> str:
    return "F" if d == 0 else str(d - 1)


def st_relateBool(a: GeomLike, b: GeomLike, pattern: str) -> bool:
    got = st_relate(a, b)
    for g, p in zip(got, pattern):
        if p == "*":
            continue
        if p == "T":
            if g == "F":
                return False
        elif p != g:
            return False
    return True


# ===========================================================================
# Processing (GeometricProcessingFunctions)
# ===========================================================================

def st_area(g) -> "float | np.ndarray":
    if isinstance(g, np.ndarray):
        return np.array([st_area(x) if x is not None else np.nan for x in g])
    gm = _geom(g)
    if isinstance(gm, MultiPolygon):
        return float(sum(st_area(p) for p in gm.polygons))
    if not isinstance(gm, Polygon):
        return 0.0
    total = _ring_area(np.asarray(geo._close_ring(gm.shell), np.float64))
    for h in gm.holes:
        total -= _ring_area(np.asarray(geo._close_ring(h), np.float64))
    return float(max(total, 0.0))


def _ring_area(r: np.ndarray) -> float:
    x, y = r[:, 0], r[:, 1]
    return abs(float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1])) / 2.0)


def st_length(g: GeomLike) -> float:
    """Planar length in degrees (lines; polygon -> 0 like JTS's getLength
    convention for the spark UDF, which uses line length only)."""
    gm = _geom(g)
    if isinstance(gm, (LineString, MultiLineString)):
        e = _edges(gm)
        return float(np.hypot(e[:, 2] - e[:, 0], e[:, 3] - e[:, 1]).sum())
    return 0.0


def st_lengthSphere(g: GeomLike) -> float:
    gm = _geom(g)
    if not isinstance(gm, (LineString, MultiLineString)):
        return 0.0
    e = _edges(gm)
    return float(haversine_m(e[:, 0], e[:, 1], e[:, 2], e[:, 3]).sum())


st_lengthSpheroid = st_lengthSphere


def st_perimeter(g: GeomLike) -> float:
    gm = _geom(g)
    if isinstance(gm, (Polygon, MultiPolygon)):
        e = _edges(gm)
        return float(np.hypot(e[:, 2] - e[:, 0], e[:, 3] - e[:, 1]).sum())
    return 0.0


def st_centroid(g: GeomLike) -> Point:
    gm = _geom(g)
    if isinstance(gm, Point):
        return gm
    if isinstance(gm, MultiPoint):
        c = _coords_of(gm)
        return Point(float(c[:, 0].mean()), float(c[:, 1].mean()))
    if isinstance(gm, (LineString, MultiLineString)):
        e = _edges(gm)
        L = np.hypot(e[:, 2] - e[:, 0], e[:, 3] - e[:, 1])
        mx = (e[:, 0] + e[:, 2]) / 2
        my = (e[:, 1] + e[:, 3]) / 2
        w = L.sum() or 1.0
        return Point(float((mx * L).sum() / w), float((my * L).sum() / w))
    polys = gm.polygons if isinstance(gm, MultiPolygon) else (gm,)
    cx = cy = aw = 0.0
    for p in polys:
        for sign, ring in [(1.0, np.asarray(geo._close_ring(p.shell), np.float64))] + [
            (-1.0, np.asarray(geo._close_ring(h), np.float64)) for h in p.holes
        ]:
            x, y = ring[:-1, 0], ring[:-1, 1]
            x1, y1 = ring[1:, 0], ring[1:, 1]
            c = x * y1 - x1 * y
            a = float(c.sum()) / 2.0
            if a == 0:
                continue
            cx += sign * float(((x + x1) * c).sum()) / 6.0
            cy += sign * float(((y + y1) * c).sum()) / 6.0
            aw += sign * a
    if aw == 0:
        c = _coords_of(gm)
        return Point(float(c[:, 0].mean()), float(c[:, 1].mean()))
    return Point(cx / aw, cy / aw)


def st_distance(a: GeomLike, b) -> "float | np.ndarray":
    """Planar (degree-space) minimum distance. Array form: st_distance(g,
    (x, y)) -> per-point distance to g."""
    if _is_xy(b):
        return _dist_to_geom(_geom(a), np.asarray(b[0], np.float64),
                             np.asarray(b[1], np.float64))
    ga, gb = _geom(a), _geom(b)
    ca = _coords_of(ga)
    d1 = _dist_to_geom(gb, ca[:, 0], ca[:, 1]).min()
    cb = _coords_of(gb)
    d2 = _dist_to_geom(ga, cb[:, 0], cb[:, 1]).min()
    return float(min(d1, d2))


def _dist_to_geom(g: Geometry, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Per-point planar distance to geometry (0 inside polygons)."""
    if isinstance(g, Point):
        return np.hypot(xs - g.x, ys - g.y)
    if isinstance(g, MultiPoint):
        c = _coords_of(g)
        return np.min(
            np.hypot(xs[:, None] - c[None, :, 0], ys[:, None] - c[None, :, 1]),
            axis=1,
        )
    E = _edges(g)
    ax, ay = E[None, :, 0], E[None, :, 1]
    dx, dy = E[None, :, 2] - ax, E[None, :, 3] - ay
    L2 = np.maximum(dx * dx + dy * dy, 1e-300)
    t = np.clip(((xs[:, None] - ax) * dx + (ys[:, None] - ay) * dy) / L2, 0, 1)
    d = np.hypot(xs[:, None] - (ax + t * dx), ys[:, None] - (ay + t * dy)).min(axis=1)
    if st_dimension(g) == 2:
        d = np.where(g.contains_points(xs, ys), 0.0, d)
    return d


def st_distanceSphere(a: GeomLike, b) -> "float | np.ndarray":
    """Great-circle distance in meters (point-point exact; other pairs use
    the planar closest-point pair, then measure it geodesically)."""
    if _is_xy(b):
        ga = _geom(a)
        if isinstance(ga, Point):
            return haversine_m(np.asarray(b[0]), np.asarray(b[1]), ga.x, ga.y)
        xs, ys = np.asarray(b[0], np.float64), np.asarray(b[1], np.float64)
        return _dist_to_geom(ga, xs, ys) * METERS_PER_DEGREE
    ga, gb = _geom(a), _geom(b)
    if isinstance(ga, Point) and isinstance(gb, Point):
        return float(haversine_m(ga.x, ga.y, gb.x, gb.y))
    pa, pb = st_closestPoint(ga, gb), st_closestPoint(gb, ga)
    return float(haversine_m(pa.x, pa.y, pb.x, pb.y))


st_distanceSpheroid = st_distanceSphere


def st_closestPoint(a: GeomLike, b: GeomLike) -> Point:
    """The point on ``a`` closest to ``b``."""
    ga, gb = _geom(a), _geom(b)
    if isinstance(ga, Point):
        return ga
    cb = _coords_of(gb)
    if st_dimension(ga) == 2 and bool(ga.contains_points(cb[:1, 0], cb[:1, 1])[0]):
        return Point(float(cb[0, 0]), float(cb[0, 1]))
    E = _edges(ga) if st_dimension(ga) > 0 else None
    if E is None:
        ca = _coords_of(ga)
        d = np.hypot(ca[:, 0][:, None] - cb[None, :, 0],
                     ca[:, 1][:, None] - cb[None, :, 1])
        i = np.unravel_index(np.argmin(d), d.shape)[0]
        return Point(float(ca[i, 0]), float(ca[i, 1]))
    best, bx, by = np.inf, 0.0, 0.0
    for x, y in cb:
        ax, ay = E[:, 0], E[:, 1]
        dx, dy = E[:, 2] - ax, E[:, 3] - ay
        L2 = np.maximum(dx * dx + dy * dy, 1e-300)
        t = np.clip(((x - ax) * dx + (y - ay) * dy) / L2, 0, 1)
        px, py = ax + t * dx, ay + t * dy
        d = np.hypot(x - px, y - py)
        i = int(np.argmin(d))
        if d[i] < best:
            best, bx, by = float(d[i]), float(px[i]), float(py[i])
    return Point(bx, by)


def st_bufferPoint(g: GeomLike, radius_m: float, segments: int = 32) -> Polygon:
    """Geodesic point buffer (the reference's st_bufferPoint builds a
    GeodeticCalculator circle): a polygon of ``segments`` vertices at
    great-circle distance ``radius_m``."""
    p = _geom(g)
    if not isinstance(p, Point):
        raise ValueError("st_bufferPoint takes a point")
    lat1 = math.radians(p.y)
    lon1 = math.radians(p.x)
    ang = radius_m / EARTH_RADIUS_M
    verts = []
    for i in range(segments):
        brg = 2 * math.pi * i / segments
        lat2 = math.asin(
            math.sin(lat1) * math.cos(ang)
            + math.cos(lat1) * math.sin(ang) * math.cos(brg)
        )
        lon2 = lon1 + math.atan2(
            math.sin(brg) * math.sin(ang) * math.cos(lat1),
            math.cos(ang) - math.sin(lat1) * math.sin(lat2),
        )
        verts.append((math.degrees(lon2), math.degrees(lat2)))
    verts.append(verts[0])
    return Polygon(tuple(verts))


def st_convexhull(g) -> Geometry:
    """Convex hull (monotone chain). Accepts a geometry, WKT, or an object
    array of geometries (the UDAF form: hull of everything)."""
    if isinstance(g, np.ndarray):
        pts = np.concatenate([_coords_of(_geom(x)) for x in g if x is not None])
    else:
        pts = _coords_of(_geom(g))
    pts = np.unique(pts, axis=0)
    if len(pts) == 1:
        return Point(float(pts[0, 0]), float(pts[0, 1]))
    if len(pts) == 2:
        return LineString(tuple(map(tuple, pts)))
    P = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(points):
        out: List[np.ndarray] = []
        for p in points:
            while len(out) >= 2 and _cross(
                out[-2][0], out[-2][1], out[-1][0], out[-1][1], p[0], p[1]
            ) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(P)
    upper = half(P[::-1])
    ring = lower[:-1] + upper[:-1]
    if len(ring) < 3:
        return LineString(tuple(map(tuple, pts)))
    ring.append(ring[0])
    return Polygon(tuple((float(x), float(y)) for x, y in ring))


def st_translate(g: GeomLike, dx: float, dy: float) -> Geometry:
    gm = _geom(g)
    if isinstance(gm, Point):
        return Point(gm.x + dx, gm.y + dy)
    if isinstance(gm, MultiPoint):
        return MultiPoint(tuple(Point(p.x + dx, p.y + dy) for p in gm.points))
    if isinstance(gm, LineString):
        return LineString(tuple((x + dx, y + dy) for x, y in gm.coords))
    if isinstance(gm, MultiLineString):
        return MultiLineString(tuple(st_translate(ls, dx, dy) for ls in gm.lines))
    if isinstance(gm, Polygon):
        return Polygon(
            tuple((x + dx, y + dy) for x, y in gm.shell),
            tuple(tuple((x + dx, y + dy) for x, y in h) for h in gm.holes),
        )
    if isinstance(gm, MultiPolygon):
        return MultiPolygon(tuple(st_translate(p, dx, dy) for p in gm.polygons))
    raise ValueError(type(gm).__name__)


def _clip_convex(subject: Polygon, clip: Polygon) -> Optional[Polygon]:
    """Sutherland–Hodgman: subject clipped by a CONVEX clip polygon."""
    cr = np.asarray(geo._close_ring(clip.shell), np.float64)
    # ensure counter-clockwise orientation
    if float(np.sum((cr[1:, 0] - cr[:-1, 0]) * (cr[1:, 1] + cr[:-1, 1]))) > 0:
        cr = cr[::-1]
    out = [tuple(p) for p in np.asarray(geo._close_ring(subject.shell), np.float64)[:-1]]
    for i in range(len(cr) - 1):
        if not out:
            return None
        ax, ay = cr[i]
        bx, by = cr[i + 1]
        new: List[Tuple[float, float]] = []
        for j in range(len(out)):
            cur = out[j]
            prv = out[j - 1]
            cur_in = _cross(ax, ay, bx, by, cur[0], cur[1]) >= 0
            prv_in = _cross(ax, ay, bx, by, prv[0], prv[1]) >= 0
            if cur_in != prv_in:
                # edge intersection with the clip line
                x1, y1 = prv
                x2, y2 = cur
                den = (bx - ax) * (y2 - y1) - (by - ay) * (x2 - x1)
                if den != 0:
                    t = ((bx - ax) * (ay - y1) - (by - ay) * (ax - x1)) / den
                    new.append((x1 + t * (x2 - x1), y1 + t * (y2 - y1)))
            if cur_in:
                new.append(cur)
        out = new
    if len(out) < 3:
        return None
    out.append(out[0])
    return Polygon(tuple(out))


def _is_convex(p: Polygon) -> bool:
    r = np.asarray(geo._close_ring(p.shell), np.float64)
    v = np.diff(r, axis=0)
    cr = v[:-1, 0] * v[1:, 1] - v[:-1, 1] * v[1:, 0]
    return bool((cr >= 0).all() or (cr <= 0).all())


def st_intersection(a: GeomLike, b: GeomLike) -> Optional[Geometry]:
    """Geometry intersection. Supported: point/multipoint vs anything;
    polygon vs convex polygon (Sutherland–Hodgman); identical geometries.
    Other pairs raise — the reference delegates these to JTS overlay, which
    is out of scope for the columnar hot path."""
    ga, gb = _geom(a), _geom(b)
    if not st_intersects(ga, gb):
        return None
    if st_dimension(ga) == 0:
        c = _coords_of(ga)
        m = gb.contains_points(c[:, 0], c[:, 1])
        kept = c[m]
        if len(kept) == 1:
            return Point(float(kept[0, 0]), float(kept[0, 1]))
        return MultiPoint(tuple(Point(float(x), float(y)) for x, y in kept))
    if st_dimension(gb) == 0:
        return st_intersection(gb, ga)
    if st_equals(ga, gb):
        return ga
    if isinstance(ga, Polygon) and isinstance(gb, Polygon) and not ga.holes and not gb.holes:
        if _is_convex(gb):
            return _clip_convex(ga, gb)
        if _is_convex(ga):
            return _clip_convex(gb, ga)
    raise NotImplementedError(
        "st_intersection supports point/* and polygon/convex-polygon pairs"
    )


def st_difference(a: GeomLike, b: GeomLike) -> Optional[Geometry]:
    """Supported: disjoint (returns a), point sets, and polygon minus a
    fully-contained hole-free polygon (returns a with a hole)."""
    ga, gb = _geom(a), _geom(b)
    if not st_intersects(ga, gb):
        return ga
    if st_dimension(ga) == 0:
        c = _coords_of(ga)
        m = ~gb.contains_points(c[:, 0], c[:, 1])
        kept = c[m]
        if len(kept) == 0:
            return None
        if len(kept) == 1:
            return Point(float(kept[0, 0]), float(kept[0, 1]))
        return MultiPoint(tuple(Point(float(x), float(y)) for x, y in kept))
    if (
        isinstance(ga, Polygon) and isinstance(gb, Polygon)
        and not gb.holes and st_contains(ga, gb)
        and not _boundaries_cross(ga, gb)
    ):
        return Polygon(ga.shell, ga.holes + (gb.shell,))
    raise NotImplementedError(
        "st_difference supports disjoint, point, and contained-polygon pairs"
    )


def st_antimeridianSafeGeom(g: GeomLike) -> Geometry:
    """Split geometries whose longitudes cross the ±180 antimeridian into a
    multipolygon of in-range pieces (reference st_antimeridianSafeGeom /
    st_idlSafeGeom)."""
    gm = _geom(g)
    xmin, ymin, xmax, ymax = gm.bounds()
    if xmin >= -180.0 and xmax <= 180.0:
        return gm
    if not isinstance(gm, Polygon):
        raise NotImplementedError("antimeridian split implemented for polygons")
    parts = []
    west = _clip_convex(gm, bbox_polygon(-540.0, -90.0, 180.0, 90.0))
    east = _clip_convex(gm, bbox_polygon(180.0, -90.0, 540.0, 90.0))
    if west is not None:
        parts.append(west)
    if east is not None:
        parts.append(
            Polygon(tuple((x - 360.0, y) for x, y in east.shell))
        )
    if len(parts) == 1:
        return parts[0]
    return MultiPolygon(tuple(parts))


st_idlSafeGeom = st_antimeridianSafeGeom


def st_aggregateDistanceSphere(points: Sequence[GeomLike]) -> float:
    """Total great-circle path length over a point sequence."""
    pts = [_geom(p) for p in points]
    if len(pts) < 2:
        return 0.0
    x = np.array([p.x for p in pts])
    y = np.array([p.y for p in pts])
    return float(haversine_m(x[:-1], y[:-1], x[1:], y[1:]).sum())
