"""PyTorch port vs the JAX package: every public ``st_*`` function of the
port's ``geofn`` against the JAX package's ``geofn`` on seeded geometries
(points, multipoints, lines, multilines, polygons with and without holes,
multipolygons), scalar and vectorized forms. Geometries compare by their
full-precision WKT, numbers at rtol 1e-12, everything else exactly; a
call that raises in one package raises the same exception type in the
other."""

import numpy as np
import pytest

from geomesa_tpu import geofn as jgf
from geomesa_tpu.utils import geometry as jgeo
from geomesa_tpu_torch import geofn as pgf
from geomesa_tpu_torch.utils import geometry as pgeo


def _seeded_wkts(seed=41):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x, y = rng.uniform(-170, 170), rng.uniform(-80, 80)
        out.append(f"POINT ({x} {y})")
        out.append(f"MULTIPOINT (({x} {y}), ({x + 0.5} {y - 0.25}), ({x - 1} {y + 1}))")
        pts = np.cumsum(np.vstack([[x, y], rng.uniform(-1, 1, (3, 2))]), axis=0)
        line = ", ".join(f"{a} {b}" for a, b in pts)
        out.append(f"LINESTRING ({line})")
        out.append(f"MULTILINESTRING (({line}), ({x + 2} {y}, {x + 3} {y + 1}))")
        k = 5
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.5, 2.0, k)
        shell = [(x + a * np.cos(t), y + a * np.sin(t)) for t, a in zip(ang, r)]
        ring = ", ".join(f"{a} {b}" for a, b in shell + shell[:1])
        hole = [(x + 0.2 * a * np.cos(t), y + 0.2 * a * np.sin(t)) for t, a in zip(ang, r)]
        hring = ", ".join(f"{a} {b}" for a, b in hole + hole[:1])
        out.append(f"POLYGON (({ring}))")
        out.append(f"POLYGON (({ring}), ({hring}))")
        out.append(f"MULTIPOLYGON ((({ring})), (({x + 5} {y}, {x + 6} {y}, {x + 6} {y + 1}, {x + 5} {y})))")
    # overlapping, touching and nested pairs for the relations
    out += [
        "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
        "POLYGON ((2 2, 8 2, 5 8, 2 2))",
        "POLYGON ((10 0, 20 0, 20 10, 10 10, 10 0))",
        "POLYGON ((5 5, 15 5, 15 15, 5 15, 5 5))",
        "LINESTRING (0 0, 10 10)",
        "LINESTRING (-5 5, 15 5)",
        "LINESTRING (10 0, 10 10)",
        "POINT (5 5)",
        "POINT (10 5)",
        "POLYGON ((179 -1, -179 -1, -179 1, 179 1, 179 -1))",
    ]
    return out


G = _seeded_wkts()
POINTS = [w for w in G if w.startswith("POINT")]
LINES = [w for w in G if w.startswith("LINESTRING")]
POLYS = [w for w in G if w.startswith("POLYGON")]
PAIRS = [(G[i], G[j]) for i in range(len(G)) for j in range(len(G))
         if (i * 7 + j * 3) % 5 == 0]
XS = np.random.default_rng(3).uniform(-10, 20, 200)
YS = np.random.default_rng(4).uniform(-10, 20, 200)
XY = (XS, YS)

UNARY = ["st_asText", "st_asGeoJSON", "st_asBinary", "st_envelope", "st_exteriorRing",
         "st_numGeometries", "st_numPoints", "st_coordDim", "st_dimension",
         "st_geometryType", "st_isClosed", "st_isRing", "st_isCollection", "st_isEmpty",
         "st_isSimple", "st_isValid", "st_boundary", "st_area", "st_length",
         "st_lengthSphere", "st_lengthSpheroid", "st_perimeter", "st_centroid",
         "st_convexhull", "st_antimeridianSafeGeom", "st_idlSafeGeom",
         "st_castToGeometry", "st_geomFromWKT", "st_geomFromText", "st_geometryFromText",
         "st_castToPoint", "st_castToLineString", "st_castToPolygon", "st_x", "st_y",
         "st_asLatLonText", "st_pointFromText", "st_lineFromText", "st_polygonFromText",
         "st_polygon", "st_mPointFromText", "st_mLineFromText", "st_mPolyFromText",
         "st_makePolygon"]
BINARY = ["st_intersects", "st_disjoint", "st_contains", "st_within", "st_covers",
          "st_crosses", "st_overlaps", "st_touches", "st_equals", "st_relate",
          "st_distance", "st_distanceSphere", "st_distanceSpheroid", "st_closestPoint",
          "st_intersection", "st_difference"]


def _args(name, mod):
    """Argument tuples of one function (``mod`` builds package objects
    where a function takes more than WKT)."""
    if name in UNARY:
        return [(w,) for w in G]
    if name in BINARY:
        out = list(PAIRS)
        if name in ("st_intersects", "st_disjoint", "st_contains", "st_covers",
                    "st_distance", "st_distanceSphere", "st_distanceSpheroid"):
            out += [(w, XY) for w in POLYS[:4] + LINES[:2] + POINTS[:2]]
        return out
    return {
        "st_makePoint": [(1.5, -2.25), (XS, YS)],
        "st_point": [(1.5, -2.25), (XS[:5], YS[:5])],
        "st_makePointM": [(1.0, 2.0, 3.0)],
        "st_makeLine": [(POINTS[:3],), (["POINT (0 0)", "POINT (1 1)", "POINT (2 0)"],)],
        "st_makeBBOX": [(0.0, 0.5, 2.0, 3.5), (-1e-9, -2.0, 1e-9, 2.0)],
        "st_makeBox2D": [("POINT (0 0)", "POINT (2 3)"), (POINTS[0], POINTS[1])],
        "st_geomFromGeoJSON": [(mod.st_asGeoJSON(w),) for w in G],
        "st_byteArray": [("abc",), ("",)],
        "st_geomFromWKB": [(mod.st_asBinary(w),) for w in G],
        "st_pointFromWKB": [(mod.st_asBinary(w),) for w in POINTS + LINES[:1]],
        "st_geoHash": [(w, bits) for w in POINTS for bits in (25, 35)]
        + [(w,) for w in POLYS[:2]],
        "st_geomFromGeoHash": [("9q8yy",), ("u4pruydqqvj", 40)],
        "st_box2DFromGeoHash": [("9q8yy",), ("dr5r",)],
        "st_pointFromGeoHash": [("9q8yy",), ("u4pruydqqvj", 40)],
        "st_interiorRingN": [(w, n) for w in POLYS for n in (0, 1, 2)],
        "st_geometryN": [(w, n) for w in G for n in (0, 1, 2)],
        "st_pointN": [(w, n) for w in LINES + POLYS[:2] for n in (0, 1, -1, 9)],
        "st_relateBool": [(a, b, pat) for a, b in PAIRS[:40]
                          for pat in ("T********", "FF*FF****", "T*F**F***")],
        "st_bufferPoint": [(w, 1000.0) for w in POINTS] + [(POINTS[0], 250.0, 8)],
        "st_translate": [(w, 1.5, -2.0) for w in G],
        "st_aggregateDistanceSphere": [(POINTS,), (POINTS[:1],)],
        "st_area": None,
    }[name]


def _norm(v):
    """A comparable form: geometries as ('geom', wkt), arrays as lists."""
    if isinstance(v, (jgeo.Geometry, pgeo.Geometry)):
        return ("geom", v.wkt())
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "O":
            return ("objs", [_norm(x) for x in v.tolist()])
        return ("arr", v)
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_norm(x) for x in v])
    if isinstance(v, (float, np.floating)):
        return ("num", float(v))
    if isinstance(v, (bool, np.bool_)):
        return ("bool", bool(v))
    return v


def _assert_same(a, b):
    if isinstance(a, tuple) and len(a) == 2 and a[0] == "arr":
        assert b[0] == "arr" and a[1].shape == b[1].shape
        if a[1].dtype.kind in "fc":
            np.testing.assert_allclose(b[1], a[1], rtol=1e-12, atol=0, equal_nan=True)
        else:
            assert np.array_equal(a[1], b[1])
    elif isinstance(a, tuple) and len(a) == 2 and a[0] == "num":
        assert b[0] == "num"
        if np.isnan(a[1]):
            assert np.isnan(b[1])
        else:
            np.testing.assert_allclose(b[1], a[1], rtol=1e-12, atol=0)
    elif isinstance(a, tuple) and len(a) == 2 and a[0] in ("objs", "list", "tuple"):
        assert a[0] == b[0] and len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            _assert_same(x, y)
    else:
        assert a == b


def _call(mod, name, args):
    try:
        return "ok", _norm(getattr(mod, name)(*args))
    except Exception as e:  # the other package must raise the same type
        return "raise", type(e).__name__


PUBLIC = sorted(n for n in dir(jgf) if n.startswith("st_") and callable(getattr(jgf, n)))


def test_same_public_functions():
    port = sorted(n for n in dir(pgf) if n.startswith("st_") and callable(getattr(pgf, n)))
    assert port == PUBLIC


@pytest.mark.parametrize("name", PUBLIC)
def test_st_function_equal(name):
    jargs = _args(name, jgf)
    if jargs is None:  # st_area: scalar, object-array and (xs, ys) forms
        jargs = [(w,) for w in G] + [(np.array([jgeo.parse_wkt(w) for w in POLYS], object),)]
        pargs = [(w,) for w in G] + [(np.array([pgeo.parse_wkt(w) for w in POLYS], object),)]
    else:
        pargs = _args(name, pgf)
    assert len(jargs) == len(pargs) > 0
    outcomes = set()
    for ja, pa in zip(jargs, pargs):
        want = _call(jgf, name, ja)
        got = _call(pgf, name, pa)
        assert got[0] == want[0], (name, ja, want, got)
        if want[0] == "raise":
            assert got[1] == want[1], (name, ja)
        else:
            _assert_same(want[1], got[1])
        outcomes.add(want[0])
    assert "ok" in outcomes, name  # the cases reach the function's body
