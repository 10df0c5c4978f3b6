"""Polygon literals for query predicates (pure NumPy).

Copy of ``geomesa_tpu/utils/geometry.py`` cut to what the polygon predicate
needs: ``Polygon`` / ``MultiPolygon`` with bounds and the rectangle test, ring
closing, and WKT parsing of POLYGON / MULTIPOLYGON / ENVELOPE. Coordinates
are (x=lon, y=lat) degrees.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


class Geometry:
    def bounds(self) -> Tuple[float, float, float, float]:
        """(xmin, ymin, xmax, ymax)"""
        raise NotImplementedError


@dataclass(frozen=True)
class Polygon(Geometry):
    shell: Tuple[Tuple[float, float], ...]  # closed or open ring
    holes: Tuple[Tuple[Tuple[float, float], ...], ...] = ()

    def bounds(self):
        a = np.asarray(self.shell)
        return (float(a[:, 0].min()), float(a[:, 1].min()),
                float(a[:, 0].max()), float(a[:, 1].max()))

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


@dataclass(frozen=True)
class MultiPolygon(Geometry):
    polygons: Tuple[Polygon, ...]

    def bounds(self):
        bs = np.asarray([p.bounds() for p in self.polygons])
        return (float(bs[:, 0].min()), float(bs[:, 1].min()),
                float(bs[:, 2].max()), float(bs[:, 3].max()))


def _close_ring(r: Sequence[Tuple[float, float]]):
    r = list(r)
    if r[0] != r[-1]:
        r = r + [r[0]]
    return tuple(tuple(p) for p in r)


_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def parse_wkt(text: str) -> Geometry:
    """Parse POLYGON / MULTIPOLYGON / ENVELOPE WKT."""
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
    raise NotImplementedError(
        f"{tag} literals: ROADMAP Queue 1, index key spaces and predicates"
    )


def bbox_polygon(xmin: float, ymin: float, xmax: float, ymax: float) -> Polygon:
    return Polygon(((xmin, ymin), (xmax, ymin), (xmax, ymax), (xmin, ymax), (xmin, ymin)))
