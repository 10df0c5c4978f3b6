"""Standing-query specs.

Copy of ``geomesa_tpu/subscribe/spec.py``. A :class:`StandingSpec` is one
viewport (a bbox, optionally intersected with a ``region`` polygon) and
one aggregate over it. Specs are value objects: two subscribers with equal
specs fuse into one standing group (``serving/fuse.py::subscription_key``),
and the dict codec is what the journal and the manifest carry, in the
reference's form.

Aggregates:

* ``count``: exact feature count inside the viewport;
* ``density``: unweighted (height, width) f32 grid over the viewport bbox
  (integer cells: delta adds are exact to 2^24);
* ``pyramid``: an f64 leaf grid of side 2^levels, downsample-added up to the
  1x1 root in the fixed SW/SE/NW/NE order (``cache/hierarchy.downsample``;
  integer cells exact to 2^53);
* ``stats``: a sketch spec whose every leaf merges exactly
  (``cache/service.stats_exact_merge``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config

AGGREGATES = ("count", "density", "pyramid", "stats")

WORLD = (-180.0, -90.0, 180.0, 90.0)


@dataclass(frozen=True)
class StandingSpec:
    """One registered viewport and aggregate; immutable."""

    schema: str
    aggregate: str
    #: viewport bbox (xmin, ymin, xmax, ymax), f64; a region-only
    #: registration carries the polygon's bounds
    bbox: Tuple[float, float, float, float]
    #: optional polygon viewport (WKT), intersected with the bbox
    region: Optional[str] = None
    width: int = 256
    height: int = 256
    #: pyramid depth (leaf side 2^levels)
    levels: int = 5
    #: the stats sketch spec (aggregate "stats")
    stat_spec: Optional[str] = None

    def __post_init__(self):
        if self.aggregate not in AGGREGATES:
            raise ValueError(
                f"[GM-ARG] unknown standing aggregate {self.aggregate!r} (one of {AGGREGATES})")
        if self.aggregate == "stats" and not self.stat_spec:
            raise ValueError("[GM-ARG] stats subscription needs stat_spec")
        xmin, ymin, xmax, ymax = self.bbox
        if not (xmax > xmin and ymax > ymin):
            raise ValueError(f"[GM-ARG] degenerate viewport bbox {self.bbox}")

    def key(self) -> tuple:
        """Canonical fuse identity (``serving/fuse.py::subscription_key``)."""
        from geomesa_tpu_torch.serving.fuse import subscription_key

        return subscription_key(self)

    def ecql(self, geom: str = "geom") -> str:
        """The membership predicate as ECQL text, in the shape
        ``GeoDataset._with_region`` folds a region into: the compiled mask
        of this text decides membership for both the delta path and the
        re-scan."""
        xmin, ymin, xmax, ymax = (repr(float(v)) for v in self.bbox)
        base = f"BBOX({geom}, {xmin}, {ymin}, {xmax}, {ymax})"
        if self.region:
            return f"({base}) AND INTERSECTS({geom}, {self.region})"
        return base

    def route_key(self, level: int) -> str:
        """The ring key: the viewport center's SFC cell at the routing
        level, as the fleet router keys a query over the same bbox."""
        from geomesa_tpu_torch.cache import cells as cellmod

        n = 1 << level
        cx = (self.bbox[0] + self.bbox[2]) / 2.0
        cy = (self.bbox[1] + self.bbox[3]) / 2.0
        ix = int(np.clip((cx + 180.0) / 360.0 * n, 0, n - 1))
        iy = int(np.clip((cy + 90.0) / 180.0 * n, 0, n - 1))
        return f"{self.schema}:z{level}:{cellmod.cell_prefix(level, (ix, iy))}"

    def intersects(self, bounds) -> bool:
        """Viewport against a mutation's dirty bounds: False means the
        mutation cannot have changed this group's result. None (unknown
        extent) always intersects."""
        if bounds is None:
            return True
        xmin, ymin, xmax, ymax = self.bbox
        bx0, by0, bx1, by1 = bounds
        return not (bx1 < xmin or bx0 > xmax or by1 < ymin or by0 > ymax)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"schema": self.schema, "aggregate": self.aggregate,
                             "bbox": [float(v) for v in self.bbox]}
        if self.region:
            d["region"] = self.region
        if self.aggregate == "density":
            d["width"], d["height"] = int(self.width), int(self.height)
        if self.aggregate == "pyramid":
            d["levels"] = int(self.levels)
        if self.aggregate == "stats":
            d["stat_spec"] = self.stat_spec
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StandingSpec":
        return cls(
            schema=d["schema"], aggregate=d["aggregate"],
            bbox=tuple(float(v) for v in d["bbox"]),
            region=d.get("region"),
            width=int(d.get("width", 256)), height=int(d.get("height", 256)),
            levels=int(d.get("levels", 5)),
            stat_spec=d.get("stat_spec"),
        )


def make_spec(schema: str, aggregate: str, bbox=None, region=None,
              width: int = 256, height: int = 256, levels: Optional[int] = None,
              stat_spec: Optional[str] = None) -> StandingSpec:
    """Build and validate a spec from loose arguments. A region-only
    registration takes the polygon's bounds; neither given covers the
    world."""
    wkt = None
    if region is not None:
        from geomesa_tpu_torch.utils import geometry as geo

        wkt = region if isinstance(region, str) else region.wkt()
        g = geo.parse_wkt(wkt)  # validate before it reaches a compile
        if bbox is None:
            bbox = g.bounds()
    if bbox is None:
        bbox = WORLD
    if levels is None:
        levels = config.SUBSCRIBE_PYRAMID_LEVELS.to_int() or 5
    return StandingSpec(
        schema=schema, aggregate=aggregate, bbox=tuple(float(v) for v in bbox),
        region=wkt, width=int(width), height=int(height), levels=int(levels),
        stat_spec=stat_spec,
    )
