"""PyTorch / CUDA port of geomesa_tpu for one NVIDIA H100.

This package serves point and extent-geometry schemas: ingest into sorted
z3, z2 (points), xz3, xz2 (lines, polygons, Multi*), feature-id and
attribute index shards; ECQL planning (expression comparisons and ``st_*``
functions included) through the cost-based decider to scan windows; window
compaction, the fused mask, exact refinement on the host, and the
``count`` / ``density`` aggregates (over a polygon ``region=`` too),
feature queries (``Query``: projection, limit, sorting, sampling), stats,
kNN and spatial joins (point-point, point-polygon, ``spatial_join``),
time-partitioned stores spilled as lake snapshots with row-group pushdown,
the schema and data lifecycle (``update_schema``, attribute indices,
``delete_features``, ``age_off``), and durable datasets (``save`` /
``GeoDataset.load`` / ``refresh_schema`` over incremental checkpoints,
with the write-ahead mutation journal), with
the JAX package's two Pallas kernels and the join predicates written as
CUDA kernels (``csrc/``). Its tunables are in
``config``. It imports torch and numpy, and nothing of JAX or
``geomesa_tpu``.
"""

from geomesa_tpu_torch.api.dataset import (
    FeatureCollection, GeoDataset, Query, SpatialJoinResult,
)
from geomesa_tpu_torch.schema.feature_type import FeatureType

__all__ = ["FeatureCollection", "GeoDataset", "FeatureType", "Query", "SpatialJoinResult"]
