"""PyTorch / CUDA port of geomesa_tpu for one NVIDIA H100.

This package serves the bbox + time and polygon ``count`` / ``density``
path: schema creation, ingest into sorted z3 shards, ECQL planning to scan
windows, window compaction, the fused mask, and the aggregates, with the
JAX package's two Pallas kernels rewritten as CUDA kernels (``csrc/``). It
imports torch and numpy, and nothing of JAX or ``geomesa_tpu``.
"""

from geomesa_tpu_torch.api.dataset import GeoDataset
from geomesa_tpu_torch.schema.feature_type import FeatureType

__all__ = ["GeoDataset", "FeatureType"]
