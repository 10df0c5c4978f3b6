"""The spatial aggregate cache (copy of ``geomesa_tpu/cache``).

SFC-cell result caching with epoch invalidation, partial-cover reuse, a
hierarchical pre-aggregation quadtree (coarse cells assemble from cached
children, so a zoom-out costs O(visible cells), not O(data)), and
polygon-region decomposition (interior cells from the cache, boundary
cells scanned exactly). Off by default; enable with
``geomesa.cache.enabled=true`` (``GEOMESA_CACHE_ENABLED=true``).
"""

from geomesa_tpu_torch.cache import hierarchy
from geomesa_tpu_torch.cache.cells import (
    Decomposition, RegionDecomposition, decompose, decompose_region,
    split_bbox_conjunct, split_region_conjunct,
)
from geomesa_tpu_torch.cache.service import EXACT_MERGE_KINDS, AggregateCache
from geomesa_tpu_torch.cache.store import CacheStore

__all__ = [
    "AggregateCache", "CacheStore", "Decomposition", "RegionDecomposition",
    "decompose", "decompose_region", "split_bbox_conjunct",
    "split_region_conjunct", "hierarchy", "EXACT_MERGE_KINDS",
]
