"""User-facing entry point: schema catalog + per-schema stores + planner +
executor, on one CUDA device.

Port of the ``geomesa_tpu/api/dataset.py::GeoDataset`` surface the port
serves: ``create_schema``, ``insert`` (with feature ids), ``flush``,
``count``, ``density`` and ``bounds`` with the JAX signatures. The layers
the JAX ``GeoDataset`` wraps around its executor (aggregate cache, audit,
serving, tracing, journal, fleet) are not part of this port yet: ``count``
and ``density`` call the executor directly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.index.store import FeatureStore
from geomesa_tpu_torch.planning.executor import Executor
from geomesa_tpu_torch.planning.planner import QueryPlan, plan_query
from geomesa_tpu_torch.schema.feature_type import FeatureType


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device that is not visible
    raises instead of running on the CPU. Pass ``"cpu"`` explicitly for the
    plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class GeoDataset:
    """Schema catalog + stores on one device.

    ``compact_min_rows`` / ``compact_fraction``: the compacted scan layout
    engages for tables of at least ``compact_min_rows`` rows whose windows
    admit less than ``compact_fraction`` of the table (the JAX package's
    ``geomesa.compact.min.rows`` / ``geomesa.compact.fraction``)."""

    def __init__(self, n_shards: int = 8, device=None,
                 compact_min_rows: int = 1 << 20,
                 compact_fraction: float = 0.5):
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.compact_min_rows = compact_min_rows
        self.compact_fraction = compact_fraction
        self._stores: Dict[str, FeatureStore] = {}
        self._executors: Dict[str, Executor] = {}
        self._plans: Dict[tuple, QueryPlan] = {}

    # -- schemas ------------------------------------------------------------
    def create_schema(self, name_or_ft, spec: Optional[str] = None) -> FeatureType:
        ft = (name_or_ft if isinstance(name_or_ft, FeatureType)
              else FeatureType.from_spec(name_or_ft, spec))
        if ft.name in self._stores:
            raise ValueError(f"schema {ft.name!r} already exists")
        self._stores[ft.name] = FeatureStore(ft, self.n_shards, self.device)
        return ft

    def attach_store(self, store: FeatureStore) -> None:
        """Serve an already-built store (see ``convert.store_from_arrays``)
        under its schema name."""
        if store.device != self.device:
            raise ValueError(f"store on {store.device}, dataset on {self.device}")
        if store.ft.name in self._stores:
            raise ValueError(f"schema {store.ft.name!r} already exists")
        self._stores[store.ft.name] = store

    def _store(self, name: str) -> FeatureStore:
        st = self._stores.get(name)
        if st is None:
            raise KeyError(
                f"no schema {name!r} (have: {', '.join(sorted(self._stores)) or 'none'})"
            )
        return st

    def _executor(self, name: str) -> Executor:
        ex = self._executors.get(name)
        if ex is None or ex.store is not self._store(name):
            ex = self._executors[name] = Executor(
                self._store(name), compact_min_rows=self.compact_min_rows,
                compact_fraction=self.compact_fraction,
            )
        return ex

    # -- writes -------------------------------------------------------------
    def insert(self, name: str, data: Dict[str, Any], fids=None,
               visibilities=None) -> int:
        """Append a batch of features; flush() (or a query) indexes them.
        ``fids``: one feature id per row (random 128-bit hex when None).
        Row visibilities are refused: nothing stores them yet."""
        if visibilities is not None:
            raise NotImplementedError(
                "row visibilities: ROADMAP Queue 1, host layers"
            )
        return self._store(name).append(data, fids)

    def flush(self, name: Optional[str] = None) -> None:
        for st in ([self._store(name)] if name else self._stores.values()):
            st.flush()

    # -- queries ------------------------------------------------------------
    def _plan(self, name: str, query) -> QueryPlan:
        if not isinstance(query, str):
            raise NotImplementedError(
                "Query objects (sampling, projections, sorting): "
                "ROADMAP Queue 1, stats, kNN, top-k and sampling"
            )
        st = self._store(name)
        st.flush()
        key = (name, query, id(st), st.version)
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 256:
                self._plans.clear()
            plan = self._plans[key] = plan_query(st, query)
        return plan

    def count(self, name: str, query="INCLUDE", exact: bool = True,
              region=None) -> int:
        """Exact feature count of ``query`` (ECQL text)."""
        if not exact:
            raise NotImplementedError(
                "estimated counts (write-time sketches): "
                "ROADMAP Queue 1, stats, kNN, top-k and sampling"
            )
        if region is not None:
            raise NotImplementedError(
                "region= aggregates: ROADMAP Queue 1, polygon regions and cache cells"
            )
        return self._executor(name).count(self._plan(name, query))

    def density(self, name: str, query="INCLUDE", bbox=None, width: int = 256,
                height: int = 256, weight: Optional[str] = None,
                region=None) -> np.ndarray:
        """(height, width) f32 heatmap of ``query`` over ``bbox`` (default:
        the data's bounds), optionally summing the ``weight`` attribute."""
        if region is not None:
            raise NotImplementedError(
                "region= aggregates: ROADMAP Queue 1, polygon regions and cache cells"
            )
        plan = self._plan(name, query)
        if bbox is None:
            bbox = self.bounds(name) or (-180, -90, 180, 90)
        return self._executor(name).density(plan, tuple(bbox), width, height, weight)

    def bounds(self, name: str) -> Optional[Tuple[float, float, float, float]]:
        """Geometry bounds of the schema's rows (None when empty), from the
        write-time ``bounds`` sketch."""
        st = self._store(name)
        st.flush()
        return st.bounds()

    def stats(self, name: str, stat_spec: str, query="INCLUDE"):
        raise NotImplementedError(
            "stats: ROADMAP Queue 1, stats, kNN, top-k and sampling"
        )
