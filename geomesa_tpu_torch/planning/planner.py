"""Query planner: ECQL -> (z3 key plan, compiled predicate).

Port of ``geomesa_tpu/planning/planner.py`` cut to the z3 index: the JAX
package's cost-based choice among z3 / z2 / id / attribute indices reduces
to z3, which serves every query with a time bound. Queries it cannot serve
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import CompiledFilter, compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.index.keyspace import KeyPlan
from geomesa_tpu_torch.index.store import FeatureStore


@dataclass
class QueryPlan:
    """Everything the executor needs for one query."""

    schema: str
    filter: ir.Filter
    compiled: CompiledFilter
    key_plan: KeyPlan

    @property
    def is_empty(self) -> bool:
        return self.key_plan.disjoint or isinstance(self.filter, ir.Exclude)


def plan_query(store: FeatureStore, ecql: str) -> QueryPlan:
    ft = store.ft
    f = parse_ecql(ecql)
    kp = store.keyspace.plan(ft, f)
    if kp is None:
        raise NotImplementedError(
            "queries without a time bound (z2 / full-scan plans): "
            "ROADMAP Queue 1, index key spaces and predicates"
        )
    return QueryPlan(ft.name, f, compile_filter(f, ft), kp)
