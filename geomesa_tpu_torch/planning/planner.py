"""Query planner: ECQL -> (index choice, key plan, compiled predicate).

Port of ``geomesa_tpu/planning/planner.py``'s ``QueryPlanner.plan`` with
its cost-based decider: every key space of the store proposes a key plan,
the write-time sketches estimate each plan's rows, index multipliers weigh
them (id 0.5, z3 / xz3 1.0, z2 / xz2 1.5, attribute 2.0), and the
cheapest wins (extent schemas carry no z histograms: xz plans estimate
from their cover's share of the key space); with
no candidate, the first index scans in full. ``QueryHints`` ride on the
plan; the ``query_index`` hint restricts the candidates to one index.
The schema's interceptors (``planning/interceptors.py``) may rewrite the
filter before planning and veto the chosen plan after it; the built-in
guards refuse a full-table scan under ``geomesa.scan.block-full-table``
and a date-less or too-long query under
``geomesa.guard.temporal.max.days``. An ``Explainer`` records each step
in the reference's words (``GeoDataset.explain``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from geomesa_tpu_torch import config
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import CompiledFilter, compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.index.keyspace import KeyPlan
from geomesa_tpu_torch.index.store import FeatureStore
from geomesa_tpu_torch.planning import interceptors
from geomesa_tpu_torch.planning.explain import Explainer
from geomesa_tpu_torch.stats import sketches as sk

#: index preference multipliers of the decider
_MULTIPLIER = {"id": 0.5, "z3": 1.0, "xz3": 1.0, "s3": 1.0,
               "z2": 1.5, "xz2": 1.5, "s2": 1.5, "attr": 2.0}


@dataclass
class QueryHints:
    """Per-query hints (the reference's QueryHints surface, less
    ``loose_bbox``)."""

    #: force a specific index by name (QUERY_INDEX hint)
    query_index: Optional[str] = None
    #: 1-in-n sampling (SAMPLING hint)
    sampling: Optional[int] = None
    #: per-key sampling attribute (SAMPLE_BY hint): 1-in-n per key value
    sample_by: Optional[str] = None
    max_features: Optional[int] = None
    #: attribute projection
    properties: Optional[List[str]] = None
    #: sort: list of (attribute, descending)
    sort_by: Optional[List[tuple]] = None


@dataclass
class QueryPlan:
    """Everything the executor needs for one query. ``ecql`` is the
    query's text (``"<ir>"`` for a parsed filter), as the audit log
    records it."""

    schema: str
    filter: ir.Filter
    compiled: CompiledFilter
    key_plan: KeyPlan
    index_name: str
    est_count: float = 0.0
    hints: QueryHints = field(default_factory=QueryHints)
    ecql: str = "<ir>"

    @property
    def is_empty(self) -> bool:
        return self.key_plan.disjoint or isinstance(self.filter, ir.Exclude)


def plan_query(store: FeatureStore, ecql: Union[str, ir.Filter],
               hints: Optional[QueryHints] = None,
               explain: Optional[Explainer] = None) -> QueryPlan:
    """Plan ECQL text or an already-parsed filter. With the
    ``query_index`` hint only that index may serve, and a query it cannot
    serve raises. A guard or an interceptor's veto raises ``ValueError``.
    ``explain`` receives the reference's explain lines."""
    ft = store.ft
    hints = hints or QueryHints()
    exp = explain or Explainer(enabled=False)
    if isinstance(ecql, ir.Filter):
        f, text = ecql, "<ir>"
    else:
        text = ecql
        f = parse_ecql(ecql)
    exp.push(f"Planning '{ft.name}' query")
    exp.line(f"Filter: {text}")
    f2 = interceptors.apply_rewrite(ft, f)
    if f2 is not f:
        exp.line("Filter rewritten by interceptor")
        f = f2
    candidates = [kp for kp in (ks.plan(ft, f) for ks in store.keyspaces
                                if not hints.query_index
                                or ks.name == hints.query_index)
                  if kp is not None]
    if not candidates:
        if hints.query_index:
            raise ValueError(f"index {hints.query_index!r} cannot serve this query")
        candidates = [KeyPlan(store.keyspaces[0], full_scan=True)]
    exp.push(f"Candidate indices: {[c.keyspace.name for c in candidates]}")
    chosen, cost = _decide(store, candidates, exp)
    exp.pop()
    exp.line(
        f"Chosen index: {chosen.keyspace.name} "
        f"(estimated count {cost:.0f}, {len(chosen.ranges)} ranges"
        + (f", {len(chosen.bins)} time bins" if chosen.bins is not None else "")
        + ")"
    )
    guard(store, chosen, f)
    compiled = compile_filter(f, ft, store.dicts)
    exp.line(f"Predicate columns: {compiled.columns}")
    exp.pop()
    plan = QueryPlan(ft.name, f, compiled, chosen, chosen.keyspace.name, cost, hints, text)
    # the schema's guard hooks may veto the chosen plan (raise)
    interceptors.apply_guards(ft, plan)
    return plan


def _decide(store: FeatureStore, candidates: List[KeyPlan],
            exp: Explainer) -> Tuple[KeyPlan, float]:
    """The cheapest candidate by weighted estimate (the first on ties; a
    disjoint plan always wins). Unless ``geomesa.strategy.decider`` is
    ``cost``, the first candidate, estimated at the whole table."""
    total = float(store.count)
    if config.STRATEGY_DECIDER.get() != "cost" and candidates:
        return candidates[0], total
    best, best_cost = None, None
    for kp in candidates:
        cost = _estimate(store, kp, total)
        weighted = cost * _MULTIPLIER.get(kp.keyspace.kind, 2.0) if not kp.disjoint else -1.0
        exp.line(f"{kp.keyspace.name}: estimated {cost:.0f} (weighted {weighted:.0f})")
        if best_cost is None or weighted < best_cost:
            best, best_cost = kp, weighted
    return best, max(best_cost, 0.0)


def guard(store: FeatureStore, kp: KeyPlan, f: ir.Filter) -> None:
    """The built-in guards: refuse a full-table scan under
    ``geomesa.scan.block-full-table``, and under
    ``geomesa.guard.temporal.max.days`` a query of a dated schema that does
    not bound its date or spans more days than the limit. Config-dependent,
    so a cached plan checks them again on every call."""
    if kp.full_scan and config.BLOCK_FULL_TABLE_SCANS.to_bool():
        raise ValueError(
            "full-table scan blocked (geomesa.scan.block-full-table=true); "
            "add spatial/temporal/attribute predicates"
        )
    max_days = config.TEMPORAL_GUARD_MAX_DAYS.to_int()
    if max_days and store.ft.dtg_field:
        iv = ir.extract_intervals(f, store.ft.dtg_field)
        if iv.is_empty:
            raise ValueError(
                f"temporal guard: query must constrain {store.ft.dtg_field!r}"
            )
        span_ms = sum(hi - lo for lo, hi in iv.values)
        if span_ms > max_days * 86_400_000:
            raise ValueError(
                f"temporal guard: query spans {span_ms / 86_400_000:.1f} days "
                f"> limit {max_days}"
            )


def _estimate(store: FeatureStore, kp: KeyPlan, total: float) -> float:
    """Estimated rows of one key plan from the store's sketches."""
    if kp.disjoint:
        return 0.0
    if kp.full_scan:
        return total
    kind = kp.keyspace.kind
    if kind == "z3" and kp.bins is not None:
        z3h = store.stats.get("z3-histogram")
        if z3h is not None and not z3h.is_empty:
            return z3h.estimate_count(kp.bins, kp.ranges)
        return total * kp.coverage
    if kind == "z2":
        z2h = store.stats.get("z2-histogram")
        if z2h is not None and not z2h.is_empty:
            return z2h.estimate_count(kp.ranges)
        return total * min(1.0, kp.coverage * 4)
    if kind == "xz2":
        return total * min(1.0, kp.coverage * 4)
    if kind == "id":
        return float(len(kp.ids))
    if kind == "attr":
        attr = kp.keyspace.attr
        enum = store.stats.get(f"enum-{attr}")
        if isinstance(enum, sk.EnumerationStat) and not enum.is_empty:
            est = 0.0
            d = store.dicts.get(attr)
            for lo, hi in kp.bounds:
                if lo == hi and d is not None:
                    est += enum.counts.get(d.code_of(str(lo)), 0)
                else:
                    est += total * 0.1
            return est
        mm = store.stats.get(f"minmax-{attr}")
        if isinstance(mm, sk.MinMax) and not mm.is_empty:
            span = float(mm.hi) - float(mm.lo) or 1.0
            est = 0.0
            for lo, hi in kp.bounds:
                lo2 = float(mm.lo) if lo is None else float(lo)
                hi2 = float(mm.hi) if hi is None else float(hi)
                est += total * max(0.0, min(hi2, float(mm.hi)) - max(lo2, float(mm.lo))) / span
            return est
        return total * 0.1
    return total * kp.coverage
