"""Cross-query fusion: eligibility keys and micro-batch executors.

Copy of ``geomesa_tpu/serving/fuse.py``. Two queries may fuse when they
would run the same scan: same schema, predicate text, auths and op shape.

* ``count`` / ``density`` / ``stats`` / ``join_count`` *repeats* (one
  question asked N times): the group runs the serial public call once and
  every member gets its own copy of the result.
* *Distinct viewports* of one structural template (requests whose ECQL
  differs only in BBOX / temporal literals, and for density in the grid
  bbox): one query-axis batch (``GeoDataset.count_batch`` /
  ``density_batch`` / ``stats_batch``), each member's literals as data. A
  None from the batch (not batchable) runs the members one at a time.
* ``density_curve``: members share layer, filter and level but ask for
  different crops (``density_curve_batch``), or different viewport
  literals (``density_curve_filter_batch``).

Every fused member keeps its own root span and audit event (hints
``fused``, ``fused_batch`` and, for a distinct batch, ``fused_member`` and
``distinct``). Queries carrying hints that change the execution per member
(sampling, max_features, sort, properties, an explicit index) never fuse.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from geomesa_tpu_torch import config, tracing
from geomesa_tpu_torch.serving.scheduler import FusedMemberError, FuseSpec, Ticket

#: opts keys that make a query ineligible for fusion
_UNFUSABLE_HINTS = ("sampling", "sample_by", "max_features", "properties", "sort_by", "index")

#: the only opts keys a fusable request may carry with a truthy value: an
#: allow-list, so an unknown result-affecting key makes the query run alone
#: instead of fusing two queries that differ in it. A polygon ``region``
#: is folded into the ECQL text before keying and is not listed.
_FUSABLE_KEYS = frozenset(
    ("op", "name", "schema", "ecql", "auths", "exact", "speculative_ok",
     "bbox", "width", "height", "weight", "level", "stat",
     "right", "predicate", "distance", "dx", "dy", "right_ecql")
    + _UNFUSABLE_HINTS
)

_MISS = object()


def _auths_key(opts: Dict[str, Any]):
    a = opts.get("auths")
    return None if a is None else tuple(a)


def _structural_key(ds, schema: str, ecql: str) -> Optional[tuple]:
    """The query's structural-template key (``filter/template.py``), or
    None when it has no batchable viewport literal. Memoized per
    (schema, ecql) on the dataset, so a query text is parsed once."""
    if ds is None or not config.SERVING_FUSION_DISTINCT.to_bool():
        return None
    cache = ds.__dict__.setdefault("_template_key_cache", {})
    ck = (schema, ecql)
    hit = cache.get(ck, _MISS)
    if hit is not _MISS:
        return hit
    out = None
    try:
        from geomesa_tpu_torch.filter import template as ftpl
        from geomesa_tpu_torch.filter.ecql import parse_ecql

        t = ftpl.split_literals(parse_ecql(ecql), ds._store(schema).ft)
        out = t.key if t is not None else None
    except Exception:
        out = None
    if len(cache) >= 1024:
        cache.clear()
    cache[ck] = out
    return out


def fuse_key(op: str, schema: str, opts: Dict[str, Any], ds=None) -> Optional[tuple]:
    """The fusion-compatibility key of one request, or None when it is
    ineligible. With ``ds`` and ``geomesa.serving.fusion.distinct`` on, a
    count / density / stats / density_curve whose ECQL has batchable
    viewport literals keys on its structural template, so requests that
    differ only in those literals share a key."""
    if any(opts.get(k) for k in _UNFUSABLE_HINTS):
        return None
    if any(v is not None and v is not False and k not in _FUSABLE_KEYS
           for k, v in opts.items()):
        return None
    ecql = opts.get("ecql", "INCLUDE")
    auths = _auths_key(opts)
    if op == "count":
        exact = bool(opts.get("exact", True))
        skel = _structural_key(ds, schema, ecql) if exact else None
        return ("count", schema, ("skel",) + skel if skel is not None else ecql, auths, exact)
    if op == "density":
        bbox = opts.get("bbox")
        # distinct density batches only unweighted grids (exact integer
        # cells); weighted grids fuse as literal repeats only
        skel = _structural_key(ds, schema, ecql) if opts.get("weight") is None else None
        if skel is not None:
            return ("density", schema, ("skel",) + skel, auths, None,
                    int(opts.get("width", 256)), int(opts.get("height", 256)), None)
        return ("density", schema, ecql, auths,
                tuple(bbox) if bbox is not None else None,
                int(opts.get("width", 256)), int(opts.get("height", 256)),
                opts.get("weight"))
    if op == "density_curve":
        # the crop is not in the key: different crops stack into one pass
        skel = _structural_key(ds, schema, ecql)
        return ("density_curve", schema, ("skel",) + skel if skel is not None else ecql,
                auths, int(opts.get("level", 9)), opts.get("weight"))
    if op == "join_count":
        return ("join_count", schema, opts.get("right"), opts.get("predicate"),
                opts.get("distance"), opts.get("dx"), opts.get("dy"), ecql,
                opts.get("right_ecql", "INCLUDE"), auths)
    if op == "stats":
        skel = _structural_key(ds, schema, ecql)
        return ("stats", schema, ("skel",) + skel if skel is not None else ecql,
                auths, opts.get("stat"))
    return None


def subscription_key(spec) -> tuple:
    """The standing-subscriber fusion identity: every result-affecting spec
    field (the bbox as exact float reprs, region WKT, grid dims, pyramid
    depth, stat spec), so two subscriptions fuse exactly when their results
    are equal forever."""
    return (
        "standing", spec.schema, spec.aggregate,
        tuple(repr(float(v)) for v in spec.bbox),
        spec.region,
        int(spec.width), int(spec.height), int(spec.levels),
        spec.stat_spec,
    )


def make_spec(ds, op: str, schema: str, opts: Dict[str, Any]) -> Optional[FuseSpec]:
    """A :class:`FuseSpec` whose batch executor returns raw results (ints,
    grids, stats), or None when the request cannot fuse."""
    key = fuse_key(op, schema, opts, ds=ds)
    if key is None:
        return None
    return FuseSpec(
        key=("local", op, schema) + key,
        payload=dict(opts),
        batch=lambda tickets: run_batch(ds, op, schema, tickets),
        schema=schema,
    )


def _query_from(opts: Dict[str, Any]):
    from geomesa_tpu_torch.api.dataset import Query

    return Query(ecql=opts.get("ecql", "INCLUDE"), auths=opts.get("auths"))


def _member_span(t: Ticket, op: str, batch_n: int) -> None:
    """A non-primary member's own root span, under its trace id when it
    brought one. Called with no trace active on the thread."""
    with tracing.start(f"fused.{op}.member", trace_id=t.trace_id,
                       force=t.trace_id is not None) as sp:
        sp.set(fused=True, fused_batch=batch_n, queue_wait_ms=round(t.wait_s * 1e3, 3))


def _member_record(ds, schema: str, t: Ticket, op: str, ecql: str, hits: int,
                   batch_n: int, primary_tid: Optional[str]) -> None:
    """A non-primary member of a repeat group: its own root span and its
    own audit event."""
    _member_span(t, op, batch_n)
    hints: Dict[str, Any] = {"op": op, "fused": True, "fused_batch": batch_n, "user": t.user}
    if t.trace_id is not None:
        hints["trace_id"] = t.trace_id
    if primary_tid is not None and primary_tid != t.trace_id:
        hints["fused_primary"] = primary_tid
    ds.audit.record(schema, ecql, hints, 0.0, 0.0, hits, user=t.user)


def _placement_attrs(primary: Ticket) -> Dict[str, Any]:
    """The dispatcher's placement decision for the group, as span
    attributes."""
    p = getattr(primary.fuse, "placement", None)
    if not p:
        return {}
    return {f"placement_{k}": v for k, v in p.items()}


def run_batch(ds, op: str, schema: str, tickets: List[Ticket]) -> List[Any]:
    """Run one fused group; one raw result per ticket, in order. Repeats
    run the primary's full public call once; distinct viewports ride a
    query-axis batch (:func:`_run_distinct`)."""
    primary = tickets[0]
    opts = primary.fuse.payload
    ecql = opts.get("ecql", "INCLUDE")
    n_batch = len(tickets)

    if op == "density_curve":
        return _density_curve_batch(ds, schema, tickets)

    if n_batch > 1 and op in ("count", "density", "stats"):
        distinct = any(t.fuse.payload.get("ecql", "INCLUDE") != ecql for t in tickets[1:])
        if op == "density" and not distinct:
            bb0 = opts.get("bbox")
            distinct = any(t.fuse.payload.get("bbox") != bb0 for t in tickets[1:])
        if distinct:
            return _run_distinct(ds, op, schema, tickets)

    # repeat fusion: the serial call, run once
    with tracing.start(f"fused.{op}", trace_id=primary.trace_id,
                       force=primary.trace_id is not None,
                       fused_batch=n_batch, **_placement_attrs(primary)):
        q = _query_from(opts)
        if op == "count":
            result = ds.count(schema, q, exact=bool(opts.get("exact", True)))
            hits = int(result)
        elif op == "join_count":
            from geomesa_tpu_torch.api.dataset import Query

            result = ds.join_count(
                schema, opts["right"], predicate=opts["predicate"],
                distance=opts.get("distance"), dx=opts.get("dx"), dy=opts.get("dy"),
                left_query=q,
                right_query=Query(ecql=opts.get("right_ecql", "INCLUDE"),
                                  auths=opts.get("auths")),
            )
            hits = int(result)
        elif op == "density":
            result = ds.density(schema, q, bbox=opts.get("bbox"),
                                width=int(opts.get("width", 256)),
                                height=int(opts.get("height", 256)),
                                weight=opts.get("weight"))
            hits = int(np.count_nonzero(result))
        elif op == "stats":
            result = ds.stats(schema, opts["stat"], q)
            hits = 0
        else:
            raise ValueError(f"unfusable op {op!r}")
    # each member gets its own result object, and its bookkeeping failures
    # stay its own: the batch ran, and a fallback would repeat it
    out: List[Any] = [result]
    for t in tickets[1:]:
        try:
            _member_record(ds, schema, t, op, ecql, hits, n_batch, primary.trace_id)
            out.append(_own_copy(result))
        except Exception as e:
            out.append(FusedMemberError(e))
    return out


def _run_distinct(ds, op: str, schema: str, tickets: List[Ticket]) -> List[Any]:
    """Distinct-viewport fusion: one query-axis batch serving every
    member's own literals; the batch call writes one audit event per
    member. When the batch declines (None), every member runs its serial
    call under its own trace and user."""
    primary = tickets[0]
    opts = primary.fuse.payload
    n_batch = len(tickets)
    queries = [_query_from(t.fuse.payload) for t in tickets]
    meta = [{"trace_id": t.trace_id, "user": t.user} for t in tickets]
    with tracing.start(f"fused.{op}.distinct", trace_id=primary.trace_id,
                       force=primary.trace_id is not None,
                       fused_batch=n_batch, distinct=True, **_placement_attrs(primary)):
        if op == "count":
            out = ds.count_batch(schema, queries, exact=bool(opts.get("exact", True)),
                                 members=meta)
        elif op == "density":
            out = ds.density_batch(schema, queries,
                                   bboxes=[t.fuse.payload.get("bbox") for t in tickets],
                                   width=int(opts.get("width", 256)),
                                   height=int(opts.get("height", 256)),
                                   weight=None, members=meta)
        else:
            out = ds.stats_batch(schema, opts["stat"], queries, members=meta)
    if out is None:
        out = []
        for t, q in zip(tickets, queries):
            try:
                with ds.serving.member_user(t.user), \
                        tracing.start(f"fused.{op}.serial", trace_id=t.trace_id,
                                      force=t.trace_id is not None):
                    if op == "count":
                        r = ds.count(schema, q, exact=bool(opts.get("exact", True)))
                    elif op == "density":
                        r = ds.density(schema, q, bbox=t.fuse.payload.get("bbox"),
                                       width=int(opts.get("width", 256)),
                                       height=int(opts.get("height", 256)))
                    else:
                        r = ds.stats(schema, opts["stat"], q)
                out.append(r)
            except Exception as e:
                out.append(FusedMemberError(e))
        return out
    for i, t in enumerate(tickets[1:], start=1):
        try:
            _member_span(t, op, n_batch)
        except Exception as e:
            out[i] = FusedMemberError(e)
    return out


def _own_copy(result):
    """An independently mutable copy of a fused result (scalars pass
    through, grids copy, stats deep-copy)."""
    if isinstance(result, np.ndarray):
        return result.copy()
    if isinstance(result, (int, float, str, bytes, bool)) or result is None:
        return result
    try:
        return copy.deepcopy(result)
    except Exception:  # an exotic result: shared read-only
        return result


def _density_curve_batch(ds, schema: str, tickets: List[Ticket]) -> List[Any]:
    """Tile fusion: one pass over the stacked crops of one filter, or,
    when the members' ECQL texts differ, the distinct-filter curve batch
    (serial per member when it declines)."""
    primary = tickets[0]
    opts = primary.fuse.payload
    level = int(opts.get("level", 9))
    weight = opts.get("weight")
    ecql0 = opts.get("ecql", "INCLUDE")
    members = [{"bbox": t.fuse.payload.get("bbox"), "trace_id": t.trace_id, "user": t.user}
               for t in tickets]
    if any(t.fuse.payload.get("ecql", "INCLUDE") != ecql0 for t in tickets[1:]):
        return _density_curve_distinct(ds, schema, tickets, level, weight, members)
    with tracing.start("fused.density_curve", trace_id=primary.trace_id,
                       force=primary.trace_id is not None, fused_batch=len(tickets)):
        out = ds.density_curve_batch(schema, _query_from(opts), level=level,
                                     bboxes=[m["bbox"] for m in members], weight=weight,
                                     members=members)
    for i, t in enumerate(tickets[1:], start=1):
        try:
            _member_span(t, "density_curve", len(tickets))
        except Exception as e:
            out[i] = FusedMemberError(e)
    return out


def _density_curve_distinct(ds, schema: str, tickets: List[Ticket], level: int, weight,
                            members) -> List[Any]:
    """Distinct-filter curve fusion: each member's own literals and crop
    in one batched call; serial per member when it declines."""
    primary = tickets[0]
    queries = [_query_from(t.fuse.payload) for t in tickets]
    meta = [{"trace_id": t.trace_id, "user": t.user} for t in tickets]
    with tracing.start("fused.density_curve.distinct", trace_id=primary.trace_id,
                       force=primary.trace_id is not None, fused_batch=len(tickets),
                       distinct=True, **_placement_attrs(primary)):
        out = ds.density_curve_filter_batch(schema, queries, level=level,
                                            bboxes=[m["bbox"] for m in members],
                                            weight=weight, members=meta)
    if out is None:
        out = []
        for t, q in zip(tickets, queries):
            try:
                with ds.serving.member_user(t.user), \
                        tracing.start("fused.density_curve.serial", trace_id=t.trace_id,
                                      force=t.trace_id is not None):
                    out.append(ds.density_curve(schema, q, level=level,
                                                bbox=t.fuse.payload.get("bbox"),
                                                weight=weight))
            except Exception as e:
                out.append(FusedMemberError(e))
        return out
    for i, t in enumerate(tickets[1:], start=1):
        try:
            _member_span(t, "density_curve", len(tickets))
        except Exception as e:
            out[i] = FusedMemberError(e)
    return out
