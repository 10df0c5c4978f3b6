"""Query templates: split viewport literals out of a predicate tree.

Port of ``geomesa_tpu/filter/template.py`` over the port's compiled
filters. A query-axis batch serves M *distinct* viewports in one call by
making the bbox / time-window literals data instead of constants:

* :func:`split_literals` partitions a parsed filter into literal SLOTS (a
  BBOX over a point-geometry column, a DURING over a date column) and a
  RESIDUAL tree (everything else, verbatim). Two queries share a
  structural template iff their slot layout and residual repr match; only
  the slot values differ.
* :func:`compile_batched` compiles one template into a mask whose f32 /
  int32 compares are op for op the ones :func:`compile_filter` bakes, with
  each member's literals as 0-d tensors (``xp`` is torch: the batch runs
  on tensors, on the CPU or the card), so a member's batched mask keeps
  exactly the rows of its serial compiled predicate.

Slots are taken only in positive conjunctive position (top-level AND, no
NOT / OR above them): that keeps the f32 rounding polarity of the batched
compare equal to the serial compile's (which flips inclusive / strict
under odd NOT nesting).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import CompiledFilter, during_device_bounds
from geomesa_tpu_torch.schema.feature_type import FeatureType


@dataclass(frozen=True)
class Slot:
    """One literal slot: ``kind`` ("bbox" | "during"), the property it
    constrains, and its offset into the float / int literal vectors."""

    kind: str
    prop: str
    f_off: int
    i_off: int


@dataclass
class QueryTemplate:
    """One query's structural template and its literal values. Equal
    ``key``s compile to the same batched mask; ``lits_f`` / ``lits_i``
    are this query's slot values, laid out per ``slots``."""

    key: tuple
    slots: Tuple[Slot, ...]
    residual: ir.Filter
    lits_f: np.ndarray  # [nf] float32
    lits_i: np.ndarray  # [ni] int32


def _flatten_and(f: ir.Filter) -> List[ir.Filter]:
    if isinstance(f, ir.And):
        out: List[ir.Filter] = []
        for c in f.children:
            out.extend(_flatten_and(c))
        return out
    return [f]


def _attr(ft: FeatureType, prop):
    if not isinstance(prop, str):
        return None
    try:
        return ft.attr(prop)
    except KeyError:
        return None


def _is_point_geom(ft: FeatureType, prop) -> bool:
    a = _attr(ft, prop)
    return a is not None and a.is_geom and a.is_point


def _is_date(ft: FeatureType, prop) -> bool:
    a = _attr(ft, prop)
    return a is not None and a.type == "date"


def split_literals(f: ir.Filter, ft: FeatureType) -> Optional[QueryTemplate]:
    """The viewport-literal template of ``f``, or None when no top-level
    conjunct can become a slot. A BBOX under OR / NOT stays in the
    residual."""
    slots: List[Slot] = []
    slot_descr: List[tuple] = []
    residual: List[ir.Filter] = []
    lits_f: List[float] = []
    lits_i: List[int] = []
    for node in _flatten_and(f):
        if isinstance(node, ir.BBox) and _is_point_geom(ft, node.prop):
            slots.append(Slot("bbox", node.prop, len(lits_f), len(lits_i)))
            slot_descr.append(("bbox", node.prop))
            # the f32 images of the bounds, as the serial box test bakes
            # them (x0, y0, x1, y1)
            lits_f.extend(float(np.float32(v))
                          for v in (node.xmin, node.ymin, node.xmax, node.ymax))
        elif isinstance(node, ir.During) and _is_date(ft, node.prop):
            slots.append(Slot("during", node.prop, len(lits_f), len(lits_i)))
            slot_descr.append(("during", node.prop))
            # the serial compile's quantized (bin, offset) bounds
            lits_i.extend(during_device_bounds(ft, node.lo_ms, node.hi_ms))
        else:
            residual.append(node)
    if not slots:
        return None
    res: ir.Filter = (ir.Include() if not residual
                      else residual[0] if len(residual) == 1
                      else ir.And(tuple(residual)))
    return QueryTemplate(
        key=("qtpl.v1", tuple(slot_descr), repr(res)), slots=tuple(slots),
        residual=res, lits_f=np.asarray(lits_f, np.float32),
        lits_i=np.asarray(lits_i, np.int32),
    )


@dataclass
class BatchedFilter:
    """The literal-parameterized mask of one template, in two halves: the
    compiled ``residual``, whose mask and band are the same for every
    member (the executor evaluates them once per batch), and the member's
    ``slots(cols, xp, lf, li)`` with its literal vectors ``lf`` / ``li``
    (1-d, indexed by the slots' offsets) and ``slots_band`` (None without a
    banded slot). A member's mask is ``residual & slots``, its f32
    uncertainty band ``residual.band | slots_band``: the reference's
    ``fn`` and ``band`` (boolean AND and OR over exact masks do not depend
    on the order). ``columns``: every column the mask reads."""

    residual: CompiledFilter
    slots: Callable
    slots_band: Optional[Callable]
    columns: List[str]
    #: the residual needs no host refinement beyond the band: the
    #: executor's batch-eligibility gate
    device_exact: bool


def _bbox_slot_fn(slot: Slot):
    xc, yc = slot.prop + "__x", slot.prop + "__y"
    o = slot.f_off

    def fn(cols, xp, lf, li):
        # the serial f32 box test (inclusive, even polarity)
        x, y = cols[xc].to(xp.float32), cols[yc].to(xp.float32)
        return (x >= lf[o]) & (x <= lf[o + 2]) & (y >= lf[o + 1]) & (y <= lf[o + 3])

    def band(cols, xp, lf, li):
        # the rows colliding with any of the four f32 bounds: the row set
        # the serial compile's band registers
        x, y = cols[xc].to(xp.float32), cols[yc].to(xp.float32)
        return (x == lf[o]) | (x == lf[o + 2]) | (y == lf[o + 1]) | (y == lf[o + 3])

    return fn, band, [xc, yc]


def _during_slot_fn(slot: Slot):
    cb, co = slot.prop + "__bin", slot.prop + "__off"
    o = slot.i_off

    def fn(cols, xp, lf, li):
        # lexicographic (bin, offset) compare, bounds as data
        b, off = cols[cb], cols[co]
        ge = (b > li[o]) | ((b == li[o]) & (off >= li[o + 1]))
        le = (b < li[o + 2]) | ((b == li[o + 2]) & (off <= li[o + 3]))
        return ge & le

    return fn, None, [cb, co]


def compile_batched(tpl: QueryTemplate, residual_compiled: CompiledFilter) -> BatchedFilter:
    """The batched mask of one template. ``residual_compiled`` is the
    caller's :func:`compile_filter` of ``tpl.residual``, so string codes,
    f32 bands and refinements keep their one implementation."""
    slot_fns: List[Callable] = []
    slot_bands: List[Callable] = []
    columns = list(residual_compiled.columns)
    for slot in tpl.slots:
        fn, band, cols = (_bbox_slot_fn(slot) if slot.kind == "bbox"
                          else _during_slot_fn(slot))
        slot_fns.append(fn)
        if band is not None:
            slot_bands.append(band)
        for c in cols:
            if c not in columns:
                columns.append(c)

    def slots(cols, xp, lf, li):
        m = slot_fns[0](cols, xp, lf, li)
        for sfn in slot_fns[1:]:
            m = m & sfn(cols, xp, lf, li)
        return m

    slots_band = None
    if slot_bands:

        def slots_band(cols, xp, lf, li):  # noqa: F811
            m = slot_bands[0](cols, xp, lf, li)
            for sb in slot_bands[1:]:
                m = m | sb(cols, xp, lf, li)
            return m

    return BatchedFilter(
        residual=residual_compiled, slots=slots, slots_band=slots_band, columns=columns,
        device_exact=(residual_compiled.refine is None
                      or residual_compiled.refine_only_if_band),
    )
