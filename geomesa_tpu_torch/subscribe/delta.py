"""The standing-query evaluator.

Copy of ``geomesa_tpu/subscribe/delta.py``. One routine serves both halves
of the incremental contract: the delta path runs it over an applied ingest
batch's rows and adds the partial into the standing result; the re-scan
runs the same routine over the whole window from zero. Every aggregate is
integer-valued exact algebra (counts, unweighted f32 cells to 2^24, f64
pyramid cells to 2^53, exact-merge sketches), so a delta-accumulated result
equals the re-scan bit for bit; ``geomesa.subscribe.verify`` asserts it.

It runs on the host with numpy, as the reference's does on its numpy
backend: the compiled viewport mask's ``exact_mask``, the port's
``kernels/density.py::density_grid_np``, ``cache/hierarchy.py::downsample``
and ``kernels/stats_scan.py::decode_enum_keys``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from geomesa_tpu_torch.cache import hierarchy
from geomesa_tpu_torch.cache.store import decode_wire_value, encode_wire_value
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.kernels.density import density_grid_np
from geomesa_tpu_torch.kernels.stats_scan import decode_enum_keys
from geomesa_tpu_torch.stats import parse_stat
from geomesa_tpu_torch.stats import sketches as sk


def compile_viewport(spec, ft, dicts):
    """The spec's membership predicate compiled against a schema: the one
    membership decision of the subsystem."""
    geom = ft.geom_field
    if geom is None:
        raise ValueError(f"[GM-ARG] schema {spec.schema!r} has no geometry field")
    return compile_filter(parse_ecql(spec.ecql(geom)), ft, dicts)


def member_mask(cf, ft, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Exact viewport membership over ``n`` rows; a null or NaN geometry
    is never inside."""
    if n == 0:
        return np.zeros(0, dtype=bool)
    m = cf.exact_mask(cols, n)
    g = ft.geom_field
    gx = cols.get(g + "__x") if g is not None else None
    if gx is not None:
        m = m & np.isfinite(gx)
    return m


def zero_result(spec):
    if spec.aggregate == "count":
        return 0
    if spec.aggregate == "density":
        return np.zeros((spec.height, spec.width), np.float32)
    if spec.aggregate == "pyramid":
        side = 1 << spec.levels
        out = []
        while side >= 1:
            out.append(np.zeros((side, side), np.float64))
            side >>= 1
        return out
    if spec.aggregate == "stats":
        return parse_stat(spec.stat_spec)
    raise ValueError(spec.aggregate)


def _pyramid_leaf(spec, xs, ys, mask) -> np.ndarray:
    """Leaf f64 count grid over the viewport bbox (side 2^levels), with
    the density grid's clip-cast binning."""
    side = 1 << spec.levels
    x0, y0, x1, y1 = spec.bbox
    dx, dy = x1 - x0, y1 - y0
    px = np.clip(((xs - x0) / dx * side).astype(np.int32), 0, side - 1)
    py = np.clip(((ys - y0) / dy * side).astype(np.int32), 0, side - 1)
    grid = np.zeros(side * side, np.float64)
    np.add.at(grid, py[mask] * side + px[mask], 1.0)
    return grid.reshape(side, side)


def eval_rows(spec, cf, ft, cols: Dict[str, np.ndarray], n: int, dicts=None):
    """The spec's aggregate over ``n`` rows: ``(partial, rows_matched)``.
    ``dicts`` decodes enumeration / top-k sketch keys to their values, as
    the query path does."""
    mask = member_mask(cf, ft, cols, n)
    matched = int(mask.sum())
    g = ft.geom_field
    if spec.aggregate == "count":
        return matched, matched
    if spec.aggregate == "density":
        if n == 0:
            return np.zeros((spec.height, spec.width), np.float32), 0
        grid = density_grid_np(cols[g + "__x"], cols[g + "__y"], mask, spec.bbox,
                               spec.width, spec.height)
        return grid, matched
    if spec.aggregate == "pyramid":
        if n == 0:
            return zero_result(spec), 0
        # the leaf, then downsample-added up the ancestors: a level-k cell
        # is exactly the sum of its four children
        d = _pyramid_leaf(spec, cols[g + "__x"], cols[g + "__y"], mask)
        out = [d]
        while d.shape[0] > 1:
            d = hierarchy.downsample(d)
            out.append(d)
        return out, matched
    if spec.aggregate == "stats":
        stat = zero_result(spec)
        if matched:
            stat.observe(cols, mask)
            if dicts is not None:
                decode_enum_keys(stat, dicts)
        return stat, matched
    raise ValueError(spec.aggregate)


def apply_delta(spec, result, delta, sign: int = 1):
    """Fold a partial into the standing result (in place for arrays).
    ``sign=-1`` subtracts; stats cannot, so their callers re-scan."""
    if spec.aggregate == "count":
        return result + sign * delta
    if spec.aggregate == "density":
        if sign >= 0:
            result += delta
        else:
            result -= delta
        return result
    if spec.aggregate == "pyramid":
        for lvl, d in zip(result, delta):
            if sign >= 0:
                lvl += d
            else:
                lvl -= d
        return result
    if spec.aggregate == "stats":
        if sign < 0:
            raise ValueError("stats aggregates cannot subtract")
        result.merge(delta)
        return result
    raise ValueError(spec.aggregate)


def results_equal(spec, a, b) -> bool:
    """Bit-identity of two results of one spec."""
    if spec.aggregate == "count":
        return int(a) == int(b)
    if spec.aggregate == "density":
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    if spec.aggregate == "pyramid":
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    if spec.aggregate == "stats":
        return a.to_json() == b.to_json()
    raise ValueError(spec.aggregate)


def encode_result(spec, result):
    """A result in the cache's wire form (the reference's codec)."""
    if spec.aggregate == "count":
        return encode_wire_value(int(result))
    if spec.aggregate == "density":
        return encode_wire_value(np.asarray(result, np.float32))
    if spec.aggregate == "pyramid":
        return encode_wire_value(tuple(np.asarray(g) for g in result))
    if spec.aggregate == "stats":
        return encode_wire_value(result.to_json())
    raise ValueError(spec.aggregate)


def decode_result(spec, d):
    v = decode_wire_value(d)
    if spec.aggregate == "count":
        return int(v)
    if spec.aggregate == "density":
        return np.asarray(v, np.float32)
    if spec.aggregate == "pyramid":
        return [np.asarray(g, np.float64) for g in v]
    if spec.aggregate == "stats":
        return sk.Stat.from_json(v)
    raise ValueError(spec.aggregate)
