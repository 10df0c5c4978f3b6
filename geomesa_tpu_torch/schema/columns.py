"""Columnar feature encoding (struct of arrays).

Copy of ``geomesa_tpu/schema/columns.py`` cut to the types this port serves:

* scalar attribute ``a``  -> column ``a`` (int32 / float32)
* date attribute ``d``    -> column ``d`` = int64 epoch-ms, plus the device
                              time pair ``d__bin`` / ``d__off`` (int32)
* point geometry ``g``    -> columns ``g__x``, ``g__y`` (float64)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from geomesa_tpu_torch.curves.binned_time import BinnedTime
from geomesa_tpu_torch.schema.feature_type import FeatureType


@dataclass
class ColumnBatch:
    """A batch of features as columns."""

    columns: Dict[str, np.ndarray]
    n: int

    @staticmethod
    def concat(batches: List["ColumnBatch"]) -> "ColumnBatch":
        if not batches:
            return ColumnBatch({}, 0)
        if len(batches) == 1:
            return batches[0]
        keys = batches[0].columns.keys()
        return ColumnBatch(
            {k: np.concatenate([b.columns[k] for b in batches]) for k in keys},
            sum(b.n for b in batches),
        )


def _to_epoch_ms(vals) -> np.ndarray:
    a = np.asarray(vals)
    if a.dtype.kind == "M":  # datetime64
        if a.dtype == np.dtype("datetime64[ms]"):
            return a.view(np.int64)  # same representation, no copy
        return a.astype("datetime64[ms]").astype(np.int64)
    if a.dtype.kind in "iuf":
        return a.astype(np.int64)
    # strings / datetimes / objects -> via numpy datetime parsing
    return np.array(
        [np.datetime64(v, "ms").astype(np.int64) for v in a], dtype=np.int64
    )


def encode_batch(ft: FeatureType, data: Dict[str, Any]) -> ColumnBatch:
    """Encode raw attribute arrays into the columnar layout.

    Point attributes take separate ``<name>__x``/``<name>__y`` arrays or an
    array of (x, y) pairs under the attribute's own name."""
    cols: Dict[str, np.ndarray] = {}
    n = None

    def set_n(m):
        nonlocal n
        if n is None:
            n = m
        elif n != m:
            raise ValueError(f"ragged batch: {m} != {n}")

    for a in ft.attributes:
        if a.is_point:
            xk, yk = a.name + "__x", a.name + "__y"
            if xk in data:
                xs = np.asarray(data[xk], np.float64)
                ys = np.asarray(data[yk], np.float64)
            else:
                vals = data.get(a.name)
                if vals is None:
                    raise KeyError(f"missing geometry attribute {a.name!r}")
                xy = np.asarray(vals, np.float64).reshape(-1, 2)
                xs, ys = xy[:, 0].copy(), xy[:, 1].copy()
            set_n(len(xs))
            cols[xk], cols[yk] = xs, ys
        elif a.type == "date":
            vals = data.get(a.name)
            if vals is None:
                raise KeyError(f"missing date attribute {a.name!r}")
            enc = _to_epoch_ms(vals)
            set_n(len(enc))
            cols[a.name] = enc
            # device time representation: the (bin, scaled offset) int32
            # pair — int64 epoch-ms never reaches the device
            b, off = BinnedTime(ft.time_period).to_scaled(enc)
            cols[a.name + "__bin"] = b
            cols[a.name + "__off"] = off
        else:
            vals = np.asarray(data[a.name]).astype(np.dtype(a.type))
            set_n(len(vals))
            cols[a.name] = vals
    if n is None:
        raise ValueError("empty batch")
    return ColumnBatch(cols, n)
