"""Columnar feature encoding (struct of arrays).

Copy of ``geomesa_tpu/schema/columns.py`` cut to the types this port serves
(JSON documents are left out):

* scalar attribute ``a``  -> column ``a`` (int32 / int64 / float32 / float64
                              / bool)
* string attribute ``s``  -> column ``s`` = int32 dictionary codes (-1 = null)
* date attribute ``d``    -> column ``d`` = int64 epoch-ms, plus the device
                              time pair ``d__bin`` / ``d__off`` (int32)
* point geometry ``g``    -> columns ``g__x``, ``g__y`` (float64)
* extent geometry ``g``   -> bounds ``g__xmin/__ymin/__xmax/__ymax``
                              (float64), the bounds' centroid as ``g__x`` /
                              ``g__y``, and the host-only object column
                              ``g__wkt`` (full-precision WKT)
* feature id              -> host-only fixed-width bytes column ``__fid__``
                              ('S'; 'U' for non-ASCII ids)

The native C++ helpers the JAX package may call here are left out; the
NumPy paths give the same columns.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from geomesa_tpu_torch.curves.binned_time import BinnedTime
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.utils import geometry as geo

#: ``DictionaryEncoder.encode`` takes its vectorized path from this many
#: values of a numpy unicode array
_VECTOR_MIN = 4096


class DictionaryEncoder:
    """Growable string -> int32 code dictionary: codes in first-seen order,
    -1 for null. The device never sees strings; string predicates resolve
    to code compares at plan time."""

    def __init__(self, values: Optional[List[str]] = None):
        self.values: List[str] = list(values or [])
        self._index: Dict[str, int] = {v: i for i, v in enumerate(self.values)}

    def __len__(self):
        return len(self.values)

    def encode(self, vals: Sequence[Optional[str]]) -> np.ndarray:
        """Codes of ``vals``, growing the dictionary. A numpy unicode
        array (no nulls) is encoded by ``np.unique``: its distinct values
        are numbered in order of their first row, which gives exactly the
        codes of the one-value-at-a-time loop."""
        if isinstance(vals, np.ndarray) and vals.dtype.kind == "U" \
                and len(vals) >= _VECTOR_MIN:
            uniq, first, inv = np.unique(vals, return_index=True,
                                         return_inverse=True)
            code_of_uniq = np.empty(len(uniq), np.int32)
            for u in np.argsort(first, kind="stable").tolist():
                v = str(uniq[u])
                code = self._index.get(v)
                if code is None:
                    code = self._index[v] = len(self.values)
                    self.values.append(v)
                code_of_uniq[u] = code
            return code_of_uniq[inv.reshape(-1)]
        out = np.empty(len(vals), dtype=np.int32)
        idx = self._index
        values = self.values
        for i, v in enumerate(vals):
            if v is None:
                out[i] = -1
                continue
            v = str(v)
            code = idx.get(v)
            if code is None:
                code = len(values)
                values.append(v)
                idx[v] = code
            out[i] = code
        return out

    def decode(self, codes: np.ndarray) -> List[Optional[str]]:
        return [None if c < 0 else self.values[c] for c in codes.tolist()]

    def code_of(self, v: str) -> int:
        """Lookup without growing; -2 if absent (matches nothing, nulls
        included)."""
        return self._index.get(str(v), -2)

    def to_list(self) -> List[str]:
        """The values in code order (a checkpoint's manifest form)."""
        return list(self.values)


@dataclass
class ColumnBatch:
    """A batch of features as columns."""

    columns: Dict[str, np.ndarray]
    n: int

    def select(self, mask: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({k: v[mask] for k, v in self.columns.items()},
                           int(np.sum(mask)))

    @staticmethod
    def concat(batches: List["ColumnBatch"],
               fills: Optional[Dict[str, Any]] = None) -> "ColumnBatch":
        """Concatenate batches, uniting their column sets: a column missing
        from some batch null-fills that batch's rows (``fills`` by column,
        see :func:`schema_null_fills`; else float NaN, string None, int32
        -1, other 0)."""
        if not batches:
            return ColumnBatch({}, 0)
        if len(batches) == 1:
            return batches[0]
        keys = dict.fromkeys(k for b in batches for k in b.columns)

        def _fill(name: str, n: int, dtype) -> np.ndarray:
            if fills is not None and name in fills:
                return np.full(n, fills[name], dtype)
            if dtype.kind == "f":
                return np.full(n, np.nan, dtype)
            if dtype.kind in "OUS":
                return np.full(n, None, object)
            if dtype == np.int32:
                return np.full(n, -1, dtype)
            return np.zeros(n, dtype)

        out = {}
        for k in keys:
            dtype = next(b.columns[k].dtype for b in batches if k in b.columns)
            out[k] = np.concatenate([
                b.columns[k] if k in b.columns else _fill(k, b.n, dtype)
                for b in batches
            ])
        return ColumnBatch(out, sum(b.n for b in batches))


def schema_null_fills(ft: FeatureType) -> Dict[str, Any]:
    """Per-column null fills for :meth:`ColumnBatch.concat`: string code
    -1, int / long / date 0, bool False (floats fall through to NaN), and
    the public visibility code 0 for ``__vis__``, which a partition
    reloaded from a lake snapshot carries."""
    fills: Dict[str, Any] = {"__vis__": 0}
    for a in ft.attributes:
        if a.is_geom:
            continue
        if a.type == "string":
            fills[a.name] = -1
        elif a.type in ("int32", "int64", "date"):
            fills[a.name] = 0
        elif a.type == "bool":
            fills[a.name] = False
    return fills


def null_columns(ft: FeatureType, attrs, n: int,
                 dicts: Dict[str, DictionaryEncoder]) -> Dict[str, np.ndarray]:
    """Columns for ``attrs`` holding ``n`` nulls of this layout (string ->
    code -1, float -> NaN, int / long -> 0, bool -> False, date -> epoch 0
    with its time bins). ``update_schema``'s column append and the
    partition snapshot's schema upgrade on load share it; it registers a
    string attribute's dictionary."""
    cols: Dict[str, np.ndarray] = {}
    for a in attrs:
        if a.type == "string":
            cols[a.name] = np.full(n, -1, np.int32)
            dicts.setdefault(a.name, DictionaryEncoder())
        elif a.type == "date":
            cols[a.name] = np.zeros(n, np.int64)
            b, off = BinnedTime(ft.time_period).to_scaled(cols[a.name])
            cols[a.name + "__bin"] = b
            cols[a.name + "__off"] = off
        elif a.type == "bool":
            cols[a.name] = np.zeros(n, bool)
        elif a.type in ("float32", "float64"):
            cols[a.name] = np.full(n, np.nan, np.dtype(a.type))
        else:
            cols[a.name] = np.zeros(n, np.dtype(a.type))
    return cols


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


def encode_batch(ft: FeatureType, data: Dict[str, Any],
                 dicts: Dict[str, DictionaryEncoder],
                 fids: Optional[Sequence[str]] = None) -> ColumnBatch:
    """Encode raw attribute arrays into the columnar layout.

    Point attributes take separate ``<name>__x``/``<name>__y`` arrays, or
    under the attribute's own name (x, y) pairs, Point objects or WKT
    strings; extent attributes take Geometry objects or WKT strings.
    Strings grow the attribute's dictionary in ``dicts``; ``None`` is
    null."""
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
                xs, ys = _point_xy(vals)
            set_n(len(xs))
            cols[xk], cols[yk] = xs, ys
        elif a.is_geom:
            vals = data.get(a.name)
            if vals is None:
                raise KeyError(f"missing geometry attribute {a.name!r}")
            geoms = [v if isinstance(v, geo.Geometry) else geo.parse_wkt(str(v))
                     for v in vals]
            set_n(len(geoms))
            b = np.asarray([g.bounds() for g in geoms], np.float64).reshape(-1, 4)
            cols[a.name + "__xmin"] = b[:, 0]
            cols[a.name + "__ymin"] = b[:, 1]
            cols[a.name + "__xmax"] = b[:, 2]
            cols[a.name + "__ymax"] = b[:, 3]
            # the bounds' centroid: the reference point of distance, kNN
            # and density
            cols[a.name + "__x"] = (b[:, 0] + b[:, 2]) / 2
            cols[a.name + "__y"] = (b[:, 1] + b[:, 3]) / 2
            cols[a.name + "__wkt"] = np.array([g.wkt() for g in geoms], dtype=object)
        elif a.type == "date":
            vals = data.get(a.name)
            if vals is None:
                raise KeyError(f"missing date attribute {a.name!r}")
            enc = _to_epoch_ms(vals)
            set_n(len(enc))
            cols[a.name] = enc
            # device time representation: the (bin, scaled offset) int32
            # pair; int64 epoch-ms never reaches the device
            b, off = BinnedTime(ft.time_period).to_scaled(enc)
            cols[a.name + "__bin"] = b
            cols[a.name + "__off"] = off
        elif a.type == "string":
            vals = data.get(a.name)
            if vals is None:
                raise KeyError(f"missing attribute {a.name!r}")
            if not (isinstance(vals, np.ndarray) and vals.dtype.kind == "U"):
                vals = list(vals)
            set_n(len(vals))
            d = dicts.setdefault(a.name, DictionaryEncoder())
            cols[a.name] = d.encode(vals)
        elif a.type == "bool":
            vals = np.asarray(data[a.name]).astype(bool)
            set_n(len(vals))
            cols[a.name] = vals
        else:
            vals = np.asarray(data[a.name]).astype(np.dtype(a.type))
            set_n(len(vals))
            cols[a.name] = vals
    if n is None:
        raise ValueError("empty batch")
    cols["__fid__"] = encode_fids(fids, n)
    return ColumnBatch(cols, n)


def encode_fids(fids, n: int) -> np.ndarray:
    """Feature ids as a fixed-width bytes ('S') column ('U' when an id is
    not ASCII). Ids not given are random 128-bit hex, made in one
    ``os.urandom`` pass."""
    if fids is None:
        return np.frombuffer(os.urandom(16 * n).hex().encode("ascii"), dtype="S32")
    a = np.asarray(fids)
    if len(a) != n:
        raise ValueError(f"{len(a)} fids for {n} rows")
    if a.dtype.kind == "S":
        return a
    if a.dtype.kind != "U":  # object / numeric: stringify
        a = a.astype("U")
    return _u_to_s(a)


def _u_to_s(a: np.ndarray) -> np.ndarray:
    """'U' -> 'S' for ASCII content by narrowing the code points in bulk;
    an array holding a non-ASCII id keeps the unicode layout."""
    w = a.dtype.itemsize // 4
    if w == 0:
        return a.astype("S1")
    cp = np.ascontiguousarray(a).view(np.uint32).reshape(len(a), w)
    if not (cp < 128).all():
        return a
    return cp.astype(np.uint8).view(f"S{w}").reshape(len(a))


def fid_strs(col: np.ndarray) -> np.ndarray:
    """Fid column -> unicode ('U') view; iterating yields ``str``."""
    a = np.asarray(col)
    if a.dtype.kind != "S":
        return a if a.dtype.kind == "U" else a.astype("U")
    w = a.dtype.itemsize
    if w == 0:
        return a.astype("U1")
    by = np.ascontiguousarray(a).view(np.uint8).reshape(len(a), w)
    if not (by < 128).all():  # UTF-8 bytes from outside: decode right
        return np.array([s.decode("utf-8", "replace") for s in a.tolist()])
    return by.astype(np.uint32).view(f"U{w}").reshape(len(a))


def _point_xy(vals):
    """(xs, ys) f64 of (x, y) pairs, Point objects or WKT strings."""
    if isinstance(vals, np.ndarray) and vals.dtype.kind in "fiu":
        xy = np.asarray(vals, np.float64).reshape(-1, 2)
        return xy[:, 0].copy(), xy[:, 1].copy()
    vals = list(vals)
    xs = np.empty(len(vals), np.float64)
    ys = np.empty(len(vals), np.float64)
    for i, v in enumerate(vals):
        if isinstance(v, geo.Point):
            xs[i], ys[i] = v.x, v.y
        elif isinstance(v, str):
            p = geo.parse_wkt(v)
            xs[i], ys[i] = p.x, p.y
        else:
            xs[i], ys[i] = float(v[0]), float(v[1])
    return xs, ys


def decode_batch(ft: FeatureType, batch: ColumnBatch,
                 dicts: Dict[str, DictionaryEncoder]) -> Dict[str, Any]:
    """Columns -> user-facing values (strings decoded, dates as
    datetime64[ms], points as (x, y) tuples, extent geometries as WKT
    strings). Attributes projected out of the batch (``Query.properties``)
    are skipped."""
    out: Dict[str, Any] = {"__fid__": fid_strs(batch.columns["__fid__"]).tolist()}
    for a in ft.attributes:
        if a.is_geom:
            if a.name + "__wkt" in batch.columns:
                out[a.name] = batch.columns[a.name + "__wkt"].tolist()
            elif a.name + "__x" in batch.columns:
                xs = batch.columns[a.name + "__x"]
                ys = batch.columns[a.name + "__y"]
                out[a.name] = list(zip(xs.tolist(), ys.tolist()))
        elif a.name not in batch.columns:
            continue
        elif a.type == "date":
            out[a.name] = batch.columns[a.name].astype("datetime64[ms]")
        elif a.type == "string":
            out[a.name] = dicts[a.name].decode(batch.columns[a.name])
        else:
            out[a.name] = batch.columns[a.name]
    return out
