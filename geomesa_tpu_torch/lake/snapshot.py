"""Partition spill snapshots on the lake container.

Copy of ``geomesa_tpu/lake/snapshot.py``. One ``part.lake`` file per
spilled partition holds:

* the master columns (``c/`` prefix) and cached index key columns (``k/``),
  re-ordered to the primary index's sort order (z2, else z3) and cut into
  row groups of ``geomesa.lake.rowgroup.rows``, so each group covers a
  contiguous stretch of the curve;
* per row group: the point bbox, the time range and the primary key's
  range, which a reader tests before any payload byte loads;
* the reference's visibility-code column (all rows public here);
* every index table's sort permutation and sorted key columns. The
  primary's permutation is the identity after the re-order and its key
  columns are chunked with the row groups, so a pruned subset of groups
  is still sorted and a partial load re-sorts nothing.

Each table's ``order`` is remapped through the inverse permutation, so
every sorted gather gives the same columns as before the spill.
``meta.json`` (row count, key shifts, the sketches as JSON) is written
beside it. The file and ``meta.json`` are byte-equal to the JAX package's
for the same child.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch import config, metrics
from geomesa_tpu_torch.lake.format import LakeCorruptError, LakeFile, LakeWriter

SNAPSHOT_FILE = "part.lake"

#: the JAX package's row-visibility codes. The port stores no visibilities:
#: it writes every row as public (code 0), so its files are the
#: reference's byte for byte and the JAX package reads them as its own; a
#: reloaded partition carries the column, as the reference's does.
VIS_MEMBER = "c/__vis__"

#: preferred row orders: a pure-spatial sort gives every row group a tight
#: bbox (inside a time partition the bin already bounds time)
_PRIMARY_PREFERENCE = ("z2", "z3")


def _primary_table(st) -> Optional[str]:
    for name in _PRIMARY_PREFERENCE:
        t = st.tables.get(name)
        if t is not None and t.n:
            return name
    return None


def _rowgroup_rows() -> int:
    r = config.LAKE_ROWGROUP_ROWS.to_int()
    return max(int(r) if r else 16384, 256)


def _group_stats(ft, cols: Dict[str, np.ndarray], lo: int, hi: int,
                 primary_key: Optional[np.ndarray]) -> Dict[str, Any]:
    """Footer statistics of rows [lo, hi) of the re-ordered master."""
    out: Dict[str, Any] = {"rows": hi - lo}
    g = ft.geom_field
    if g is not None:
        gx, gy = cols.get(g + "__x"), cols.get(g + "__y")
        if gx is not None and gy is not None:
            sx, sy = gx[lo:hi], gy[lo:hi]
            if len(sx):
                out["bbox"] = [float(np.min(sx)), float(np.min(sy)),
                               float(np.max(sx)), float(np.max(sy))]
    d = ft.dtg_field
    if d is not None:
        dc = cols.get(d)
        if dc is not None and dc.dtype.kind in "iuM" and hi > lo:
            dv = dc[lo:hi].astype(np.int64, copy=False) \
                if dc.dtype.kind != "M" else dc[lo:hi].view(np.int64)
            out["time"] = [int(dv.min()), int(dv.max())]
    if primary_key is not None and hi > lo:
        # the primary key column is sorted: its first and last entries
        out["sfc"] = [int(primary_key[lo]), int(primary_key[hi - 1])]
    return out


def write_snapshot(st, ft, d: str) -> None:
    """Write partition store ``st``'s snapshot into directory ``d``
    (``part.lake`` + ``meta.json``); the caller renames it into place."""
    os.makedirs(d, exist_ok=True)
    n = st._all.n if st._all is not None else 0
    master: Dict[str, np.ndarray] = {}
    if st._all is not None:
        for k, v in st._all.columns.items():
            master["c/" + k] = v.astype("U") if v.dtype.kind == "O" else v
        # the reference's visibility codes: every row public (code 0)
        master.setdefault(VIS_MEMBER, np.zeros(n, np.int32))
    for k, v in st._key_cols.items():
        master["k/" + k] = v

    primary = _primary_table(st)
    inv = None
    if primary is not None and n:
        if st.tables[primary].n != n:
            primary = None  # inconsistent table: no canonical re-order
        else:
            perm = np.asarray(st.tables[primary].order, np.int64)
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n, dtype=np.int64)
            master = {k: np.asarray(v)[perm] for k, v in master.items()}

    pt = st.tables.get(primary) if primary is not None else None
    primary_key = None
    if pt is not None and pt.key_columns:
        # the first key column is the table's major sort key
        primary_key = next(iter(pt.key_columns.values()))

    rows = _rowgroup_rows()
    if n:
        bounds = list(range(0, n, rows)) + [n]
        cut_pairs = list(zip(bounds[:-1], bounds[1:]))
    else:
        # one empty group keeps every column's dtype across a reload
        cut_pairs = [(0, 0)] if master else []
    w = LakeWriter(os.path.join(d, SNAPSHOT_FILE))
    try:
        groups: List[Dict[str, Any]] = []
        plain = {k[2:]: v for k, v in master.items() if k.startswith("c/")}
        for lo, hi in cut_pairs:
            cols = {k: w.add_array(v[lo:hi]) for k, v in master.items()}
            groups.append({"cols": cols,
                           "stats": _group_stats(ft, plain, lo, hi, primary_key)})
        shifts: Dict[str, Dict[str, int]] = {}
        tables: Dict[str, Dict[str, Any]] = {}
        for name, t in st.tables.items():
            if not t.n and n:
                continue  # the snapshot predates this index: rebuilt on load
            order = np.asarray(t.order, np.int64)
            if inv is not None:
                order = inv[order]
            ent: Dict[str, Any] = {"n": int(t.n)}
            if name == primary:
                ent["order"] = None  # identity by construction
                ent["keys"] = {k: [w.add_array(v[lo:hi]) for lo, hi in cut_pairs]
                               for k, v in t.key_columns.items()}
            else:
                ent["order"] = w.add_array(order)
                ent["keys"] = {k: w.add_array(v) for k, v in t.key_columns.items()}
            if t._rank_vocab is not None:
                ent["vocab"] = w.add_array(t._rank_vocab.astype("U"))
            if t.key_shifts is not None:
                shifts[name] = dict(t.key_shifts)
            tables[name] = ent
        meta = {"n": n, "shifts": shifts,
                "stats": {k: v.to_json() for k, v in st.stats.items()}}
        w.finish({"kind": "partition", "n": n, "primary": primary,
                  "columns": sorted(master), "groups": groups,
                  "tables": tables, "meta": meta})
    except BaseException:
        w.abort()
        raise
    with open(os.path.join(d, "meta.json"), "w") as fh:
        json.dump(meta, fh)


class PartitionSnapshot:
    """Reader over one partition's ``part.lake``: the footer on open,
    column payloads per row group on demand, and pruning over the footer
    statistics."""

    def __init__(self, d: str):
        self.dir = d
        self.file = LakeFile(os.path.join(d, SNAPSHOT_FILE))
        f = self.file.footer
        if f.get("kind") != "partition":
            self.file.close()
            raise LakeCorruptError(f"{d}: not a partition snapshot")
        self.n: int = int(f["n"])
        self.primary: Optional[str] = f.get("primary")
        self.columns: List[str] = list(f.get("columns", []))
        self.groups: List[Dict[str, Any]] = f.get("groups", [])
        self.tables: Dict[str, Dict[str, Any]] = f.get("tables", {})
        self.meta: Dict[str, Any] = f["meta"]

    # -- statistics pruning ------------------------------------------------------
    def group_rows(self, groups: Optional[Sequence[int]] = None) -> int:
        idx = range(len(self.groups)) if groups is None else groups
        return int(sum(self.groups[i]["stats"]["rows"] for i in idx))

    def payload_bytes(self, groups: Optional[Sequence[int]] = None) -> int:
        """Encoded payload bytes of the listed groups (all when None)."""
        idx = range(len(self.groups)) if groups is None else groups
        return sum(self.file.blob_nbytes(ref)
                   for i in idx for ref in self.groups[i]["cols"].values())

    def prune(self, boxes: Optional[List[Tuple[float, float, float, float]]],
              times: Optional[List[Tuple[float, float]]],
              margin: Optional[float] = None) -> List[int]:
        """Row groups that may hold matching rows. ``boxes`` / ``times``
        are the query's spatial and temporal bounds (None: that axis is
        unconstrained; an empty list: provably disjoint). A group's bbox
        grows by ``margin`` degrees (``geomesa.lake.prune.margin``) so the
        scan's f32 edge arithmetic never matches a row of a pruned group."""
        if margin is None:
            m = config.LAKE_PRUNE_MARGIN.to_float()
            margin = 1e-3 if m is None else float(m)
        out: List[int] = []
        for i, g in enumerate(self.groups):
            s = g["stats"]
            keep = True
            if boxes is not None:
                bb = s.get("bbox")
                if bb is None:
                    keep = bool(boxes)  # no statistics: only disjoint prunes
                else:
                    x0, y0, x1, y1 = (bb[0] - margin, bb[1] - margin,
                                      bb[2] + margin, bb[3] + margin)
                    keep = any(q[0] <= x1 and q[2] >= x0 and q[1] <= y1 and q[3] >= y0
                               for q in boxes)
            if keep and times is not None:
                tt = s.get("time")
                if tt is None:
                    keep = bool(times)
                else:
                    keep = any(q[0] <= tt[1] and q[1] >= tt[0] for q in times)
            if keep:
                out.append(i)
        return out

    def account(self, loaded: Sequence[int]) -> Dict[str, int]:
        """Groups and bytes of a pruned load against the whole file, also
        added to the process's ``lake.*`` counters."""
        total = len(self.groups)
        read_b = self.payload_bytes(loaded)
        all_b = self.payload_bytes(None)
        metrics.inc(metrics.LAKE_ROWGROUPS_LOADED, len(loaded))
        metrics.inc(metrics.LAKE_ROWGROUPS_PRUNED, total - len(loaded))
        metrics.inc(metrics.LAKE_BYTES_SKIPPED, all_b - read_b)
        return {
            "groups_total": total,
            "groups_loaded": len(loaded),
            "groups_pruned": total - len(loaded),
            "bytes_payload": all_b,
            "bytes_loaded": read_b,
            "bytes_skipped": all_b - read_b,
        }

    # -- column decode -------------------------------------------------------------
    def _chunks(self, refs, name: str, idx: List[int], cache) -> List[np.ndarray]:
        return [cache.fetch(self.dir, name, i, refs(i), self.file)
                if cache is not None else self.file.read_array(refs(i))
                for i in idx]

    def read_column(self, name: str, groups: Optional[Sequence[int]] = None,
                    cache=None) -> np.ndarray:
        """Decode one prefixed column (``c/attr``, ``k/__z3``) over the
        listed row groups (all when None), concatenated in group order.
        ``cache``: a :class:`~geomesa_tpu_torch.lake.residency.
        GroupResidencyCache` that serves and keeps per-group chunks."""
        idx = list(range(len(self.groups))) if groups is None else list(groups)

        def ref(i):
            r = self.groups[i]["cols"].get(name)
            if r is None:
                raise KeyError(name)
            return r

        parts = self._chunks(ref, name, idx, cache)
        if not parts:
            # zero groups: an empty array (the dtype cannot be recovered)
            return np.zeros(0, np.float64 if name.startswith("c/") else np.int64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def table_order(self, name: str) -> Optional[np.ndarray]:
        ent = self.tables[name]
        if ent.get("order") is None:
            return None  # identity (the primary)
        return self.file.read_array(ent["order"])

    def table_keys(self, name: str, groups: Optional[Sequence[int]] = None,
                   cache=None) -> Dict[str, np.ndarray]:
        ent = self.tables[name]
        out: Dict[str, np.ndarray] = {}
        for k, refs in ent.get("keys", {}).items():
            if isinstance(refs, list):  # the primary: per-group chunks
                idx = list(range(len(self.groups))) if groups is None else list(groups)
                parts = self._chunks(refs.__getitem__, f"tk/{name}/{k}", idx, cache)
                out[k] = (parts[0] if len(parts) == 1 else np.concatenate(parts)) \
                    if parts else np.zeros(0, np.int64)
            else:
                out[k] = self.file.read_array(refs)
        return out

    def table_vocab(self, name: str) -> Optional[np.ndarray]:
        v = self.tables[name].get("vocab")
        return None if v is None else self.file.read_array(v)
