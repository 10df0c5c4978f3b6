"""Join processes over a GeoDataset: the attribute equi-join and the
point-in-polygon spatial join.

Port of the join half of ``geomesa_tpu/processes.py`` (the reference's
JoinProcess and its ``st_contains`` join, BASELINE config #4). The other
processes (``point2point``, ``proximity``, ``route_search``,
``track_label``, ``tube_select``, sampling) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.kernels import join as kjoin
from geomesa_tpu_torch.schema.columns import ColumnBatch
from geomesa_tpu_torch.utils import geometry as geo


def join(ds, left: str, right: str, left_attr: str, right_attr: str,
         left_query="INCLUDE", right_query="INCLUDE") -> ColumnBatch:
    """Attribute equi-join of two schemas (JoinProcess analog). Right columns
    are prefixed ``right.``; string joins resolve through both dictionaries."""
    lfc = ds.query(left, left_query)
    rfc = ds.query(right, right_query)
    if lfc.batch.n == 0 or rfc.batch.n == 0:
        return ColumnBatch({}, 0)
    lcol = lfc.batch.columns[left_attr]
    rcol = rfc.batch.columns[right_attr]
    ld, rd = lfc.dicts.get(left_attr), rfc.dicts.get(right_attr)
    if ld is not None or rd is not None:
        if ld is None or rd is None:
            raise ValueError("join attribute types differ (string vs non-string)")
        lcol = np.array(ld.decode(lcol), dtype=object)
        rcol = np.array(rd.decode(rcol), dtype=object)
    rmap: Dict[object, List[int]] = {}
    for j, v in enumerate(rcol):
        rmap.setdefault(v, []).append(j)
    li, rj = [], []
    for i, v in enumerate(lcol):
        for j in rmap.get(v, ()):
            li.append(i)
            rj.append(j)
    li = np.asarray(li, np.int64)
    rj = np.asarray(rj, np.int64)
    cols = {k: v[li] for k, v in lfc.batch.columns.items()}
    for k, v in rfc.batch.columns.items():
        cols["right." + k] = v[rj]
    return ColumnBatch(cols, len(li))


def spatial_join(ds, points: str, polygons: "Sequence[str] | Sequence[geo.Geometry]",
                 query="INCLUDE", weight: Optional[str] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Point-in-polygon join: assign each matching point its first
    containing polygon and count points (or sum ``weight``) per polygon.

    ``polygons``: WKT strings or parsed geometries. Returns (assign int32
    [n] — polygon index or -1, per table row in the plan's index order —
    and counts float32 [P]). The scan runs the ``pip_assign`` kernel over
    the padded [S, L] layout on the device (or its plain version on the
    CPU); a plan that takes a host path assigns its exact matches on the
    host, as the reference does."""
    from geomesa_tpu_torch.planning.partitioned_exec import PartitionedExecutor

    ds._store(points).flush()
    if isinstance(ds._executor(points), PartitionedExecutor):
        raise NotImplementedError(
            "spatial_join on a time-partitioned store is not supported yet; "
            "query the window of interest into a plain store first"
        )
    geoms = [geo.parse_wkt(p) if isinstance(p, str) else p for p in polygons]
    edges = geo.polygon_edge_buffers(
        geo.MultiPolygon(
            tuple(
                poly
                for gm in geoms
                for poly in (gm.polygons if isinstance(gm, geo.MultiPolygon) else (gm,))
            )
        )
    )
    # poly ids above refer to flattened polygons; remap to input indices
    flat_to_input = []
    for i, gm in enumerate(geoms):
        k = len(gm.polygons) if isinstance(gm, geo.MultiPolygon) else 1
        flat_to_input += [i] * k
    remap = np.asarray(flat_to_input, np.int32)

    plan = ds._fresh_plan(points, query)
    st = ds._store(points)
    g = st.ft.geom_field
    xc, yc = g + "__x", g + "__y"
    agg_cols = [xc, yc] + ([weight] if weight else [])
    edges_f32 = {
        k: (v.astype(np.float32) if k in ("x1", "y1", "x2", "y2") else v)
        for k, v in edges.items()
    }
    on_device = kjoin.edge_tensors(edges_f32, ds.device)

    def agg(cols, m, xp, edges):
        return kjoin.pip_assign(cols[xc], cols[yc], m, edges, xp)

    ex = ds._executor(points)
    # the assignment is addressed in the padded [S*L] layout. The scan
    # callable is keyed as the reference's kernel, whose key leaves the
    # edges' y out; the edges are call operands, so a polygon set that
    # shares the key never reads another's edges
    sig = hash((edges["x1"].tobytes(), edges["poly_id"].tobytes()))
    out = ex.padded_rows(plan, agg_cols, agg, -1, np.int32, cache_key=("pip_join", sig),
                         args=(edges_f32,), device_args=(on_device,))
    if out is None:
        return np.zeros(0, np.int32), np.zeros(len(geoms), np.float32)
    assign_flat = np.asarray(out)
    assign_input = np.where(assign_flat >= 0, remap[np.clip(assign_flat, 0, None)], -1)

    table = st.tables[plan.index_name]
    L = table.shard_len
    # compress the padded [S*L] assignment down to real rows
    valid = np.zeros(table.n_shards * L, dtype=bool)
    for s in range(table.n_shards):
        sl = table.shard_slice(s)
        valid[s * L : s * L + (sl.stop - sl.start)] = True
    assign_rows = assign_input[valid]
    counts = np.zeros(len(geoms), np.float32)
    if weight:
        w = table.col_sorted(weight).astype(np.float32)
    else:
        w = np.ones(table.n, np.float32)
    hit = assign_rows >= 0
    np.add.at(counts, assign_rows[hit], w[hit])
    return assign_rows, counts
