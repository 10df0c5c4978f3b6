"""Query executor: run a QueryPlan against the chosen index table.

Port of ``geomesa_tpu/planning/executor.py``'s scan paths. Every plan
scans the table of its chosen index. Resolve the scan windows; then:

* ``device``: plans the device can answer whole (no host-only column, no
  refinement beyond the f32 band) choose the window-compacted [C, B]
  layout or the padded [S, L] one, build the fused mask (window & compiled
  predicate & ~f32 band) and aggregate there: ``count`` as a masked sum,
  ``density`` through the grouped CUDA kernel when the index has a Morton
  key (z3, z2), else a scatter. Band rows are corrected exactly on the
  host from the f64 master columns.
* ``host+device-coarse``: refine-bearing plans (Long bounds beyond 2^24,
  point and line literals, WITHIN / TOUCHES) compute the coarse mask on
  the device over the padded layout, then refine and aggregate its rows on
  the host, as the reference does.
* ``host``: plans reading a host-only column (the feature id) evaluate the
  predicate on the window rows on the host; id lookups are this path by
  the reference's design.

Unlike the reference, nothing here catches a device failure and answers
from the host: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from geomesa_tpu_torch.index.store import FeatureStore, IndexTable
from geomesa_tpu_torch.kernels import density as kdensity
from geomesa_tpu_torch.kernels import density_grouped as kgrouped
from geomesa_tpu_torch.kernels.density_mxu import ladder8
from geomesa_tpu_torch.kernels.masks import window_mask
from geomesa_tpu_torch.planning.planner import QueryPlan

#: chunk sizes (rows) the compacted layout chooses among
_B_LADDER = (128, 256, 512, 1024, 2048, 4096)

#: range budget (and per-shard window cap) of the fine cover the compacted
#: layout re-plans with (the JAX package's geomesa.compact.cover)
COMPACT_COVER = 32768

#: the grouped density schedule may pair at most this many (chunk, tile)
#: pairs per real chunk; beyond it the scan scatters (the JAX package's
#: geomesa.density.pallas.max.dup)
MAX_DUP = 4.0

#: gathered [C, B] column slabs kept per executor before the cache clears
_GATHER_CACHE = 64


class Executor:
    """Runs plans over one store. ``compact_min_rows`` /
    ``compact_fraction`` are the JAX package's ``geomesa.compact.min.rows``
    / ``geomesa.compact.fraction``."""

    def __init__(self, store: FeatureStore, compact_min_rows: int = 1 << 20,
                 compact_fraction: float = 0.5):
        self.store = store
        self.device = store.device
        self.compact_min_rows = compact_min_rows
        self.compact_fraction = compact_fraction
        #: gathered compact slabs by (table, windows, B, C, version, column)
        self._gathered: Dict[tuple, torch.Tensor] = {}

    # -- per-plan caches ----------------------------------------------------
    def _cache(self, plan: QueryPlan) -> Dict:
        """Host and device artefacts of one plan (windows, compaction
        descriptor, gathered columns, schedules) for the current store
        version."""
        c = plan.__dict__.get("_exec_cache")
        if c is None or c["version"] != self.store.version:
            c = plan.__dict__["_exec_cache"] = {"version": self.store.version}
        return c

    @staticmethod
    def _note(plan: QueryPlan, **kw) -> None:
        """Record which path served this query in ``plan.exec_path``."""
        plan.__dict__.setdefault("exec_path", {}).update(kw)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _table(self, plan: QueryPlan) -> IndexTable:
        return self.store.tables[plan.index_name]

    # -- scan setup ---------------------------------------------------------
    def _scan_setup(self, plan: QueryPlan, extra_cols=()):
        """Windows, needed columns and the path split; None for an empty
        scan. ``use_device``: the device answers whole; ``coarse_device``:
        the device computes the coarse mask a host refinement narrows."""
        table = self._table(plan)
        if table.n == 0 or plan.is_empty:
            return None
        c = self._cache(plan)
        if "windows" not in c:
            c["windows"] = table.windows(plan.key_plan)
        starts, ends = c["windows"]
        needed = list(dict.fromkeys(list(plan.compiled.columns) + list(extra_cols)))
        for name in needed:
            if not table.has_column(name):
                raise KeyError(f"column {name!r} not in schema {plan.schema!r}")
        host_only = any(table.is_host_only(n) for n in needed)
        compiled = plan.compiled
        plan.__dict__["scanned_rows"] = int(np.maximum(ends - starts, 0).sum())
        return {
            "table": table, "starts": starts, "ends": ends,
            "counts": np.diff(table.shard_bounds).astype(np.int32),
            "L": table.shard_len, "needed": needed, "cache": c,
            "use_device": not host_only and (compiled.refine is None
                                             or compiled.refine_only_if_band),
            "coarse_device": not host_only and compiled.refine is not None,
        }

    def _fine_windows(self, plan: QueryPlan, setup):
        """Windows re-resolved from a re-covered key plan under the much
        larger :data:`COMPACT_COVER` range budget (and window cap): the
        compacted layout costs per admitted row and the density schedule
        wants spatially tight chunks."""
        c = setup["cache"]
        if "fine" not in c:
            table = setup["table"]
            kp = table.keyspace.plan(self.store.ft, plan.filter, COMPACT_COVER)
            c["fine"] = (None, None) if kp is None else table.windows(
                kp, cap=COMPACT_COVER
            )
        return c["fine"]

    def _compact_candidates(self, plan: QueryPlan, setup):
        """(starts, ends, B, lens) of the window set and chunk size with the
        fewest padded rows (the fine set wins near-ties), or None."""
        L = setup["L"]
        ladder = [b for b in _B_LADDER if b <= L]

        def choose(starts, ends):
            lens = np.maximum(ends - starts, 0).astype(np.int64)
            if int(lens.sum()) == 0 or not ladder:
                return None
            flat = lens.reshape(-1)
            rows_at = {Bc: int((-(-flat // Bc)).sum()) * Bc for Bc in ladder}
            floor_rows = min(rows_at.values())
            B = max(b for b, r in rows_at.items() if r <= 1.10 * floor_rows)
            return B, rows_at[B], lens

        cands = []
        coarse = choose(setup["starts"], setup["ends"])
        if coarse is not None:
            cands.append((coarse[1], 1, setup["starts"], setup["ends"],
                          coarse[0], coarse[2]))
        fs, fe = self._fine_windows(plan, setup)
        if fs is not None:
            fine = choose(fs, fe)
            if fine is not None:
                cands.append((int(fine[1] * 0.77), 0, fs, fe, fine[0], fine[2]))
        if not cands:
            return None
        cands.sort(key=lambda t: (t[0], t[1]))
        _, _, starts, ends, B, lens = cands[0]
        return starts, ends, B, lens

    def _maybe_compact(self, plan: QueryPlan, setup) -> None:
        """Set ``setup['compact']`` to the chunk descriptor of the compacted
        layout, or None (padded layout). Chunks are B-row slabs covering
        every window in global row order; ``lo`` carries the end-of-table
        clamp: chunk c's valid rows sit at [lo, lo + valid) from cstart."""
        c = setup["cache"]
        if "compact" not in c:
            c["compact"] = self._build_compact(plan, setup)
        setup["compact"] = c["compact"]

    def _build_compact(self, plan: QueryPlan, setup):
        table = setup["table"]
        if table.n < self.compact_min_rows:
            return None
        chosen = self._compact_candidates(plan, setup)
        if chosen is None:
            return None
        L = setup["L"]
        starts, ends, B, lens = chosen
        S, K = starts.shape
        flat_lens = lens.reshape(-1)
        nc = -(-flat_lens // B)
        C = int(nc.sum())
        if C * B >= table.n * self.compact_fraction:
            return None  # windows admit most of the table
        win = np.repeat(np.arange(S * K), nc)
        j = np.arange(C) - np.repeat(np.cumsum(nc) - nc, nc)
        gstart = (win // K * L + starts.reshape(-1)[win] + j * B).astype(np.int64)
        valid = np.minimum(flat_lens[win] - j * B, B).astype(np.int32)
        order = np.argsort(gstart, kind="stable")
        gstart, valid = gstart[order], valid[order]
        # slabs near the table end start earlier so they never read past it
        cstart = np.minimum(gstart, S * L - B)
        lo = (gstart - cstart).astype(np.int32)
        Cp = ladder8(C)
        if Cp != C:
            pad = Cp - C
            cstart = np.concatenate([cstart, np.zeros(pad, np.int64)])
            lo = np.concatenate([lo, np.zeros(pad, np.int32)])
            valid = np.concatenate([valid, np.zeros(pad, np.int32)])
        return {
            "B": B, "C": Cp, "cstart": cstart.astype(np.int32), "lo": lo,
            "valid": valid, "whash": hash((starts.tobytes(), ends.tobytes())),
        }

    # -- device columns and the fused mask -----------------------------------
    def _compact_cols(self, setup, names) -> Dict[str, torch.Tensor]:
        """Window rows of ``names`` as [C, B] slabs gathered from the padded
        device columns, cached per (table, windows, store version) in a
        bounded cache, as the reference caches its slab gathers."""
        d = setup["compact"]
        table = setup["table"]
        key0 = (table.keyspace.name, d["whash"], d["B"], d["C"], self.store.version)
        out, missing = {}, []
        for n in names:
            hit = self._gathered.get(key0 + (n,))
            (out.__setitem__(n, hit) if hit is not None else missing.append(n))
        if missing:
            full = table.device_columns(missing)
            cs = self._tensor(d["cstart"].astype(np.int64))
            idx = cs[:, None] + torch.arange(d["B"], device=self.device)[None, :]
            if len(self._gathered) + len(missing) > _GATHER_CACHE:
                self._gathered.clear()
            for n in missing:
                out[n] = self._gathered[key0 + (n,)] = full[n].reshape(-1)[idx]
        return out

    def scan_columns(self, plan: QueryPlan, names) -> Dict[str, torch.Tensor]:
        """The device columns a scan of ``plan`` reads: compact [C, B] slabs
        when the plan compacts, else the padded [S, L] columns."""
        setup = self._scan_setup(plan, names)
        if setup is None:
            return {}
        self._maybe_compact(plan, setup)
        if setup["compact"] is not None:
            return self._compact_cols(setup, list(names))
        return setup["table"].device_columns(names)

    def _padded_window_mask(self, setup) -> torch.Tensor:
        c = setup["cache"]
        if "padded_win" not in c:
            c["padded_win"] = tuple(
                self._tensor(setup[k]) for k in ("starts", "ends", "counts")
            )
        return window_mask(*c["padded_win"], setup["L"])

    def _fused(self, plan: QueryPlan, setup, agg_cols):
        """(columns, mask): window & compiled predicate & ~band."""
        names = list(dict.fromkeys(setup["needed"] + list(agg_cols)))
        c = setup["cache"]
        d = setup["compact"]
        if d is not None:
            cols = self._compact_cols(setup, names)
            if "compact_win" not in c:
                c["compact_win"] = (self._tensor(d["lo"]), self._tensor(d["valid"]))
            lo, valid = c["compact_win"]
            iota = torch.arange(d["B"], dtype=torch.int32, device=self.device)[None, :]
            m = (iota >= lo[:, None]) & (iota < (lo + valid)[:, None])
        else:
            cols = setup["table"].device_columns(names)
            m = self._padded_window_mask(setup)
        compiled = plan.compiled
        m = m & compiled(cols, torch)
        if compiled.band is not None:
            # f32-uncertain rows are excised here and added back exactly
            # from their f64 values by the band correction
            m = m & ~compiled.band(cols, torch)
        return cols, m

    # -- the f32 band --------------------------------------------------------
    def _band_info(self, plan: QueryPlan, setup) -> Optional[np.ndarray]:
        """Sorted-order positions of the band rows inside the scan windows
        that the exact f64 predicate keeps (usually empty), cached per plan.
        The device counts ``mask & ~band``; these rows are added back."""
        compiled = plan.compiled
        if compiled.band is None:
            return None
        c = setup["cache"]
        if "band" in c:
            return c["band"]
        table = setup["table"]
        full = {n: table.col_sorted(n) for n in compiled.columns}
        idx = np.nonzero(np.asarray(compiled.band(full, np)).reshape(-1))[0]
        if len(idx):
            idx = idx[self._in_windows(setup, idx)]
        if len(idx):
            keep = np.asarray(compiled.refine({n: v[idx] for n, v in full.items()}, np))
            if keep.ndim == 0:
                keep = np.full(len(idx), bool(keep))
            idx = idx[keep.reshape(-1).astype(bool)]
        c["band"] = idx.astype(np.int64)
        return c["band"]

    @staticmethod
    def _in_windows(setup, pos: np.ndarray) -> np.ndarray:
        """Which sorted-order positions lie inside the scan windows."""
        table = setup["table"]
        s_of = np.clip(np.searchsorted(table.shard_bounds, pos, side="right") - 1,
                       0, table.n_shards - 1)
        local = (pos - table.shard_bounds[s_of])[:, None]
        starts, ends = setup["starts"], setup["ends"]
        return ((starts[s_of] <= local) & (local < ends[s_of])).any(axis=1)

    # -- the host paths ------------------------------------------------------
    def _device_coarse_mask(self, plan: QueryPlan, setup) -> np.ndarray:
        """Window mask & coarse predicate on the device over the padded
        [S, L] layout; the sorted-order positions it keeps, on the host."""
        cols = setup["table"].device_columns(setup["needed"])
        m = (self._padded_window_mask(setup) & plan.compiled(cols, torch)).cpu().numpy()
        return self._positions(setup, np.flatnonzero(m))

    @staticmethod
    def _positions(setup, flat: np.ndarray) -> np.ndarray:
        """Flat [S, L] indices -> sorted-order row positions."""
        s = flat // setup["L"]
        return setup["table"].shard_bounds[s] + flat % setup["L"]

    def _window_positions(self, setup) -> np.ndarray:
        """Sorted-order positions of every scan-window row, once each (id
        windows are not merged and may repeat)."""
        table = setup["table"]
        counts = setup["counts"][:, None]
        starts = np.minimum(setup["starts"], counts).astype(np.int64)
        ends = np.minimum(setup["ends"], counts).astype(np.int64)
        lens = np.maximum(ends - starts, 0).reshape(-1)
        base = (table.shard_bounds[:-1, None] + starts).reshape(-1)
        n = int(lens.sum())
        first = np.repeat(base, lens)
        return np.unique(first + np.arange(n) - np.repeat(np.cumsum(lens) - lens, lens))

    def _host_positions(self, plan: QueryPlan, setup) -> np.ndarray:
        """The exact matches' sorted-order positions on the host: the
        device's coarse rows, or the window rows under the predicate, then
        the exact refinement on the rows kept."""
        compiled = plan.compiled
        table = setup["table"]
        if setup["coarse_device"]:
            pos = self._device_coarse_mask(plan, setup)
        else:
            pos = self._window_positions(setup)
            if len(pos):
                m = np.asarray(compiled(table.rows(setup["needed"], pos), np))
                pos = pos if m.ndim == 0 and bool(m) else pos[np.broadcast_to(m, pos.shape)]
        if compiled.refine is not None and len(pos):
            names = list(dict.fromkeys(compiled.columns + compiled.refine_columns))
            pos = pos[compiled.refine_rows(table.rows(names, pos), len(pos))]
        return pos

    # -- the scan ---------------------------------------------------------------
    def _run(self, plan: QueryPlan, agg_cols, device_agg: Callable,
             host_agg: Callable):
        """One scan of ``plan``: ``device_agg(setup, cols, mask)`` on the
        device path plus ``host_agg(rows)`` of the band rows, or
        ``host_agg(rows)`` of the exact matches on a host path. None for an
        empty scan."""
        plan.__dict__["exec_path"] = {}
        setup = self._scan_setup(plan, agg_cols)
        if setup is None:
            return None
        table = setup["table"]
        if not setup["use_device"]:
            pos = self._host_positions(plan, setup)
            self._note(plan, scan="host+device-coarse" if setup["coarse_device"]
                       else "host", band_rows=0)
            return host_agg(table.rows(agg_cols, pos), len(pos))
        info = self._band_info(plan, setup)
        self._maybe_compact(plan, setup)
        cols, m = self._fused(plan, setup, agg_cols)
        d = setup["compact"]
        self._note(plan, scan="device-compact" if d is not None else "device-padded",
                   band_rows=0 if info is None else len(info))
        if d is not None:
            self._note(plan, B=d["B"])
        out = device_agg(setup, cols, m)
        if info is None or len(info) == 0:
            return out
        return out + host_agg(table.rows(agg_cols, info), len(info))

    # -- public operations ----------------------------------------------------
    def count(self, plan: QueryPlan) -> int:
        out = self._run(plan, (), lambda setup, cols, m: int(m.sum()),
                        lambda rows, n: n)
        return 0 if out is None else int(out)

    def _grouped_schedule(self, plan: QueryPlan, setup, bbox, width, height):
        """The grouped kernel's schedule (tensors on the device), cached per
        (plan, grid); None when the scan is not compacted, the index has no
        Morton key, or the pairs exceed the duplication budget."""
        d = setup["compact"]
        if d is None:
            return None
        c = setup["cache"]
        key = ("grouped", tuple(float(v) for v in bbox), width, height)
        hit = c.get(key)
        if hit is None:
            table = setup["table"]
            gr = kgrouped.build_grouped(
                d, table, table.keyspace, bbox, width, height, MAX_DUP,
                box_cache=c.setdefault("boxes", {}),
            )
            hit = False
            if gr is not None:
                seg = kgrouped.tile_segments(gr)
                hit = {k: self._tensor(v) if isinstance(v, np.ndarray) else v
                       for k, v in seg.items()}
            c[key] = hit
        return hit or None

    def _density_cols(self, weight):
        geom = self.store.ft.geom_field
        return [geom + "__x", geom + "__y"] + ([weight] if weight else [])

    def density_inputs(self, plan: QueryPlan, bbox, width: int, height: int,
                       weight: Optional[str] = None):
        """The grouped kernel's operands for this query (compact x, y, the
        fused mask, the weight column or None, and the schedule), or None
        when the query takes another rung."""
        agg_cols = self._density_cols(weight)
        setup = self._scan_setup(plan, agg_cols)
        if setup is None or not setup["use_device"]:
            return None
        self._maybe_compact(plan, setup)
        cols, m = self._fused(plan, setup, agg_cols)
        sched = self._grouped_schedule(plan, setup, bbox, width, height)
        if sched is None:
            return None
        xc, yc = agg_cols[:2]
        return {"x": cols[xc], "y": cols[yc], "mask": m,
                "weight": None if weight is None else cols[weight].to(torch.float32),
                "sched": sched}

    def density(self, plan: QueryPlan, bbox, width: int, height: int,
                weight: Optional[str] = None) -> np.ndarray:
        """(height, width) f32 density grid. Compacted scans of a Morton
        index with a pair schedule run the grouped CUDA kernel; other
        device scans the scatter (the reference's XLA rungs); host paths
        grid their exact rows on the host."""
        agg_cols = self._density_cols(weight)
        xc, yc = agg_cols[:2]

        def device_agg(setup, cols, m):
            sched = self._grouped_schedule(plan, setup, bbox, width, height)
            if sched is not None:
                self._note(plan, density_kernel="grouped")
                grid = kgrouped.density_grouped(
                    cols[xc], cols[yc], m,
                    None if weight is None else cols[weight].to(torch.float32),
                    bbox, width, height, sched,
                )
            else:
                self._note(plan, density_kernel="scatter")
                grid = kdensity.density_grid(cols[xc], cols[yc], m, bbox, width,
                                             height, cols[weight] if weight else None)
            return grid.cpu().numpy()

        def host_agg(rows, n):
            return kdensity.density_grid_np(
                rows[xc], rows[yc], np.ones(n, bool), bbox, width, height,
                rows[weight] if weight else None,
            )

        out = self._run(plan, agg_cols, device_agg, host_agg)
        return np.zeros((height, width), np.float32) if out is None else out
