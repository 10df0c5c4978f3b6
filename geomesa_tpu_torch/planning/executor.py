"""Query executor: run a QueryPlan against the store's device columns.

Port of the device path of ``geomesa_tpu/planning/executor.py``: resolve the
z3 scan windows, choose the window-compacted [C, B] layout (or the padded
[S, L] one), build the fused mask (window & compiled predicate & ~f32 band)
and aggregate: ``count`` as a masked sum, ``density`` through the grouped
CUDA kernel, else a scatter. Rows in the f32 uncertainty band are corrected
exactly on the host from the f64 master columns.

Unlike the reference, nothing here catches a device failure and answers
from the host: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from geomesa_tpu_torch.index.store import FeatureStore
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
        #: gathered compact slabs by (windows, B, C, store version, column)
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

    # -- scan setup ---------------------------------------------------------
    def _scan_setup(self, plan: QueryPlan, extra_cols=()):
        table = self.store.table
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
        plan.__dict__["scanned_rows"] = int(np.maximum(ends - starts, 0).sum())
        return {
            "table": table, "starts": starts, "ends": ends,
            "counts": np.diff(table.shard_bounds).astype(np.int32),
            "L": table.shard_len, "needed": needed, "cache": c,
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
        device columns, cached per (windows, store version) in a bounded
        cache, as the reference caches its slab gathers."""
        d = setup["compact"]
        key0 = (d["whash"], d["B"], d["C"], self.store.version)
        out, missing = {}, []
        for n in names:
            hit = self._gathered.get(key0 + (n,))
            (out.__setitem__(n, hit) if hit is not None else missing.append(n))
        if missing:
            full = setup["table"].device_columns(missing)
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
            if "padded_win" not in c:
                c["padded_win"] = tuple(
                    self._tensor(setup[k]) for k in ("starts", "ends", "counts")
                )
            m = window_mask(*c["padded_win"], setup["L"])
        compiled = plan.compiled
        m = m & compiled(cols, torch)
        if compiled.band is not None:
            # f32-uncertain rows are excised here and added back exactly
            # from their f64 values by the band correction
            m = m & ~compiled.band(cols, torch)
        return cols, m

    def _scan(self, plan: QueryPlan, agg_cols=()):
        """Setup + layout + fused mask; None for an empty scan."""
        plan.__dict__["exec_path"] = {}
        setup = self._scan_setup(plan, agg_cols)
        if setup is None:
            return None
        info = self._band_info(plan, setup)
        self._maybe_compact(plan, setup)
        cols, m = self._fused(plan, setup, agg_cols)
        d = setup["compact"]
        self._note(plan, scan="device-compact" if d is not None else "device-padded",
                   band_rows=0 if info is None else len(info))
        if d is not None:
            self._note(plan, B=d["B"])
        return setup, cols, m, info

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
            s_of = np.clip(
                np.searchsorted(table.shard_bounds, idx, side="right") - 1,
                0, table.n_shards - 1,
            )
            local = (idx - table.shard_bounds[s_of])[:, None]
            starts, ends = setup["starts"], setup["ends"]
            idx = idx[((starts[s_of] <= local) & (local < ends[s_of])).any(axis=1)]
        if len(idx):
            keep = np.asarray(compiled.refine({n: v[idx] for n, v in full.items()}, np))
            if keep.ndim == 0:
                keep = np.full(len(idx), bool(keep))
            idx = idx[keep.reshape(-1).astype(bool)]
        c["band"] = idx.astype(np.int64)
        return c["band"]

    def _band_correction(self, setup, info, agg_host, agg_cols):
        """Exact host contribution of the surviving band rows, shaped for
        adding to the device result."""
        if info is None or len(info) == 0:
            return None
        table = setup["table"]
        master_rows = table.order[info]
        rows = {}
        for n in dict.fromkeys(setup["needed"] + list(agg_cols)):
            kc = table.key_columns.get(n)
            rows[n] = kc[info] if kc is not None else table._master[n][master_rows]
        return agg_host(rows, np.ones(len(info), bool))

    # -- public operations ----------------------------------------------------
    def count(self, plan: QueryPlan) -> int:
        s = self._scan(plan)
        if s is None:
            return 0
        setup, _, m, info = s
        n = int(m.sum())
        corr = self._band_correction(setup, info, lambda rows, mask: mask.sum(), ())
        return n if corr is None else n + int(corr)

    def _grouped_schedule(self, plan: QueryPlan, setup, bbox, width, height):
        """The grouped kernel's schedule (tensors on the device), cached per
        (plan, grid); None when the scan is not compacted or the pairs
        exceed the duplication budget."""
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

    def _density_operands(self, plan, s, bbox, width, height, weight):
        setup, cols, m, _ = s
        sched = self._grouped_schedule(plan, setup, bbox, width, height)
        if sched is None:
            return None
        geom = self.store.ft.geom_field
        return {"x": cols[geom + "__x"], "y": cols[geom + "__y"], "mask": m,
                "weight": None if weight is None else cols[weight].to(torch.float32),
                "sched": sched}

    def density_inputs(self, plan: QueryPlan, bbox, width: int, height: int,
                       weight: Optional[str] = None):
        """The grouped kernel's operands for this query (compact x, y, the
        fused mask, the weight column or None, and the schedule), or None
        when the query takes the scatter rung."""
        s = self._scan(plan, self._density_cols(weight))
        return None if s is None else self._density_operands(
            plan, s, bbox, width, height, weight)

    def _density_cols(self, weight):
        geom = self.store.ft.geom_field
        return [geom + "__x", geom + "__y"] + ([weight] if weight else [])

    def density(self, plan: QueryPlan, bbox, width: int, height: int,
                weight: Optional[str] = None) -> np.ndarray:
        """(height, width) f32 density grid. Compacted scans with a pair
        schedule run the grouped CUDA kernel; others the scatter (the
        reference's XLA rungs)."""
        xc, yc = self._density_cols(None)
        agg_cols = self._density_cols(weight)
        s = self._scan(plan, agg_cols)
        if s is None:
            return np.zeros((height, width), np.float32)
        setup, cols, m, info = s
        ops = self._density_operands(plan, s, bbox, width, height, weight)
        if ops is not None:
            self._note(plan, density_kernel="grouped")
            grid = kgrouped.density_grouped(
                ops["x"], ops["y"], ops["mask"], ops["weight"], bbox, width,
                height, ops["sched"],
            )
        else:
            self._note(plan, density_kernel="scatter")
            grid = kdensity.density_grid(
                cols[xc], cols[yc], m, bbox, width, height,
                cols[weight] if weight else None,
            )
        out = grid.cpu().numpy()
        corr = self._band_correction(
            setup, info,
            lambda rows, mask: kdensity.density_grid_np(
                rows[xc], rows[yc], mask, bbox, width, height,
                rows[weight] if weight else None,
            ),
            agg_cols,
        )
        return out if corr is None else out + corr
