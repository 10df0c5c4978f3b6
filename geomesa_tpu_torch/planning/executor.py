"""Query executor: run a QueryPlan against the chosen index table.

Port of ``geomesa_tpu/planning/executor.py``'s scan paths. Every plan
scans the table of its chosen index. Resolve the scan windows; then:

* ``device``: plans the device can answer whole (no host-only column, no
  refinement beyond the f32 band) choose the window-compacted [C, B]
  layout or the padded [S, L] one, build the fused mask (window & compiled
  predicate & ~f32 band) and aggregate there: ``count`` as a masked sum,
  ``density`` through the grouped CUDA kernel when the index has a Morton
  key (z3, z2) or xz codes (xz3, xz2: chunk boxes from the centroid
  columns, which the reference does not pair), else a scatter. Band rows
  are corrected exactly on the host from the f64 master columns.
* ``host+device-coarse``: refine-bearing plans (Long bounds beyond 2^24,
  point and line literals, WITHIN / TOUCHES, every exact relation of an
  extent column, expression comparisons) compute the coarse mask on the
  device over the padded layout, then refine and aggregate its rows on
  the host, as the reference does; ``exec_path`` records the refined rows
  and the refinement's milliseconds.
* ``host``: plans reading a host-only column (the feature id) evaluate the
  predicate on the window rows on the host; id lookups are this path by
  the reference's design.

Operations that cannot add the band rows' exact contribution to a device
result (features, stats, top-k, kNN, and every sampled scan) take the
host path when the band holds rows, as the reference does. Sampling (the
``sampling`` / ``sample_by`` hints) runs in the fused device mask over the
row order of the padded layout (the compacted chunks keep it), or after
the refinement on a host path. ``features`` brings the device mask back
and gathers the matching rows on the host; ``top_rows`` selects the
candidate rows of a sorted, limited query on the device (argmin order for
k <= 32, else a 48-step threshold search); ``stats`` reduces the device
sketches in the scan (``kernels/stats_scan.py``) and observes the others
on gathered rows; ``knn`` ranks f32 great-circle distances
(``kernels/knn.py``). ``density_curve`` counts (or sums a weight over)
Morton blocks by two gathers from one prefix sum over the padded layout,
and a band-bearing curve runs on the host, as the reference's. The
query-axis batches (``count_batch``, ``density_batch``, ``stats_batch``,
``density_curve_filter_batch``) serve M members of one structural
template over the padded layout, the compiled residual once and each
member's window mask, literal compares and aggregate after it.

Unlike the reference, nothing here catches a device failure and answers
from the host: a kernel that fails to build or launch raises.

The warm path (``kernels/registry.py``): each device scan runs through a
scan callable (:class:`_ScanFn`: the compiled predicate and band, the
sampling mode and the aggregate) cached in the store's
:class:`KernelRegistry` under the reference's version-stable ``fn_key`` of
the same site, so a repeated query builds nothing and records
``kernel="hit"`` where the reference records a cache hit, and a new one
``kernel="trace"`` with a ``kernel.recompile`` event; padded scans note
``shape_bucket`` (L, K), and a freshly built callable's first run notes
its kernels' routes as ``kernel:<name>``. Every launch site runs inside
``utilization.device_busy``, which feeds ``device.busy.<id>`` and the
call's ``device_ms.<id>`` cost.

Under tracing each scan opens the reference's spans: ``scan.device_put``
where device columns are gathered or fetched, ``scan.kernel`` around the
mask and aggregate launches, ``scan.host`` around a host path's predicate,
refinement and aggregate, and ``scan.sync`` at the copies back to the
host of ``count``, ``density`` and ``features``. A span closes when its
launches return; no span waits for the device.

:func:`query_deadline` scopes ``geomesa.query.timeout`` over a call;
``check_deadline`` runs at the reference's sites (each scan's start, the
host predicate and refinement passes, each query-axis batch's start), so
an expired query raises ``QueryTimeoutError`` between phases and never
inside a kernel.

A time partition's child store runs under its own executor
(``version_source`` = the partitioned parent): its per-plan caches live in
the child's device state, so they go when the partition is spilled, and
``count_partial``, ``density(as_numpy=False)`` and ``stats_partials``
return partials the partitioned executor merges.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from geomesa_tpu_torch import config, metrics, tracing, utilization
from geomesa_tpu_torch.curves.zorder import interleave2
from geomesa_tpu_torch.index.store import FeatureStore, IndexTable
from geomesa_tpu_torch.kernels import density as kdensity
from geomesa_tpu_torch.kernels import density_grouped as kgrouped
from geomesa_tpu_torch.kernels import density_mxu as kmxu
from geomesa_tpu_torch.kernels import knn as kknn
from geomesa_tpu_torch.kernels import masks as kmasks
from geomesa_tpu_torch.kernels import stats_scan as kstats
from geomesa_tpu_torch.kernels.density_mxu import ladder8
from geomesa_tpu_torch.kernels import registry as kreg
from geomesa_tpu_torch.kernels.registry import KernelRegistry, bucket_batch, dict_fingerprint
from geomesa_tpu_torch.planning.planner import QueryPlan
# QueryTimeoutError is re-exported here, as the reference's executor does
from geomesa_tpu_torch.resilience import (  # noqa: F401
    QueryTimeoutError, check_deadline, deadline_scope,
)
from geomesa_tpu_torch.schema.columns import ColumnBatch
from geomesa_tpu_torch.stats import sketches as sk

#: chunk sizes (rows) the compacted layout chooses among
_B_LADDER = (128, 256, 512, 1024, 2048, 4096)

#: gathered [C, B] column slabs kept per executor before the cache clears
_GATHER_CACHE = 64

#: the largest dictionary the exact per-key sampling counter serves; wider
#: int32 keys hash into ``geomesa.sample.hash-buckets`` groups
SAMPLE_EXACT_VOCAB = 256

#: rows per chunk of features_iter (the JAX package's
#: GEOMESA_ARROW_BATCH_ROWS default)
BATCH_ROWS = 1_000_000

#: plans whose caches a partition child's executor keeps
_PLAN_CACHES = 64


@contextlib.contextmanager
def query_deadline(timeout_s: Optional[float]):
    """Scope a wall-clock deadline of ``timeout_s`` seconds (None:
    unlimited) over a query's scan phases; see ``resilience.check_deadline``
    for where it is enforced."""
    with deadline_scope(timeout_s):
        yield


def _host(out) -> np.ndarray:
    """A partial on the host: a device tensor copied back, a host array as
    it is."""
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _host_list(outs, n: int):
    """Per-member partials (tensors of one shape, or None) on the host with
    one device-to-host copy; ``[None] * n`` for an empty batch."""
    if outs is None:
        return [None] * n
    live = [o for o in outs if o is not None]
    if not live:
        return list(outs)
    it = iter(torch.stack(live).cpu().numpy())
    return [None if o is None else next(it) for o in outs]


def _coarse_agg(setup, cols, m):
    return m


def _member_count(m, cols, mm):
    return mm.sum()


def _member_stats(m, cols, mm, stats, vocab):
    return kstats.device_update(stats[m], cols, mm, vocab)


def _stat_signature(stat: sk.Stat) -> tuple:
    """Shape signature of a stat tree: everything the device reduction of
    each leaf fixes (the reference's ``_stat_signature``)."""
    sig = []
    for leaf in kstats.leaf_stats(stat):
        if isinstance(leaf, sk.DescriptiveStats):
            attrs = tuple(leaf.attributes)
        else:
            attrs = (getattr(leaf, "attribute", None),)
        extra = ()
        if leaf.kind == "histogram":
            extra = (leaf.bins, leaf.lo, leaf.hi)
        elif leaf.kind == "topk":
            extra = (getattr(leaf, "k", None),)
        sig.append((leaf.kind, attrs, extra))
    return tuple(sig)


def _count_agg(setup, cols, m):
    return m.sum()


def _padded_agg(setup, cols, m, fn, args):
    return fn(cols, m, torch, *args).reshape(-1).cpu().numpy()


def _desc_id(d) -> tuple:
    """What tells two compaction descriptors of one plan apart (a scoped
    ``geomesa.compact.b`` or shard bucket gives the plan another): the
    chunk size and count, the windows and the first chunk starts."""
    return (d["B"], d["C"], d["whash"], int(d["cstart"][0]) if len(d["cstart"]) else 0)


def _hash_buckets() -> int:
    """The hash groups of per-key sampling (``geomesa.sample.hash-buckets``;
    its default when unset or 0, since 0 routes keys away from hashing)."""
    return config.SAMPLE_HASH_BUCKETS.to_int() or int(config.SAMPLE_HASH_BUCKETS.default)


def _scan_mask(compiled, cols, wm: torch.Tensor, excise_band=True, sampling=None,
               sample_by=None, sb_mode=None, sb_off=0, sb_vocab=0,
               sb_buckets=0) -> torch.Tensor:
    """window & compiled predicate & ~band, then sampling."""
    m = wm & compiled(cols, torch)
    if compiled.band is not None and excise_band:
        # f32-uncertain rows are excised here and added back exactly
        # from their f64 values by the band correction
        m = m & ~compiled.band(cols, torch)
    if sampling and sample_by and sb_mode == "hash":
        m = kmasks.sampling_mask_by_key_hash(m, sampling, cols[sample_by], sb_buckets)
    elif sampling and sample_by:
        m = kmasks.sampling_mask_by_key_device(m, sampling, cols[sample_by] - sb_off, sb_vocab)
    elif sampling:
        m = kmasks.sampling_mask(m, sampling)
    return m


class _ScanFn:
    """One scan's mask-and-aggregate callable, the registry entry of the
    port (the reference caches a jitted kernel there): the compiled
    predicate and f32 band, the sampling mode and the aggregate, fixed
    when it is built. ``fn(setup, cols, window_mask, extra)`` returns
    ``agg(setup, cols, mask, *extra)``; ``extra`` carries each call's
    data operands (positions, literals, query points, polygon edges), as
    the reference's traced arguments, so the entry holds no data of the
    call that built it. Its first run counts as the build for
    ``kernel:<name>`` dispatch records."""

    __slots__ = ("compiled", "excise_band", "sampling", "sample_by", "sb_mode",
                 "sb_off", "sb_vocab", "sb_buckets", "agg", "fresh")

    def __init__(self, compiled, agg, sampling=None, sample_by=None, sb_mode=None,
                 sb_off=0, sb_vocab=0, excise_band=True, sb_buckets=0):
        self.compiled = compiled
        self.excise_band = excise_band
        self.sampling, self.sample_by = sampling, sample_by
        self.sb_mode, self.sb_off, self.sb_vocab = sb_mode, sb_off, sb_vocab
        self.sb_buckets = sb_buckets
        self.agg = agg
        self.fresh = True

    def mask(self, cols, wm: torch.Tensor) -> torch.Tensor:
        return _scan_mask(self.compiled, cols, wm, self.excise_band, self.sampling,
                          self.sample_by, self.sb_mode, self.sb_off, self.sb_vocab,
                          self.sb_buckets)

    def __call__(self, setup, cols, wm, extra=()):
        if self.fresh:
            self.fresh = False
            with kreg.building():
                return self.agg(setup, cols, self.mask(cols, wm), *extra)
        return self.agg(setup, cols, self.mask(cols, wm), *extra)


class _BatchFn:
    """A query-axis batch's callable (the registry entry of the
    reference's batched kernel): the template's residual, slot compares
    and bands and the member aggregate, fixed when built; each call passes
    the columns, the stacked windows, the literals, which members have a
    scan, and its extra operands."""

    __slots__ = ("bf", "member_agg", "fresh")

    def __init__(self, bf, member_agg):
        self.bf, self.member_agg = bf, member_agg
        self.fresh = True

    def _run(self, cols, win, L, lf, li, present, extra):
        bf = self.bf
        res = bf.residual(cols, torch)
        res_band = None if bf.residual.band is None else bf.residual.band(cols, torch)
        outs = []
        for m, live in enumerate(present):
            if not live:
                outs.append(None)
                continue
            mm = (kmasks.window_mask_batch(*win, L, m) & res
                  & bf.slots(cols, torch, lf[m], li[m]))
            band = res_band
            if bf.slots_band is not None:
                sb = bf.slots_band(cols, torch, lf[m], li[m])
                band = sb if band is None else band | sb
            if band is not None:
                mm = mm & ~band
            outs.append(self.member_agg(m, cols, mm, *extra))
        return outs

    def __call__(self, *args):
        if self.fresh:
            self.fresh = False
            with kreg.building():
                return self._run(*args)
        return self._run(*args)


class Executor:
    """Runs plans over one store. ``compact_min_rows`` /
    ``compact_fraction`` override ``geomesa.compact.min.rows`` /
    ``geomesa.compact.fraction``; None reads the knob at each scan."""

    def __init__(self, store: FeatureStore, compact_min_rows: Optional[int] = None,
                 compact_fraction: Optional[float] = None, version_source=None):
        self.store = store
        self.device = store.device
        self.compact_min_rows = compact_min_rows
        self.compact_fraction = compact_fraction
        #: the store whose version also keys the caches: the partitioned
        #: parent for a partition child, else the store itself
        self.version_source = version_source or store

    # -- the kernel registry ---------------------------------------------------
    def kernel_registry(self) -> KernelRegistry:
        """The shared scan-callable LRU: one per parent store, shared by
        every partition child and every aggregate-cache cell query."""
        reg = self.version_source.__dict__.get("_kernel_registry")
        if reg is None:
            reg = self.version_source.__dict__["_kernel_registry"] = KernelRegistry()
        return reg

    @staticmethod
    def _plan_registry(plan: QueryPlan) -> KernelRegistry:
        """Token-less plans (raw filters) keep their callables on the plan."""
        reg = plan.__dict__.get("_kernel_fns")
        if reg is None:
            reg = plan.__dict__["_kernel_fns"] = KernelRegistry()
        return reg

    def _dict_fp(self):
        """Dictionary growth, the one store change that invalidates a
        compiled predicate (string codes resolve when it is compiled)."""
        return dict_fingerprint(self.store.dicts)

    def _scan_fn(self, plan: QueryPlan, setup, cache_key, agg: Callable,
                 sampled: bool = True, excise_band: bool = True) -> _ScanFn:
        """The registry's callable for this scan under the reference's
        ``fn_key`` (``("compact", cache_key, B, C, ...)`` on the compacted
        layout, ``(cache_key, L, K, ...)`` on the padded one, with the
        plan's token, index and dictionary fingerprint when it has a
        token, else on the plan); built and put on a miss. ``cache_key``
        None builds a fresh callable every call, as the reference jits one
        per call there."""
        h = plan.hints
        sampling = h.sampling if sampled else None
        sample_by = h.sample_by if sampled else None
        sb_mode = setup["sb_mode"] if sampled else None
        sb_off = setup["sb_off"]
        if sb_mode == "exact-span":
            sb_vocab = setup["sb_vocab"]
        else:
            sb_vocab = (len(self.store.dicts[sample_by])
                        if sample_by and sample_by in self.store.dicts else 0)
        reg = key = None
        if cache_key is not None:
            d = setup["compact"]
            if d is not None:
                head = ("compact", cache_key, d["B"], d["C"])
            else:
                head = (cache_key, setup["L"], setup["starts"].shape[1])
            key = head + (sampling, sample_by, sb_mode, sb_off, sb_vocab,
                          setup["sb_buckets"])
            token = plan.__dict__.get("cache_token")
            if token is not None:
                reg = self.kernel_registry()
                key += (token, plan.index_name, self._dict_fp())
            else:
                reg = self._plan_registry(plan)
            if d is None:
                self._note(plan, shape_bucket=(setup["L"], setup["starts"].shape[1]))
            fn = reg.get(key)
            if fn is not None:
                self._note(plan, kernel="hit")
                return fn
        fn = _ScanFn(plan.compiled, agg, sampling, sample_by, sb_mode, sb_off,
                     sb_vocab, excise_band, setup["sb_buckets"])
        if reg is not None:
            reg.put(key, fn)
            self._note(plan, kernel="trace")
        return fn

    @property
    def _gathered(self) -> Dict[tuple, torch.Tensor]:
        """Gathered compact slabs by (table, windows, B, C, version,
        column), kept with the store's device state."""
        return self.store.device_state.setdefault("gathered", {})

    # -- per-plan caches ----------------------------------------------------
    def _cache(self, plan: QueryPlan) -> Dict:
        """Host and device artefacts of one plan (windows, compaction
        descriptor, gathered columns, schedules) for the current store
        versions. They ride on the plan, except under a partition child:
        one plan scans many children, so each child keeps its own with its
        device state, which goes when the child is spilled."""
        holder = plan.__dict__
        if self.version_source is not self.store:
            plans = self.store.device_state.setdefault("plans", {})
            ent = plans.get(id(plan))
            if ent is None or ent[0] is not plan:
                if len(plans) >= _PLAN_CACHES:
                    plans.clear()
                ent = plans[id(plan)] = (plan, {})
            holder = ent[1]
        # the bucketing knobs shape the windows (K), so they key them too
        version = (self.store.version, self.version_source.version,
                   config.COMPACT_BUCKETING.get(), config.COMPACT_BUCKET_FLOOR.get())
        c = holder.get("_exec_cache")
        if c is None or c["version"] != version:
            c = holder["_exec_cache"] = {"version": version}
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
        sb = plan.hints.sample_by
        if sb and not plan.hints.sampling:
            raise ValueError("sample_by requires sampling (the 1-in-n rate)")
        if sb and not table.has_column(sb):
            raise KeyError(f"sample-by attribute {sb!r} not found")
        sb_mode, sb_off, sb_vocab = self._sample_mode(table, sb, c)
        if sb_mode is not None:
            needed = list(dict.fromkeys(needed + [sb]))
        for name in needed:
            if not table.has_column(name):
                raise KeyError(f"column {name!r} not in schema {plan.schema!r}")
        host_only = any(table.is_host_only(n) for n in needed)
        compiled = plan.compiled
        plan.__dict__["scanned_rows"] = int(np.maximum(ends - starts, 0).sum())
        plan.__dict__["table_rows"] = int(table.n)
        # the partition pipeline stages these columns of the next partition
        plan.__dict__["needed_cols"] = tuple(needed)
        return {
            "table": table, "starts": starts, "ends": ends,
            "counts": np.diff(table.shard_bounds).astype(np.int32),
            "L": table.shard_len, "needed": needed, "cache": c,
            "use_device": not host_only and (sb is None or sb_mode is not None)
            and (compiled.refine is None or compiled.refine_only_if_band),
            "coarse_device": not host_only and compiled.refine is not None,
            "sb_mode": sb_mode, "sb_off": sb_off, "sb_vocab": sb_vocab,
            "sb_buckets": _hash_buckets(),
            # a cached scan callable reads the call's plan and executor here
            "plan": plan, "ex": self,
        }

    def _sample_mode(self, table: IndexTable, sb: Optional[str], c: Dict):
        """(mode, offset, vocabulary) of per-key sampling on the device, as
        the reference chooses: ``exact`` for a dictionary of at most
        :data:`SAMPLE_EXACT_VOCAB` codes, ``exact-span`` for an int32 key
        whose values span fewer than that (offset by the minimum), else
        ``hash`` (None when ``geomesa.sample.hash-buckets`` is 0); (None,
        0, 0) for no key or a key the device cannot count exactly (float,
        int64, host-only), which samples on the host."""
        if not sb or table.is_host_only(sb) or table.dtype_of(sb) != np.int32:
            return None, 0, 0
        hashed = ("hash" if (config.SAMPLE_HASH_BUCKETS.to_int() or 0) > 0
                  else None), 0, 0
        d = self.store.dicts.get(sb)
        if d is not None:
            if 0 < len(d) <= SAMPLE_EXACT_VOCAB:
                return "exact", 0, len(d)
            return hashed
        span = c.setdefault("sb_span", {})
        if sb not in span:
            col = table.col_sorted(sb)
            span[sb] = (int(col.min()), int(col.max())) if len(col) else (0, -1)
        lo, hi = span[sb]
        if 0 <= hi - lo < SAMPLE_EXACT_VOCAB:
            return "exact-span", lo, hi - lo + 1
        return hashed

    def _fine_windows(self, plan: QueryPlan, setup):
        """Windows re-resolved from a re-covered key plan under the much
        larger ``geomesa.compact.cover`` range budget (and window cap): the
        compacted layout costs per admitted row and the density schedule
        wants spatially tight chunks."""
        c = setup["cache"]
        cover = config.COMPACT_COVER.to_int() or 0
        key = ("fine", cover, config.SCAN_RANGES_TARGET.to_int())
        if key not in c:
            table = setup["table"]
            # the fine cover depends on the filter and the index alone: it
            # rides on the plan, shared by every partition a plan scans
            covers = plan.__dict__.setdefault("_fine_key_plans", {})
            if cover <= (config.SCAN_RANGES_TARGET.to_int() or 2000):
                c[key] = (None, None)  # no finer than the planner's cover
                return c[key]
            if (plan.index_name, cover) not in covers:
                covers[(plan.index_name, cover)] = table.keyspace.plan(
                    self.store.ft, plan.filter, cover)
            kp = covers[(plan.index_name, cover)]
            c[key] = (None, None) if kp is None else table.windows(kp, cap=cover)
        return c[key]

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
            override = config.COMPACT_B.to_int() or 0
            if override:
                # clamp the knob onto the ladder (a B off it, or above L,
                # would break the slab clamp arithmetic)
                B = min(ladder, key=lambda b: abs(b - override))
            else:
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

    def _compact_knobs(self):
        """(min rows, fraction) of this scan: the constructor's overrides,
        else ``geomesa.compact.min.rows`` / ``.fraction``."""
        min_rows = self.compact_min_rows
        if min_rows is None:
            min_rows = config.COMPACT_MIN_ROWS.to_int() or 0
        frac = self.compact_fraction
        if frac is None:
            frac = config.COMPACT_FRACTION.to_float()
            frac = 0.5 if frac is None else frac
        return min_rows, frac

    def _maybe_compact(self, plan: QueryPlan, setup) -> None:
        """Set ``setup['compact']`` to the chunk descriptor of the compacted
        layout, or None (padded layout). Chunks are B-row slabs covering
        every window in global row order; ``lo`` carries the end-of-table
        clamp: chunk c's valid rows sit at [lo, lo + valid) from cstart.
        ``geomesa.compact.enabled`` and the row floor are read at each
        scan; the descriptor is cached per plan under the knobs that shape
        it (``geomesa.compact.b``, the fraction, ``geomesa.compact.cover``)
        and shared by content across the store's plans (the reference's
        ``compact.desc.shared``). ``cache['compact']`` keeps the last
        scan's descriptor."""
        setup["compact"] = None
        min_rows, frac = self._compact_knobs()
        if not config.COMPACT_ENABLED.to_bool() or setup["table"].n < min_rows:
            return
        c = setup["cache"]
        descs = c.setdefault("compact_descs", {})
        ckey = (setup["L"], config.COMPACT_B.to_int(), frac, config.COMPACT_COVER.to_int())
        if ckey not in descs:
            descs[ckey] = self._build_compact(plan, setup, frac)
        # the last compacted scan's descriptor
        setup["compact"] = c["compact"] = descs[ckey]

    def _build_compact(self, plan: QueryPlan, setup, frac: float):
        table = setup["table"]
        chosen = self._compact_candidates(plan, setup)
        if chosen is None:
            return None
        starts, ends, B, lens = chosen
        # the descriptor is pure in the resolved windows' bytes, the layout
        # and the refusal's inputs: another plan (or site) that resolves the
        # same windows reuses it (keyed by the bytes, never their hash)
        share = self.store.__dict__.setdefault("_desc_share", {})
        skey = ("flat", B, setup["L"], table.n, frac, starts.shape, starts.tobytes(),
                ends.tobytes())
        if skey in share:
            metrics.inc(metrics.COMPACT_DESC_SHARED)
            return share[skey]
        if len(share) >= 64:
            share.clear()
        share[skey] = desc = self._chunk_desc(table, starts, ends, B, lens, frac)
        return desc

    @staticmethod
    def _chunk_desc(table, starts, ends, B: int, lens, frac: float):
        """The chunk descriptor of windows ``starts`` / ``ends`` in B-row
        slabs, or None when they admit most of the table."""
        S, K = starts.shape
        L = table.shard_len
        flat_lens = lens.reshape(-1)
        nc = -(-flat_lens // B)
        C = int(nc.sum())
        if C * B >= table.n * frac:
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
        key0 = (table.keyspace.name, d["whash"], d["B"], d["C"], setup["L"],
                 self.store.version)
        out, missing = {}, []
        for n in names:
            hit = self._gathered.get(key0 + (n,))
            (out.__setitem__(n, hit) if hit is not None else missing.append(n))
        if missing:
            with tracing.span("scan.device_put", compact=True):
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
        return kmasks.window_mask(*c["padded_win"], setup["L"])

    def _scan_cols(self, setup, agg_cols) -> Dict[str, torch.Tensor]:
        """The scan's device columns: compact [C, B] slabs, or the padded
        [S, L] columns."""
        names = list(dict.fromkeys(setup["needed"] + list(agg_cols)))
        if setup["compact"] is not None:
            return self._compact_cols(setup, names)
        with tracing.span("scan.device_put"):
            return setup["table"].device_columns(names)

    @staticmethod
    def _kernel_span(setup, site: Optional[str]):
        """The ``scan.kernel`` span of one scan (attributes as the
        reference's: ``compact`` on the compacted layout, and the site)."""
        if setup["compact"] is not None:
            return tracing.span("scan.kernel", compact=True, site=site)
        return tracing.span("scan.kernel", site=site)

    def _fused(self, plan: QueryPlan, setup, agg_cols):
        """(columns, mask): window & compiled predicate & ~band."""
        cols = self._scan_cols(setup, agg_cols)
        return cols, self._fused_mask(plan, setup, cols)

    def _window_mask(self, setup) -> torch.Tensor:
        """The scan windows' mask: [C, B] on the compacted layout (chunk
        c's valid rows at [lo, lo + valid)), else [S, L]."""
        d = setup["compact"]
        if d is None:
            return self._padded_window_mask(setup)
        c = setup["cache"]
        key = ("compact_win",) + _desc_id(d)
        if key not in c:
            c[key] = (self._tensor(d["lo"]), self._tensor(d["valid"]))
        lo, valid = c[key]
        iota = torch.arange(d["B"], dtype=torch.int32, device=self.device)[None, :]
        return (iota >= lo[:, None]) & (iota < (lo + valid)[:, None])

    def _fused_mask(self, plan: QueryPlan, setup, cols) -> torch.Tensor:
        """The scan's mask over ``cols``: window & compiled predicate &
        ~band, then sampling."""
        h = plan.hints
        return _scan_mask(plan.compiled, cols, self._window_mask(setup), True, h.sampling,
                          h.sample_by, setup["sb_mode"], setup["sb_off"], setup["sb_vocab"],
                          setup["sb_buckets"])

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
        # the band over the scan windows' rows only (a selective query's
        # windows hold a sliver of the table): the same rows, ascending, as
        # the band over the whole table restricted to the windows
        pos = self._window_positions(setup)
        rows = setup["table"].rows(compiled.columns, pos)
        band = np.broadcast_to(np.asarray(compiled.band(rows, np)), pos.shape)
        idx = pos[band]
        if len(idx):
            keep = np.asarray(compiled.refine({n: v[band] for n, v in rows.items()}, np))
            if keep.ndim == 0:
                keep = np.full(len(idx), bool(keep))
            idx = idx[keep.reshape(-1).astype(bool)]
        c["band"] = idx.astype(np.int64)
        return c["band"]

    # -- the host paths ------------------------------------------------------
    def _device_coarse_mask(self, plan: QueryPlan, setup) -> np.ndarray:
        """Window mask & coarse predicate on the device over the padded
        [S, L] layout; the sorted-order positions it keeps, on the host.
        Its milliseconds, the copy back included, add to
        ``device_coarse_ms``."""
        t0 = time.perf_counter()
        with tracing.span("scan.device_put"):
            cols = setup["table"].device_columns(setup["needed"])
        setup["compact"] = None
        go = self._scan_fn(plan, setup, ("coarse_mask",), _coarse_agg,
                           sampled=False, excise_band=False)
        with tracing.span("scan.kernel", site="coarse_mask"), \
                utilization.device_busy(self.device):
            metrics.inc(metrics.EXEC_DEVICE_DISPATCH)
            m = go(setup, cols, self._padded_window_mask(setup))
        m = m.cpu().numpy()
        plan.__dict__["device_coarse_ms"] = (
            plan.__dict__.get("device_coarse_ms", 0.0) + (time.perf_counter() - t0) * 1e3)
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

    def _host_positions(self, plan: QueryPlan, setup,
                        coarse: Optional[np.ndarray]) -> np.ndarray:
        """The exact matches' sorted-order positions on the host: the
        device's ``coarse`` rows, or (None) the window rows under the
        predicate, then the exact refinement on the rows kept."""
        compiled = plan.compiled
        table = setup["table"]
        if coarse is not None:
            pos = coarse
        else:
            pos = self._window_positions(setup)
            if len(pos):
                check_deadline()  # the host predicate pass
                m = np.asarray(compiled(table.rows(setup["needed"], pos), np))
                pos = pos if m.ndim == 0 and bool(m) else pos[np.broadcast_to(m, pos.shape)]
        if compiled.refine is not None and len(pos):
            check_deadline()  # the host refinement pass
            t0 = time.perf_counter()
            names = list(dict.fromkeys(compiled.columns + compiled.refine_columns))
            n_cand = len(pos)
            pos = pos[compiled.refine_rows(table.rows(names, pos), n_cand)]
            # the host refinement's share of the call
            self._note(plan, refined_rows=n_cand,
                       refine_ms=(time.perf_counter() - t0) * 1e3)
        return self._host_sample(plan, setup, pos)

    @staticmethod
    def _host_sample(plan: QueryPlan, setup, pos: np.ndarray) -> np.ndarray:
        """The sampled subset of the exact matches ``pos`` (sorted-order
        positions, ascending: the padded layout's row order), as the
        reference's host mask samples: hash-bucketed keys where the device
        would hash, else an exact counter per distinct value."""
        h = plan.hints
        if not h.sampling or not len(pos):
            return pos
        keep = np.ones(len(pos), bool)
        if h.sample_by:
            key = setup["table"].rows([h.sample_by], pos)[h.sample_by]
            if setup["sb_mode"] == "hash":
                keep = kmasks.sampling_mask_by_key_hash_np(
                    keep, h.sampling, key, setup["sb_buckets"])
            else:
                codes = np.unique(key, return_inverse=True)[1].reshape(-1)
                keep = kmasks.sampling_mask_by_key(keep, h.sampling, codes)
        else:
            keep = kmasks.sampling_mask_np(keep, h.sampling)
        return pos[keep]

    # -- the scan ---------------------------------------------------------------
    def _run(self, plan: QueryPlan, agg_cols, device_agg: Callable,
             host_agg: Callable, additive: bool = True, compactable: bool = True,
             path_key: str = "scan", deadline: bool = True,
             device_sync: Optional[Callable] = None,
             host_span: bool = True, cache_key: Optional[tuple] = None,
             extra=(), compact_key: Optional[Callable] = None):
        """One scan of ``plan``: ``device_agg(setup, cols, mask)`` on the
        device path, plus ``host_agg(rows, pos)`` of the band rows when the
        aggregate is ``additive``; or ``host_agg(rows, pos)`` of the exact
        matches (sorted-order positions ``pos``) on a host path, which also
        serves band rows of non-additive or sampled scans. Not
        ``compactable``: the device scans the padded layout (its results
        address flat [S, L] rows). ``exec_path[path_key]`` records the
        path. None for an empty scan. ``deadline``: check the query's
        deadline first (the host passes check theirs in any case).
        ``device_sync(setup, out)`` brings a device result to the host
        under a ``scan.sync`` span; ``host_span`` False leaves a host
        path's ``scan.host`` span out (a feature scan's, as the
        reference's). ``cache_key`` is the reference's registry key of the
        site (see :meth:`_scan_fn`); its first element names the
        ``scan.kernel`` span's site;
        ``device_agg(setup, cols, mask, *extra)`` must read everything a
        call varies in from ``setup`` (``plan``, ``ex``) and ``extra``, since
        the registry reuses the first call's callable. ``compact_key(setup)``
        gives the suffix the compacted layout's key takes (the density
        schedule's shape). A feature scan (``path_key`` ``feature_scan``)
        notes no ``kernel:<name>`` routes, as the reference's runs outside
        its scan runner."""
        if deadline:
            check_deadline()
        setup = self._scan_setup(plan, agg_cols)
        if setup is None:
            return None
        kreg.take_dispatch()  # drop records a prior scan's build left
        try:
            return self._run_inner(plan, setup, agg_cols, device_agg, host_agg, additive,
                                   compactable, path_key, device_sync, host_span,
                                   cache_key, extra, compact_key)
        finally:
            disp = kreg.take_dispatch()
            if disp and path_key != "feature_scan":
                self._note(plan, **{f"kernel:{k}": v for k, v in disp.items()})

    def _run_inner(self, plan, setup, agg_cols, device_agg, host_agg, additive,
                   compactable, path_key, device_sync, host_span, cache_key,
                   extra, compact_key):
        self._note(plan, sampling=setup["sb_mode"] if plan.hints.sample_by else None)
        table = setup["table"]
        info = self._band_info(plan, setup) if setup["use_device"] else None
        band_rows = 0 if info is None else len(info)
        if not setup["use_device"] or (
                band_rows and (not additive or plan.hints.sampling)):
            coarse = self._device_coarse_mask(plan, setup) if setup["coarse_device"] else None
            self._note(plan, **{path_key: "host+device-coarse" if setup["coarse_device"]
                                else "host"}, band_rows=band_rows)
            with tracing.span("scan.host") if host_span else tracing.NOOP:
                pos = self._host_positions(plan, setup, coarse)
                return host_agg(table.rows(agg_cols, pos), pos)
        if compactable:
            self._maybe_compact(plan, setup)
        else:
            setup["compact"] = None
        cols = self._scan_cols(setup, agg_cols)
        ckey = cache_key
        if ckey is not None and setup["compact"] is not None and compact_key is not None:
            ckey = ckey + compact_key(setup)
        go = self._scan_fn(plan, setup, ckey, device_agg)
        if callable(extra):
            extra = extra()
        # the span's site is the registry key's, as the reference's
        site = None if cache_key is None else str(cache_key[0])
        with self._kernel_span(setup, site), utilization.device_busy(self.device):
            # one observable unit of device work (the reference's count at
            # its device scan): a call the cache serves whole launches none
            metrics.inc(metrics.EXEC_DEVICE_DISPATCH)
            out = go(setup, cols, self._window_mask(setup), extra)
        d = setup["compact"]
        if d is not None:
            self._note(plan, **{path_key: "device-compact"}, B=d["B"], band_rows=band_rows)
        else:
            self._note(plan, **{path_key: "device-padded"}, band_rows=band_rows)
        if device_sync is not None:
            with tracing.span("scan.sync"):
                out = device_sync(setup, out)
                utilization.extend_last(self.device)
        if not band_rows:
            return out
        return out + host_agg(table.rows(agg_cols, info), info)

    # -- public operations ----------------------------------------------------
    def count_partial(self, plan: QueryPlan):
        """:meth:`count` before the device sync: a device scalar (plus the
        band rows), a host int, or None for an empty scan."""
        return self._run(plan, (), _count_agg, lambda rows, pos: len(pos), cache_key=("count",))

    def count(self, plan: QueryPlan) -> int:
        out = self.count_partial(plan)
        if out is None:
            return 0
        with tracing.span("scan.sync"):
            n = int(out)
            utilization.extend_last(self.device)
            return n

    def padded_rows(self, plan: QueryPlan, agg_cols, fn: Callable, fill,
                    dtype, cache_key: Optional[tuple] = None, args=(),
                    device_args=None) -> Optional[np.ndarray]:
        """A per-row, non-additive aggregate addressed in the padded [S, L]
        layout, flat [S * L] on the host: ``fn(cols, mask, xp, *args)``
        gives one value per row, ``fill`` where the mask is false
        (``device_args``, default ``args``, are its operands on the device
        path). The device scans the padded layout, never the compacted
        one. On a host path (the plan refines, or its scan holds f32 band
        rows, whose exact contribution a per-row aggregate cannot add)
        ``fn`` runs with NumPy on the exact matches' host rows, as the
        reference's host runner runs it over the padded host stack, and
        every other row gets ``fill``. None for an empty scan.
        ``cache_key``: the registry key of the caller's site; ``fn`` and
        its operands reach the registry's callable as call operands, so a
        hit never reads the data of the call that built it."""
        table = self._table(plan)

        def host_agg(rows, pos):
            out = np.full(table.n_shards * table.shard_len, fill, dtype)
            if len(pos):
                s = np.searchsorted(table.shard_bounds, pos, side="right") - 1
                flat = s * table.shard_len + pos - table.shard_bounds[s]
                out[flat] = fn(rows, np.ones(len(pos), bool), np, *args)
            return out

        return self._run(plan, agg_cols, _padded_agg, host_agg, additive=False,
                         compactable=False, cache_key=cache_key,
                         extra=(fn, tuple(args if device_args is None else device_args)))

    def _grouped_schedule(self, plan: QueryPlan, setup, bbox, width, height):
        """The grouped kernel's schedule (tensors on the device), cached per
        (plan, grid); None when the scan is not compacted, the index has
        neither a Morton key nor xz codes, or the pairs exceed the
        duplication budget."""
        d = setup["compact"]
        if d is None:
            return None
        c = setup["cache"]
        max_dup = config.DENSITY_PALLAS_MAX_DUP.to_float()
        key = ("grouped", tuple(float(v) for v in bbox), width, height, max_dup) + _desc_id(d)
        hit = c.get(key)
        if hit is None:
            table = setup["table"]
            gr = kgrouped.build_grouped(
                d, table, table.keyspace, bbox, width, height, max_dup,
                box_cache=c.setdefault("boxes", {}),
            )
            hit = False
            if gr is not None:
                seg = kgrouped.tile_segments(gr)
                hit = {k: self._tensor(v) if isinstance(v, np.ndarray) else v
                       for k, v in seg.items()}
                # the registry key's suffix, the reference's grouped one
                hit["key"] = ("grouped", int(gr["n_pairs"]), int(d["B"]),
                              int(gr["ntx"]), int(gr["nty"]))
            c[key] = hit
        return hit or None

    def _pair_schedule(self, plan: QueryPlan, setup, bbox, width, height):
        """The einsum rung's pair schedule (tensors on the device), cached
        per (plan, grid, tile shape); None when the scan is not compacted,
        the index is neither z3 nor z2, or no chunk meets the grid."""
        d = setup["compact"]
        if d is None:
            return None
        c = setup["cache"]
        key = (("pairs", tuple(float(v) for v in bbox), width, height, kmxu.tile_shape())
               + _desc_id(d))
        hit = c.get(key)
        if hit is None:
            table = setup["table"]
            pr = kmxu.build_pairs(d, table, table.keyspace, bbox, width, height,
                                  box_cache=c.setdefault("boxes", {}))
            hit = False
            if pr is not None:
                hit = dict(pr)
                for k in ("chunk", "tile"):
                    hit[k] = self._tensor(pr[k].astype(np.int64))
                for k in ("px0", "py0"):
                    hit[k] = self._tensor(pr[k])
                # the registry key's suffix, the reference's einsum one
                hit["key"] = ("mxu", int(pr["P"]), int(pr["PB"]), int(pr["TX"]),
                              int(pr["TY"]))
            c[key] = hit
        return hit or None

    def _density_rung(self, plan: QueryPlan, setup, bbox, width, height):
        """(rung, schedule) of a density scan, in the reference's order: the
        grouped kernel (``geomesa.density.pallas``), then the einsum pairs
        (``geomesa.density.mxu``), else the scatter (schedule None)."""
        if config.DENSITY_PALLAS.to_bool():
            sched = self._grouped_schedule(plan, setup, bbox, width, height)
            if sched is not None:
                return "grouped", sched
        if config.DENSITY_MXU.to_bool():
            sched = self._pair_schedule(plan, setup, bbox, width, height)
            if sched is not None:
                return "mxu-einsum", sched
        return "scatter", None

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
        rung, sched = self._density_rung(plan, setup, bbox, width, height)
        if rung != "grouped":
            return None
        xc, yc = agg_cols[:2]
        return {"x": cols[xc], "y": cols[yc], "mask": m,
                "weight": None if weight is None else cols[weight].to(torch.float32),
                "sched": sched}

    def density(self, plan: QueryPlan, bbox, width: int, height: int,
                weight: Optional[str] = None, as_numpy: bool = True):
        """(height, width) f32 density grid. A compacted scan takes the
        reference's ladder: the grouped CUDA kernel where its schedule
        exists (z3 / z2 / xz), then the einsum pairs (z3 / z2), then the
        scatter, which the padded layout always takes; host paths grid
        their exact rows on the host. ``exec_path['density_kernel']`` names
        the rung. ``as_numpy=False`` returns the grid as a tensor on the
        device (None for an empty scan)."""
        agg_cols = self._density_cols(weight)
        xc, yc = agg_cols[:2]

        def device_agg(setup, cols, m):
            ex, p = setup["ex"], setup["plan"]
            rung, sched = ex._density_rung(p, setup, bbox, width, height)
            ex._note(p, density_kernel=rung)
            w = None if weight is None else cols[weight].to(torch.float32)
            if rung == "grouped":
                return kgrouped.density_grouped(cols[xc], cols[yc], m, w, bbox, width,
                                                height, sched)
            if rung == "mxu-einsum":
                return kmxu.density_grid_pairs(cols[xc], cols[yc], m, bbox, width,
                                               height, w, sched)
            return kdensity.density_grid(cols[xc], cols[yc], m, bbox, width, height,
                                         cols[weight] if weight else None)

        def compact_key(setup):
            _, sched = self._density_rung(plan, setup, bbox, width, height)
            return () if sched is None else sched["key"]

        def host_agg(rows, pos):
            return self._tensor(kdensity.density_grid_np(
                rows[xc], rows[yc], np.ones(len(pos), bool), bbox, width, height,
                rows[weight] if weight else None,
            ))

        out = self._run(plan, agg_cols, device_agg, host_agg,
                        cache_key=("density", tuple(bbox), width, height, weight),
                        compact_key=compact_key)
        if not as_numpy:
            return out
        if out is None:
            return np.zeros((height, width), np.float32)
        with tracing.span("scan.sync"):
            grid = out.cpu().numpy()
            utilization.extend_last(self.device)
            return grid

    # -- curve-aligned density (the index-native heatmap) ---------------------
    def _curve_positions(self, plan: QueryPlan, level: int, block_window):
        """Padded-flat CDF positions of every level-``level`` Morton block
        of the crop window, on the host: each block is one contiguous range
        of the z2-sorted order, so its masked count is the difference of
        two prefix sums. ``(p0, p1, B, nx, ny)``; the block count pads to a
        power of two with (0, 0) pairs. Cached per (store version, level,
        window) on the store, 32 entries."""
        table = self._table(plan)
        key = ("curve_pos", table.keyspace.name, self.store.version, level,
               tuple(block_window))
        cache = self.store.__dict__.setdefault("_curve_pos_cache", {})
        hit = cache.get(key)
        if hit is not None:
            return hit
        ix0, iy0, ix1, iy1 = block_window
        nx, ny = ix1 - ix0 + 1, iy1 - iy0 + 1
        jj, ii = np.meshgrid(np.arange(iy0, iy1 + 1, dtype=np.uint64),
                             np.arange(ix0, ix1 + 1, dtype=np.uint64), indexing="ij")
        codes = interleave2(ii.ravel(), jj.ravel())
        shift_bits = 2 * (31 - level)
        z_lo = codes << np.uint64(shift_bits)
        z_hi = (codes + np.uint64(1)) << np.uint64(shift_bits)
        z_col = table.key_columns["__z2"]
        sh = 0 if table.key_shifts is None else table.key_shifts.get("__z2", 0)
        if sh > shift_bits:
            raise ValueError(
                f"z2 keys quantized below level {level} blocks "
                f"(shift {sh} > {shift_bits}); use the scatter density path"
            )
        g0 = np.searchsorted(z_col, (z_lo >> np.uint64(sh)).astype(z_col.dtype))
        g1 = np.searchsorted(z_col, (z_hi >> np.uint64(sh)).astype(z_col.dtype))
        bounds, L = table.shard_bounds, table.shard_len

        def pad_pos(g):
            s = np.clip(np.searchsorted(bounds, g, side="right") - 1, 0, table.n_shards - 1)
            return (s * L + (g - bounds[s])).astype(np.int32)

        p0, p1 = pad_pos(g0), pad_pos(g1)
        B = len(p0)
        Bp = 1 << max(B - 1, 0).bit_length()
        if Bp != B:
            p0 = np.concatenate([p0, np.zeros(Bp - B, np.int32)])
            p1 = np.concatenate([p1, np.zeros(Bp - B, np.int32)])
        out = (p0, p1, B, nx, ny)
        if len(cache) >= 32:
            cache.clear()
        cache[key] = out
        return out

    def _device_positions(self, key, *arrays):
        """int64 device copies of host position arrays, kept with the
        store's device state (32 entries)."""
        cache = self.store.device_state.setdefault("curve_pos", {})
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= 32:
                cache.clear()
            hit = cache[key] = tuple(self._tensor(a.astype(np.int64)) for a in arrays)
        return hit

    @staticmethod
    def _curve_weights(m: torch.Tensor, cols, weight: Optional[str]) -> torch.Tensor:
        """The rows' curve contributions: int32 counts (exact to 2^31
        rows), or the f32 weight of each masked-in row."""
        fm = m.reshape(-1)
        if weight is None:
            return fm.to(torch.int32)
        return torch.where(fm, cols[weight].reshape(-1).to(torch.float32),
                           torch.zeros((), dtype=torch.float32, device=fm.device))

    @staticmethod
    def _cdf(w: torch.Tensor) -> torch.Tensor:
        """``[0, cumsum(w)]`` in ``w``'s own dtype (int32 counts stay int32
        end to end, as the reference's)."""
        c = torch.empty(w.numel() + 1, dtype=w.dtype, device=w.device)
        c[:1] = 0
        torch.cumsum(w, 0, dtype=w.dtype, out=c[1:])
        return c

    def _curve_host_agg(self, plan: QueryPlan, weight: Optional[str], p0, p1):
        """Host-path curve: the exact matches' contributions laid out flat
        on the padded [S, L] grid, then the reference host runner's NumPy
        prefix sum and gathers."""
        table = self._table(plan)

        def host_agg(rows, pos):
            S, L = table.n_shards, table.shard_len
            w = np.zeros(S * L, np.int64 if weight is None else np.float32)
            if len(pos):
                s = np.searchsorted(table.shard_bounds, pos, side="right") - 1
                flat = s * L + pos - table.shard_bounds[s]
                w[flat] = 1 if weight is None else rows[weight].astype(np.float32)
            c = np.concatenate([np.zeros(1, w.dtype), np.cumsum(w)])
            return c[p1] - c[p0]

        return host_agg

    def density_curve_raw(self, plan: QueryPlan, level: int, block_window,
                          weight: Optional[str] = None):
        """:meth:`density_curve` before the copy to the host:
        ``(partial or None, B, nx, ny)``; the one-crop
        :meth:`density_curve_batch_raw`."""
        out, ((_p0, _p1, B, nx, ny),) = self.density_curve_batch_raw(
            plan, level, [block_window], weight, single=True)
        return (None if out is None else out[0]), B, nx, ny

    @staticmethod
    def decode_curve(raw) -> np.ndarray:
        """One :meth:`density_curve_raw` partial as the host f64 grid (zeros
        for an empty partial), row 0 at the south edge. f64 cells hold
        counts exactly to 2^53; weighted cells carry the f32 prefix
        differences."""
        out, B, nx, ny = raw
        if out is None:
            return np.zeros((ny, nx), np.float64)
        return _host(out)[:B].astype(np.float64).reshape(ny, nx)

    def density_curve(self, plan: QueryPlan, level: int, block_window,
                      weight: Optional[str] = None) -> np.ndarray:
        """Exact density over a Morton-block-aligned grid (XYZ / EPSG:4326
        tile pyramids align by construction): one prefix sum over the
        z2-sorted scan and two gathers per block, no scatter. Unweighted
        counts accumulate in int32, weighted densities in f32."""
        return self.decode_curve(self.density_curve_raw(plan, level, block_window, weight))

    @staticmethod
    def _stack_positions(infos, Mp: int):
        """Members' CDF positions as [Mp, P] arrays (P the widest member's;
        padded cells and members gather c[0] - c[0] = 0)."""
        P = max(len(i[0]) for i in infos)
        p0s = np.zeros((Mp, P), np.int32)
        p1s = np.zeros((Mp, P), np.int32)
        for m, (p0, p1, _B, _nx, _ny) in enumerate(infos):
            p0s[m, :len(p0)] = p0
            p1s[m, :len(p1)] = p1
        return p0s, p1s

    def density_curve_batch_raw(self, plan: QueryPlan, level: int, block_windows,
                                weight: Optional[str] = None, single: bool = False):
        """N crops of ONE (plan, level) in one scan: the mask and the prefix
        sum (the O(rows) work) are shared, each crop costs its two gathers,
        stacked as [Mp, P] positions. Each crop equals its serial
        :meth:`density_curve` exactly (the same prefix array, exact
        gathers). ``(partial or None, infos)`` before the host copy. CDF
        positions index the padded layout; band rows send the scan to the
        host (the reference's curve is not additive). ``single``: the
        one-crop call of :meth:`density_curve_raw`, under the reference's
        ``density_curve`` registry key."""
        infos = [self._curve_positions(plan, level, bw) for bw in block_windows]
        if not infos:
            return None, []
        p0s, p1s = self._stack_positions(infos, bucket_batch(len(infos)))
        agg_cols = [weight] if weight else []
        key = ("curve_batch", self._table(plan).keyspace.name, self.store.version,
               level, tuple(tuple(bw) for bw in block_windows))

        def device_agg(setup, cols, m, d0, d1):
            c = Executor._cdf(Executor._curve_weights(m, cols, weight))
            return c[d1] - c[d0]

        Mp, P = p0s.shape
        ckey = (("density_curve", level, P, weight) if single
                else ("density_curve_batch", level, P, Mp, weight))
        out = self._run(plan, agg_cols, device_agg,
                        self._curve_host_agg(plan, weight, p0s, p1s),
                        additive=False, compactable=False,
                        cache_key=ckey,
                        extra=lambda: self._device_positions(key, p0s, p1s))
        return out, infos

    @staticmethod
    def decode_curve_batch(raw):
        """One :meth:`density_curve_batch_raw` partial as per-crop host f64
        grids."""
        out, infos = raw
        arr = None if out is None else _host(out)
        return [np.zeros((ny, nx), np.float64) if arr is None
                else arr[i, :B].astype(np.float64).reshape(ny, nx)
                for i, (_p0, _p1, B, nx, ny) in enumerate(infos)]

    def density_curve_batch(self, plan: QueryPlan, level: int, block_windows,
                            weight: Optional[str] = None):
        """One ``[ny, nx]`` f64 grid per window, in order (see
        :meth:`density_curve_batch_raw`)."""
        return self.decode_curve_batch(
            self.density_curve_batch_raw(plan, level, block_windows, weight))

    def density_curve_filter_batch_raw(self, plans, spec, level: int, block_windows,
                                       weight: Optional[str] = None):
        """M distinct-filter curve crops of one structural template in one
        call: each member has its own viewport literals (``spec``) and its
        own crop window, and pays its own masked prefix sum over one column
        residency. ``(partials or None, infos)``, or None when ineligible
        (the caller runs the members one at a time). A member with
        surviving f32 band rows makes the batch ineligible: its serial scan
        would run on the host."""
        check_deadline()
        agg_cols = [weight] if weight else []
        bs = self._batch_setups(plans, spec, agg_cols)
        if bs is None:
            return None
        infos = [self._curve_positions(plans[0], level, bw) for bw in block_windows]
        if bs["empty"]:
            return None, infos
        if self._batch_band_rows(plans, bs):
            return None
        p0s, p1s = self._stack_positions(infos, bs["Mp"])
        key = ("curve_filter", self._table(plans[0]).keyspace.name,
               self.store.version, level, tuple(tuple(bw) for bw in block_windows))

        def member_agg(m, cols, mm, d0, d1):
            c = Executor._cdf(Executor._curve_weights(mm, cols, weight))
            return c[d1[m]] - c[d0[m]]

        return self._batch_device_agg(
            plans, spec, bs, member_agg, agg_cols, "density_curve_filter_batch",
            key_extras=(level, p0s.shape[1], weight),
            extra=self._device_positions(key, p0s, p1s)), infos

    @staticmethod
    def decode_curve_filter_batch(raw):
        """One :meth:`density_curve_filter_batch_raw` partial as per-member
        host f64 grids."""
        got, infos = raw
        arrs = _host_list(got, len(infos))
        return [np.zeros((ny, nx), np.float64) if arrs[m] is None
                else arrs[m][:B].astype(np.float64).reshape(ny, nx)
                for m, (_p0, _p1, B, nx, ny) in enumerate(infos)]

    def density_curve_filter_batch(self, plans, spec, level: int, block_windows,
                                   weight: Optional[str] = None):
        """M distinct-filter curve grids in one call (None = ineligible),
        each equal to its serial :meth:`density_curve`."""
        got = self.density_curve_filter_batch_raw(plans, spec, level, block_windows, weight)
        return None if got is None else self.decode_curve_filter_batch(got)

    # -- query-axis batches: M distinct viewports of one structural query
    # shape in one call. The compiled residual's mask and band are computed
    # once; each member adds its window mask and its literal-parameterized
    # slot compares (the serial compile's f32 / int32 values) and its own
    # aggregate, so every member's result equals its serial call's. ------
    def _batch_setups(self, plans, spec, agg_cols=()):
        """Per-member scan setups and stacked [Mp, S, K] windows, or None
        when the batch cannot run on the device (the caller runs the
        members one at a time)."""
        setups = []
        table = None
        for plan in plans:
            if plan.hints.sampling or plan.hints.sample_by:
                return None
            su = self._scan_setup(plan, agg_cols)
            if su is None:
                # an empty member (disjoint key plan or empty table): a zero
                # partial, as its serial scan's zeros
                plan.__dict__.setdefault("scanned_rows", 0)
                setups.append(None)
                continue
            if not su["use_device"] or su["sb_mode"] is not None:
                return None
            if table is None:
                table = su["table"]
            elif su["table"] is not table:
                return None
            setups.append(su)
        if table is None:
            return {"empty": True, "setups": setups}
        if any(p.__dict__.get("cache_token") is None for p in plans):
            return None
        S, L = table.n_shards, table.shard_len
        K = max(su["starts"].shape[1] for su in setups if su is not None)
        Mp = bucket_batch(len(plans))
        starts = np.zeros((Mp, S, K), np.int32)
        ends = np.zeros((Mp, S, K), np.int32)
        for m, su in enumerate(setups):
            if su is not None:
                k = su["starts"].shape[1]
                starts[m, :, :k] = su["starts"]
                ends[m, :, :k] = su["ends"]
        return {"empty": False, "setups": setups, "table": table, "L": L, "K": K,
                "Mp": Mp, "starts": starts, "ends": ends,
                "counts": np.diff(table.shard_bounds).astype(np.int32)}

    def _batch_band_rows(self, plans, bs) -> bool:
        """Does any member's scan hold surviving f32 band rows?"""
        for plan, su in zip(plans, bs["setups"]):
            if su is not None and plan.compiled.band is not None:
                info = self._band_info(plan, su)
                if info is not None and len(info):
                    return True
        return False

    def _batch_band_corrs(self, plans, bs, host_agg, agg_cols):
        """Per-member exact band corrections (None = the member has no band
        rows): ``host_agg(m, rows, pos)`` over the member's surviving band
        rows, the serial scan's host correction run off each member's own
        compiled band."""
        corrs = []
        for m, (plan, su) in enumerate(zip(plans, bs["setups"])):
            info = None
            if su is not None and plan.compiled.band is not None:
                info = self._band_info(plan, su)
            if info is None or not len(info):
                corrs.append(None)
                continue
            corrs.append(host_agg(m, su["table"].rows(agg_cols, info), info))
        return corrs

    def _batch_device_agg(self, plans, spec, bs, member_agg, agg_cols, site,
                          key_extras=(), extra=()):
        """Masks and per-member aggregates of one batch:
        ``member_agg(m, cols, mask, *extra)`` for each real member with a
        scan (None for empty members; padded members are skipped, their
        results would be dropped). The batch's callable comes from the
        registry under the reference's key ``((site,) + key_extras, L, K,
        Mp, token, index, dictionary fingerprint)``. The member loop runs in
        one Python call; the literals go to the device once, and each
        member reads its own as 0-d tensors, never as host values."""
        table, L = bs["table"], bs["L"]
        bf = spec.bf
        reg = self.kernel_registry()
        key = ((site,) + tuple(key_extras), L, bs["K"], bs["Mp"], spec.token,
               plans[0].index_name, self._dict_fp())
        go = reg.get(key)
        if go is None:
            go = _BatchFn(bf, member_agg)
            reg.put(key, go)
            for p in plans:
                self._note(p, kernel="trace")
        else:
            for p in plans:
                self._note(p, kernel="hit")
        names = list(dict.fromkeys(list(bf.columns) + list(agg_cols)))
        with tracing.span("scan.device_put", batch=len(plans)):
            cols = table.device_columns(names)
        wcache = self.store.device_state.setdefault("batch_win", {})
        # keyed by the window bytes: another batch's windows must never
        # serve this one
        wkey = (self.store.version, bs["starts"].tobytes(), bs["ends"].tobytes())
        win = wcache.get(wkey)
        if win is None:
            if len(wcache) >= 64:
                wcache.clear()
            win = wcache[wkey] = tuple(self._tensor(bs[k]) for k in ("starts", "ends", "counts"))
        lf, li = self._tensor(spec.lits_f), self._tensor(spec.lits_i)
        for p in plans:
            self._note(p, scan="device-batch", batch=len(plans))
        present = [su is not None for su in bs["setups"]]
        with tracing.span("scan.kernel", site=site, batch=len(plans)), \
                utilization.device_busy(self.device):
            # one dispatch for the whole batch, as the reference counts it
            metrics.inc(metrics.EXEC_DEVICE_DISPATCH)
            return go(cols, win, L, lf, li, present, tuple(extra))

    def count_batch_partial(self, plans, spec):
        """``(partials or None, corrs)`` before the host copy: one device
        count per member and each member's band-row count; None when the
        batch is ineligible here."""
        check_deadline()
        bs = self._batch_setups(plans, spec)
        if bs is None:
            return None
        if bs["empty"]:
            return None, [None] * len(plans)
        corrs = self._batch_band_corrs(plans, bs, lambda m, rows, pos: len(pos), ())
        out = self._batch_device_agg(plans, spec, bs, _member_count, (), "count_batch")
        return out, corrs

    def count_batch(self, plans, spec):
        """M distinct counts in one call (None = ineligible), each equal to
        its serial :meth:`count`."""
        got = self.count_batch_partial(plans, spec)
        return None if got is None else self.decode_count_batch(got, len(plans))

    @staticmethod
    def decode_count_batch(got, n: int):
        """One :meth:`count_batch_partial` result as per-member host ints."""
        out, corrs = got
        arrs = _host_list(out, n)
        return [(0 if arrs[m] is None else int(arrs[m]))
                + (0 if corrs[m] is None else int(corrs[m])) for m in range(n)]

    def density_batch_partial(self, plans, spec, bboxes, width: int, height: int,
                              weight: Optional[str] = None):
        """``(grids or None, corrs)`` before the host copy: one f32 grid per
        member over that member's own bbox, its origin and span read from
        one [Mp, 4] f32 device tensor; None when ineligible."""
        check_deadline()
        agg_cols = self._density_cols(weight)
        xc, yc = agg_cols[:2]
        bs = self._batch_setups(plans, spec, agg_cols)
        if bs is None:
            return None
        if bs["empty"]:
            return None, [None] * len(plans)
        gp = np.zeros((bs["Mp"], 4), np.float32)
        gp[:, 2:] = 1.0  # padded members: benign non-zero spans
        for m, bb in enumerate(bboxes):
            gp[m] = kdensity.grid_params(bb)

        def host_agg(m, rows, pos):
            return kdensity.density_grid_np(
                rows[xc], rows[yc], np.ones(len(pos), bool), tuple(bboxes[m]),
                width, height, rows[weight] if weight else None)

        corrs = self._batch_band_corrs(plans, bs, host_agg, agg_cols)
        g = self._tensor(gp)

        def member_agg(m, cols, mm, g_):
            return kdensity.density_grid_at(
                cols[xc], cols[yc], mm, g_[m, 0], g_[m, 1], g_[m, 2], g_[m, 3],
                width, height, cols[weight] if weight else None)

        return self._batch_device_agg(plans, spec, bs, member_agg, agg_cols, "density_batch",
                                      key_extras=(width, height, weight), extra=(g,)), corrs

    def density_batch(self, plans, spec, bboxes, width: int, height: int,
                      weight: Optional[str] = None):
        """M distinct heatmaps in one call (None = ineligible). Unweighted
        grids equal the serial :meth:`density` (exact integer cells);
        weighted grids add the same values per cell."""
        got = self.density_batch_partial(plans, spec, bboxes, width, height, weight)
        return None if got is None else self.decode_density_batch(
            got, len(plans), width, height)

    @staticmethod
    def decode_density_batch(got, n: int, width: int, height: int):
        """One :meth:`density_batch_partial` result as per-member host f32
        grids."""
        out, corrs = got
        arrs = _host_list(out, n)
        grids = []
        for m in range(n):
            g = np.zeros((height, width), np.float32) if arrs[m] is None else arrs[m]
            if corrs[m] is not None:
                g = g + np.asarray(corrs[m], np.float32)
            grids.append(g)
        return grids

    def stats_batch_partials(self, plans, spec, stats):
        """``(partials,)``: each member's device partial states (None for an
        empty member, or ``(None,)`` for an empty batch); None when
        ineligible: a descriptive leaf (layout-dependent f32 sums), a leaf
        without a device reduction, or a member with surviving band rows
        (its serial scan runs on the host)."""
        check_deadline()
        if any(not kstats.batch_supported(s) for s in stats):
            return None
        bundle = self._stats_bundle(plans[0], stats[0])
        if bundle is None:
            return None
        agg_cols, vocab = bundle
        bs = self._batch_setups(plans, spec, agg_cols)
        if bs is None:
            return None
        if bs["empty"]:
            return (None,)
        if self._batch_band_rows(plans, bs):
            return None
        return (self._batch_device_agg(
            plans, spec, bs, _member_stats, agg_cols, "stats_batch",
            key_extras=(_stat_signature(stats[0]),), extra=(stats, vocab)),)

    def stats_batch(self, plans, spec, stats):
        """M distinct stats scans in one call (None = ineligible); fills and
        returns ``stats`` in member order."""
        got = self.stats_batch_partials(plans, spec, stats)
        if got is None:
            return None
        self.absorb_stats_batch(got, stats, self.store.dicts)
        return stats

    @staticmethod
    def absorb_stats_batch(got, stats, dicts) -> None:
        """Fold one :meth:`stats_batch_partials` result into the members'
        Stat objects, in member order."""
        (out,) = got
        if out is None:
            return
        for st, part in zip(stats, out):
            if part is not None:
                kstats.absorb_partials(st, part, dicts)

    # -- features --------------------------------------------------------------
    def _mask_positions(self, setup, m) -> np.ndarray:
        """Device mask -> the sorted-order positions it keeps: the bool mask
        comes back ([C, B] compact or [S, L] padded) and expands on the
        host. Compact chunks are in global row order, so the positions
        ascend as on the padded layout."""
        flat = np.flatnonzero(m.cpu().numpy())
        d = setup["compact"]
        if d is not None:
            flat = d["cstart"].astype(np.int64)[flat // d["B"]] + flat % d["B"]
        return self._positions(setup, flat)

    def features(self, plan: QueryPlan) -> ColumnBatch:
        """Matching rows as a host ColumnBatch in table order (the caller
        sorts and limits). With a projection, only the listed properties
        (and the sort keys) gather. The path goes to
        ``exec_path['feature_scan']``: the reference's feature scan records
        none, so ``scan`` keeps what a top-k selection before it recorded."""
        names = None
        if plan.hints.properties:
            names = list(plan.hints.properties) + [
                a for a, _ in (plan.hints.sort_by or [])]
        # as the reference's, a device feature scan is no deadline site (a
        # partitioned store checks per partition); its host paths check
        pos = self._run(plan, (), _coarse_agg, lambda rows, pos: pos,
                        additive=False, path_key="feature_scan", deadline=False, device_sync=self._mask_positions, host_span=False,
                        cache_key=("mask",))
        if pos is None:
            return ColumnBatch({}, 0)
        return self._table(plan).gather_sorted(pos, names)

    def features_iter(self, plan: QueryPlan, batch_rows: Optional[int] = None):
        """Matching rows as ColumnBatch chunks of at most ``batch_rows``
        (default :data:`BATCH_ROWS`): one table materializes its result
        once and re-slices it. ``max_features`` truncates unsorted
        results."""
        batch_rows = batch_rows or BATCH_ROWS
        out = self.features(plan)
        n = out.n
        if plan.hints.max_features is not None and not plan.hints.sort_by:
            n = min(n, plan.hints.max_features)
        for lo in range(0, n, batch_rows):
            hi = min(lo + batch_rows, n)
            yield ColumnBatch({k: v[lo:hi] for k, v in out.columns.items()}, hi - lo)

    # -- top-k ---------------------------------------------------------------
    def top_rows(self, plan: QueryPlan, attr: str, descending: bool, k: int,
                 include_ties: bool = False) -> Optional[np.ndarray]:
        """Sorted-order positions of a superset of the top-k matches by one
        attribute: the device half of a sorted, limited query. The caller
        gathers them and sorts exactly on the host. None where the host
        must sort everything, by the reference's design: a column that
        cannot rank on the device (strings, host-only, bool), fewer than k
        non-NaN candidates, or a tie group overflowing the threshold
        buffer.

        A native f32 column with k <= 32 and no tie inclusion takes the k
        smallest keys in (key, row) order, the reference's argmin
        iteration; otherwise :meth:`_top_rows_threshold`."""
        table = self._table(plan)
        if (not table.has_column(attr) or table.is_host_only(attr)
                or attr in self.store.dicts or table.dtype_of(attr) == np.bool_):
            return None
        if include_ties or table.dtype_of(attr) != np.float32 or k > 32:
            return self._top_rows_threshold(plan, attr, descending, k)

        def device_agg(setup, cols, m):
            v = cols[attr].reshape(-1).to(torch.float32)
            # NaN keys never rank (argmin would take them first); a result
            # left short of k sends the query to the host sort
            ok = m.reshape(-1) & ~torch.isnan(v)
            d = torch.where(ok, -v if descending else v, float("inf"))
            flat = kknn.lowest_k(d, k)
            vals = -d[flat] if descending else d[flat]
            return Executor._positions(setup, flat.cpu().numpy()), vals.cpu().numpy()

        def host_agg(rows, pos):
            v = rows[attr].astype(np.float64)
            v = v if descending else -v
            idx = np.argsort(-v, kind="stable")[:k]
            return pos[idx], v[idx]

        out = self._run(plan, [attr], device_agg, host_agg, additive=False,
                        compactable=False,
                        cache_key=("top", attr, bool(descending), int(k)))
        if out is None:
            return np.zeros(0, np.int64)
        pos, vals = out
        pos = pos[np.isfinite(vals)].astype(np.int64)
        return pos if len(pos) >= k else None

    def _top_rows_threshold(self, plan: QueryPlan, attr: str, descending: bool,
                            k: int) -> Optional[np.ndarray]:
        """Threshold top-k (see :meth:`top_rows`): the smallest f32 key t
        with at least k keys <= t by 48 halvings of ``(lo + hi) * 0.5``,
        each a masked count, all on the device; then the rows with keys
        <= t, in row order, into a buffer of k + ``geomesa.topk.tie-slack``.
        f64 and int columns rank at f32, whose monotone rounding keeps the
        selection a superset; the host sort restores exact order."""
        slack = config.TOPK_TIE_SLACK.to_int()
        if slack is None:
            slack = int(config.TOPK_TIE_SLACK.default)
        B = int(k + slack)

        def device_agg(setup, cols, m):
            v = cols[attr].reshape(-1).to(torch.float32)
            key = -v if descending else v
            ok = m.reshape(-1) & ~torch.isnan(v)
            inf = torch.full((), float("inf"), dtype=torch.float32, device=v.device)
            kv = torch.where(ok, key, inf)
            n_ok = ok.sum()
            lo = kv.min()
            hi = torch.where(ok, key, -inf).max()
            for _ in range(48):
                mid = (lo + hi) * 0.5
                ge = (kv <= mid).sum() >= k
                lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
            t = torch.where(n_ok <= k, inf, hi)  # few matches: take all
            flat = torch.nonzero(ok & (kv <= t)).reshape(-1)
            return Executor._positions(setup, flat[:B].cpu().numpy()), flat.numel()

        def host_agg(rows, pos):
            v = rows[attr].astype(np.float64)
            ok = ~np.isnan(v)
            key = np.where(ok, -v if descending else v, np.inf)
            n_ok = int(ok.sum())
            if n_ok == 0:
                return pos[:0], 0
            kk = min(k, n_ok)
            t = np.partition(key, kk - 1)[kk - 1]
            sel = np.nonzero(key <= t)[0]
            return pos[sel[:B]], len(sel)

        out = self._run(plan, [attr], device_agg, host_agg, additive=False,
                        compactable=False,
                        cache_key=("topt", attr, bool(descending), int(k), B))
        if out is None:
            return np.zeros(0, np.int64)
        pos, cnt = out
        if cnt > B or cnt < k:
            # the tie group overflowed the buffer, or NaN-keyed matches
            # (which sort last but still fill an under-filled result) were
            # left out: the host sorts
            return None
        return pos.astype(np.int64)

    # -- stats ---------------------------------------------------------------
    def _stats_bundle(self, plan: QueryPlan, stat: sk.Stat):
        """(agg_cols, vocab_sizes) when every leaf of ``stat`` reduces on
        the device over this table, else None (the gather path serves)."""
        table = self._table(plan)
        host_only = {c for c in table.column_names() if table.is_host_only(c)}
        vocab_sizes = {a: max(len(d), 1) for a, d in self.store.dicts.items()}
        leaves = kstats.leaf_stats(stat)
        attrs = []
        for leaf in leaves:
            if isinstance(leaf, sk.DescriptiveStats):
                attrs.extend(leaf.attributes)
            elif getattr(leaf, "attribute", None) is not None:
                attrs.append(leaf.attribute)
        agg_cols = []
        for a in attrs:
            if table.has_column(a + "__x"):
                agg_cols += [a + "__x", a + "__y"]
            elif table.has_column(a):
                agg_cols.append(a)
        enum_ok = all(leaf.attribute in self.store.dicts for leaf in leaves
                      if leaf.kind in ("enumeration", "topk"))
        if not (kstats.device_supported(stat, host_only) and enum_ok):
            return None
        return agg_cols, vocab_sizes

    def stats_partials(self, plan: QueryPlan, stat: sk.Stat):
        """``(supported, partials)``: the partial states of ``stat`` over the
        matches, without touching ``stat``. ``supported`` is False where a
        leaf has no device reduction (the gather path serves); ``partials``
        is None for an empty scan."""
        bundle = self._stats_bundle(plan, stat)
        if bundle is None:
            return False, None
        agg_cols, vocab = bundle
        return True, self._run(
            plan, agg_cols,
            lambda setup, cols, m: kstats.device_update(stat, cols, m, vocab),
            lambda rows, pos: kstats.device_update_np(
                stat, rows, np.ones(len(pos), bool), vocab),
            additive=False,
        )

    def stats(self, plan: QueryPlan, stat: sk.Stat) -> sk.Stat:
        """Fill ``stat`` with the matches' statistics: device partial
        states in the scan where every leaf has a device reduction, else
        the host observes the gathered matches (Frequency, GroupBy,
        Z3Frequency, enumerations of non-dictionary columns)."""
        supported, partials = self.stats_partials(plan, stat)
        if not supported:
            batch = self.features(plan)
            if batch.n:
                stat.observe(batch.columns)
                kstats.decode_enum_keys(stat, self.store.dicts)
            return stat
        if partials is not None:
            kstats.absorb_partials(stat, partials, self.store.dicts)
        return stat

    # -- kNN -----------------------------------------------------------------
    def knn(self, plan: QueryPlan, qx: float, qy: float, k: int, boxes=None):
        """(sorted-order positions, f32 metres) of the k nearest matches to
        (qx, qy), nearest first. ``boxes``: up to two (x0, y0, x1, y1)
        restriction boxes, rounded outward at f32 (a nearest-rounded bound
        could shrink the box half an ulp and drop an edge neighbour the
        caller's f64 exactness test counts as searched)."""
        geom = self.store.ft.geom_field
        xc, yc = geom + "__x", geom + "__y"
        q32 = (np.float32(qx), np.float32(qy))
        down, up = np.float32(-np.inf), np.float32(np.inf)
        bb = [(np.nextafter(np.float32(x0), down), np.nextafter(np.float32(y0), down),
               np.nextafter(np.float32(x1), up), np.nextafter(np.float32(y1), up))
              for x0, y0, x1, y1 in (boxes or ())]

        def in_boxes(x, y, boxes):
            inb = None
            for x0, y0, x1, y1 in boxes:
                mi = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
                inb = mi if inb is None else (inb | mi)
            return inb

        def device_agg(setup, cols, m, qx_, qy_, boxes):
            # the query point and boxes are call operands: one callable
            # serves every origin and radius
            if boxes:
                m = m & in_boxes(cols[xc], cols[yc], boxes)
            idx, d = kknn.knn_indices(cols[xc], cols[yc], m, qx_, qy_, k)
            return Executor._positions(setup, idx.cpu().numpy()), d.cpu().numpy()

        def host_agg(rows, pos):
            m = np.ones(len(pos), bool)
            if bb:
                m &= in_boxes(rows[xc], rows[yc], bb)
            idx, d = kknn.knn_indices_np(rows[xc], rows[yc], m, *q32, k)
            return pos[idx], d

        out = self._run(plan, [xc, yc], device_agg, host_agg, additive=False,
                        compactable=False,
                        cache_key=("knn", int(k), len(bb)), extra=(*q32, bb))
        if out is None:
            return np.zeros(0, np.int64), np.zeros(0)
        pos, d = out
        keep = np.isfinite(d)
        return pos[keep], d[keep]
