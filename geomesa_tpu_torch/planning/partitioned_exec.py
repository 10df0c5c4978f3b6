"""Partition-at-a-time query execution over a PartitionedFeatureStore.

Port of ``geomesa_tpu/planning/partitioned_exec.py`` on one card: prune the
time partitions by the plan's time bounds, stream each pruned partition
through host memory and the device (reloading spilled ones, evicting over
the budget), run an ordinary :class:`Executor` on it, and merge the
partials in pruned-bin order: counts as exact host integers, density grids
on the device through :class:`TreeReducer` (the JAX package's association),
stats by absorbing each partition in turn, features, top-k candidates and
kNN candidates by concatenation.

The prefetch pipeline keeps the reference's bound: one worker thread, one
partition in flight, consumed in pruned-bin order. While partition i runs,
the worker loads partition i+1 and stages the columns the plan reads
(``IndexTable.stage_host``); on a CUDA card they are stacked into pinned
buffers of a reused pool and copied on a side stream, and the query thread
waits on each copy's event before it reads the column. A host error while
staging is dropped (the scan stacks the column itself); CUDA errors and
load errors reach the query thread, where the sequential load would have
raised.

The degradation contract (``resilience``): each partition's scan passes
the ``exec.partition.scan`` fault point. Strict mode (the default)
re-raises a failing load, staging or scan. Under
``resilience.allow_partial()`` or ``geomesa.scan.partial`` the partition
is recorded (the collector, and ``plan.degraded``) and skipped, so every
additive answer is exact over the surviving partitions, merged in the same
pruned-bin order; under partial mode ``features_iter`` materializes each
partition before it yields, so a failing partition drops whole. A
``QueryTimeoutError`` always propagates: the deadline is checked per
partition, and a timed-out scan is never reported as a degraded one.

``density_curve`` merges host f64 grids; the query-axis batches scan the
members' pruned-bin union once, one batched pass per partition, and merge
each member's partials in the same order.

Lake pushdown (``geomesa.lake.pushdown``): the ops whose merge is exact
over any superset of the matching rows (count, unweighted density and
``density_curve``, stats) and the join's side scans (``features_pushdown``)
hand the plan's point box and time interval to
``PartitionedFeatureStore.scan_child``, so a spilled lake partition loads
only the row groups whose statistics meet them, as an ephemeral child that
rides the same pipeline and whose device columns are freed after its scan.
``exec_path["lake"]`` and ``plan.lake_acct`` sum the groups and bytes
loaded; ``exec_path["lake_fallback"]`` counts the partitions that loaded
whole, by reason. Weighted density keeps full loads (a NaN weight on a
pruned non-matching row could still reach the grid), as the reference's
does, and extent schemas push down only their time interval.

Under tracing, each partition's scan opens a ``scan.partition`` span
(``part``, ``op``) and the worker stages under ``scan.stage`` spans, in
the query's tree (the worker adopts the query thread's span). The cost
ledger takes ``partitions_scanned`` / ``partitions_pruned`` per scan,
``bytes_staged`` per staging, and ``lake_bytes_read`` /
``lake_bytes_skipped`` per pruned load.

Not ported yet (ROADMAP Queue 1): the multi-device sharded scan.
"""

from __future__ import annotations

import queue
import threading
from contextlib import closing
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config, metrics, resilience, tracing
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index.partitioned import PartitionedFeatureStore
from geomesa_tpu_torch.index.staging import Uploader
from geomesa_tpu_torch.kernels import stats_scan as kstats
from geomesa_tpu_torch.kernels.registry import KernelRegistry
from geomesa_tpu_torch.parallel.devices import TreeReducer
from geomesa_tpu_torch.planning.executor import Executor
from geomesa_tpu_torch.planning.planner import QueryPlan
from geomesa_tpu_torch.resilience import QueryTimeoutError, check_deadline
from geomesa_tpu_torch.schema.columns import ColumnBatch
from geomesa_tpu_torch.stats import sketches as sk

#: exec_path entries a child executor writes per partition
_PART_KEYS = ("scan", "feature_scan", "B", "band_rows", "density_kernel", "sampling")

#: a partition's scan degraded away (the scan itself may return None)
_SKIPPED = object()


def _coalesce_boxes(boxes: List[Tuple[float, float, float, float]]
                    ) -> List[Tuple[float, float, float, float]]:
    """Merge boxes whose union is a box (up to one float ulp): equal
    y-spans whose x-ranges touch, overlap or sit one ulp apart, then the
    same for columns of equal x-span. Closing an ulp seam only widens the
    cover, which is safe for pruning (a row group is pruned only when
    disjoint from every box)."""
    def _pass(bs, flip):
        def key(b):
            return (b[1], b[3], b[0]) if not flip else (b[0], b[2], b[1])

        bs = sorted(bs, key=key)
        out = [bs[0]]
        for b in bs[1:]:
            p = out[-1]
            if not flip and p[1] == b[1] and p[3] == b[3] \
                    and b[0] <= np.nextafter(p[2], np.inf):
                out[-1] = (p[0], p[1], max(p[2], b[2]), p[3])
            elif flip and p[0] == b[0] and p[2] == b[2] \
                    and b[1] <= np.nextafter(p[3], np.inf):
                out[-1] = (p[0], p[1], p[2], max(p[3], b[3]))
            else:
                out.append(b)
        return out

    if len(boxes) < 2:
        return boxes
    return _pass(_pass(boxes, flip=False), flip=True)


class PartitionedExecutor:
    """The Executor surface over a partitioned store. ``compact_min_rows``
    and ``compact_fraction`` go to every child's executor; ``prefetch``
    turns the pipeline's worker on or off, with the same results (unset,
    ``geomesa.pipeline.prefetch`` decides at each call)."""

    def __init__(self, store: PartitionedFeatureStore,
                 compact_min_rows: Optional[int] = None,
                 compact_fraction: Optional[float] = None):
        self.store = store
        self.device = store.device
        self.compact_min_rows = compact_min_rows
        self.compact_fraction = compact_fraction
        self._prefetch: Optional[bool] = None
        self._execs: Dict[int, Executor] = {}
        self._uploader: Optional[Uploader] = None

    def kernel_registry(self) -> KernelRegistry:
        """The scan-callable registry every partition child shares (it lives
        on this store: children key their callables without a version, so
        one build serves every partition of a bucketed shape)."""
        reg = self.store.__dict__.get("_kernel_registry")
        if reg is None:
            reg = self.store.__dict__["_kernel_registry"] = KernelRegistry()
        return reg

    @property
    def prefetch(self) -> bool:
        if self._prefetch is None:
            return bool(config.PIPELINE_PREFETCH.to_bool())
        return self._prefetch

    @prefetch.setter
    def prefetch(self, on: Optional[bool]) -> None:
        self._prefetch = on

    @property
    def uploader(self) -> Optional[Uploader]:
        """The side-stream uploader of a CUDA store (None on the CPU)."""
        if self._uploader is None and self.device.type == "cuda":
            self._uploader = Uploader(self.device)
        return self._uploader

    # -- partition pruning ----------------------------------------------------
    def prune(self, plan: QueryPlan) -> List[int]:
        """The partitions ``plan`` can match, in bin order: the z3 plan's
        bins when the partition period is the z3 interval, else the bins
        of the filter's time intervals; every partition without a bound."""
        store = self.store
        bins = store.partition_bins()
        if plan.is_empty:
            return []
        kp = plan.key_plan
        if kp.bins is not None and store.partition_period == store.ft.time_period:
            sel = {int(x) for x in np.asarray(kp.bins).ravel()}
            return [b for b in bins if b in sel]
        dtg = store.ft.dtg_field
        iv = ir.extract_intervals(plan.filter, dtg)
        if not iv.is_empty:
            sel = set()
            for lo, hi in iv.values:
                if lo is None or hi is None:
                    return bins
                sel.update(int(x) for x in store.binned.bins_between(int(lo), int(hi)))
            return [b for b in bins if b in sel]
        return bins

    def _executor_for(self, b: int, child) -> Executor:
        ex = self._execs.get(b)
        if ex is None or ex.store is not child:
            ex = self._execs[b] = Executor(
                child, compact_min_rows=self.compact_min_rows,
                compact_fraction=self.compact_fraction, version_source=self.store,
            )
        return ex

    # -- lake row-group pushdown ------------------------------------------------
    def _push_window(self, plan: QueryPlan) -> Optional[Dict]:
        """The plan's bounds as a pruning window, or None when pushdown
        cannot engage: the knob is off, the plan samples (the 1-in-n
        counter depends on the row set), or the filter bounds neither the
        point geometry nor the date. A row group disjoint from every
        extracted bound holds no matching row."""
        if not config.LAKE_PUSHDOWN.to_bool():
            return None
        h = plan.hints
        if h.sampling is not None or h.sample_by is not None:
            return None
        ft = self.store.ft
        boxes = times = None
        geom = ft.geom_field
        if geom is not None and ft.attr(geom).is_point:
            fv = ir.extract_geometries(plan.filter, geom)
            if fv.disjoint:
                boxes = []
            elif not fv.is_empty:
                boxes = _coalesce_boxes([tuple(float(v) for v in g.bounds())
                                         for g in fv.values])
        dtg = ft.dtg_field
        if dtg is not None:
            iv = ir.extract_intervals(plan.filter, dtg)
            if iv.disjoint:
                times = []
            elif not iv.is_empty:
                inf = float("inf")
                times = [(-inf if lo is None else float(lo), inf if hi is None else float(hi))
                         for lo, hi in iv.values]
        if boxes is None and times is None:
            return None
        window = {"index": plan.index_name, "boxes": boxes, "times": times}
        # the join's chunk loop plants one residency cache on each side plan
        residency = plan.__dict__.get("residency")
        if residency is not None:
            window["residency"] = residency
        return window

    def _get_child(self, b: int, window: Optional[Dict]):
        """The partition's child for the scan: pruned to ``window`` when one
        is pushed down, the ordinary resident load otherwise."""
        if window is not None:
            return self.store.scan_child(b, window)
        return self.store.child(b)

    @staticmethod
    def _note_lake(plan: QueryPlan, note: Dict[str, int]) -> None:
        """Add one pruned load's account to ``plan.lake_acct`` and
        ``exec_path["lake"]`` (on the query thread)."""
        acct = plan.__dict__.setdefault("lake_acct", {
            "groups_total": 0, "groups_loaded": 0, "groups_pruned": 0,
            "bytes_payload": 0, "bytes_loaded": 0, "bytes_skipped": 0,
        })
        for k in acct:
            acct[k] += int(note.get(k, 0))
        plan.__dict__.setdefault("exec_path", {})["lake"] = (
            f"{acct['groups_loaded']}/{acct['groups_total']} rowgroups, "
            f"{acct['bytes_loaded']}/{acct['bytes_payload']} bytes"
        )
        tracing.add_cost("lake_bytes_read", float(note["bytes_loaded"]))
        tracing.add_cost("lake_bytes_skipped", float(note["bytes_skipped"]))
        metrics.inc(metrics.LAKE_PUSHDOWN_SCANS)

    @staticmethod
    def _note_pushdown_fallbacks(plan: QueryPlan, window: Optional[Dict]) -> None:
        """``exec_path["lake_fallback"]``: the partitions pushdown could not
        serve pruned, by reason, so a full load never reads as pruned."""
        fallbacks = window.get("fallbacks") if window else None
        if not fallbacks:
            return
        reasons: Dict[str, int] = {}
        for _b, reason in fallbacks:
            reasons[reason] = reasons.get(reason, 0) + 1
        plan.__dict__.setdefault("exec_path", {})["lake_fallback"] = (
            f"{len(fallbacks)} partition(s) full-loaded: "
            + ", ".join(f"{r} x{n}" for r, n in sorted(reasons.items()))
        )

    # -- the prefetch pipeline -------------------------------------------------
    def _stage(self, child, plan: QueryPlan) -> None:
        """The worker's half: stage the columns the plan's scan read on the
        previous partition (none before the first scan)."""
        names = plan.__dict__.get("needed_cols")
        if child is None or not names:
            return
        t = child.tables.get(plan.index_name)
        if t is not None and t.n:
            staged = t.stage_host(names, self.uploader)
            if staged:
                # the worker adopted the query's span, so the bytes land on
                # the query's cost ledger
                tracing.add_cost("bytes_staged", float(staged))
            metrics.inc(metrics.PIPELINE_PREFETCH)

    @staticmethod
    def _free_staging(child, plan: QueryPlan) -> None:
        """After a partition's scan (or a prefetch never run): free what
        was staged for it, and every device column of an ephemeral pruned
        child, which no later query can reuse."""
        if child.lake_note is not None:
            child.drop_device()
            return
        t = child.tables.get(plan.index_name)
        if t is not None:
            t._host_stage.clear()

    def _pipeline(self, plan: QueryPlan, bins: List[int], window: Optional[Dict] = None):
        """(bin, child) over ``bins`` in order; with a pushdown ``window``
        a spilled lake partition may come as an ephemeral pruned child. With
        prefetch on and two or more bins, one worker loads and stages the
        next partition while the caller runs the current one (one partition
        in flight); a load error re-raises here, where a sequential load
        would have raised. An early exit joins the worker and frees what it
        staged. Lake accounts are noted here, on the query thread. The
        worker adopts the query thread's config overrides and span, and
        stages each partition under a ``scan.stage`` span."""
        # the cost ledger: the partition pruning of this scan
        total_bins = len(self.store.partition_bins())
        tracing.add_cost("partitions_scanned", float(len(bins)))
        tracing.add_cost("partitions_pruned", float(max(total_bins - len(bins), 0)))
        if len(bins) < 2 or not self.prefetch:
            for b in bins:
                try:
                    child = self._get_child(b, window)
                except BaseException as e:
                    self._contain(plan, b, e, "index.spill.load", "load")
                    continue
                if child is not None and child.lake_note is not None:
                    self._note_lake(plan, child.lake_note)
                yield b, child
            return
        out: "queue.Queue" = queue.Queue()
        stop = threading.Event()
        slot = threading.Semaphore(0)  # one permit per granted load
        ov = config.snapshot_overrides()
        tspan = tracing.snapshot()

        def worker():
            # the worker resolves every knob as the query thread does, and
            # its spans nest under the query's tree
            config.adopt_overrides(ov)
            tracing.adopt(tspan)
            try:
                for b in bins:
                    while not slot.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    child = err = None
                    where = ("index.spill.load", "load")
                    try:
                        child = self._get_child(b, window)
                    except BaseException as e:  # contained on the query thread
                        err = e
                    if err is None and child is not None:
                        where = ("exec.partition.scan", "stage")
                        try:
                            with tracing.span("scan.stage", part=int(b)):
                                self._stage(child, plan)
                        except BaseException as e:  # CUDA errors included
                            err = e
                    out.put((b, child, err, where))
            finally:
                out.put(None)

        t = threading.Thread(target=worker, daemon=True, name="geomesa-part-prefetch")
        t.start()
        slot.release()  # the first load starts now
        try:
            while True:
                item = out.get()
                if item is None:
                    return
                # grant the next load: it overlaps this partition's run
                slot.release()
                b, child, err, where = item
                if err is not None:
                    if child is not None:
                        self._free_staging(child, plan)
                    self._contain(plan, b, err, *where)
                    continue
                if child is not None and child.lake_note is not None:
                    self._note_lake(plan, child.lake_note)
                yield b, child
        finally:
            stop.set()
            if t is not threading.current_thread():  # a finalizer may run here
                t.join()
            # free what was staged for partitions never run
            while True:
                try:
                    item = out.get_nowait()
                except queue.Empty:
                    break
                if item is not None and item[1] is not None:
                    self._free_staging(item[1], plan)

    def _each(self, plan: QueryPlan, bins: Optional[List[int]] = None,
              window: Optional[Dict] = None) -> Iterator[Tuple[int, Executor]]:
        """(bin, executor) over the pruned partitions under the residency
        budget (``window``: see :meth:`_pipeline`). Sums the selectivity
        counters and records each partition's path in
        ``exec_path['partitions']``; after each partition its unused
        staging is freed (all of an ephemeral pruned child's device
        columns), the store evicts to its budget, and the executors (with
        their device caches) of children no longer resident go."""
        if bins is None:
            bins = self.prune(plan)
        path = plan.__dict__.setdefault("exec_path", {})
        path["partitions_pruned"] = len(self.store.partition_bins()) - len(bins)
        path["partitions_scanned"] = len(bins)
        parts = path["partitions"] = {}
        tot_scanned = tot_rows = 0
        pipe = self._pipeline(plan, bins, window)
        try:
            for b, child in pipe:
                check_deadline()
                if child is None or child.count == 0:
                    continue
                plan.__dict__.pop("scanned_rows", None)
                plan.__dict__.pop("table_rows", None)
                for k in _PART_KEYS:
                    path.pop(k, None)
                yield b, self._executor_for(b, child)
                tot_scanned += plan.__dict__.pop("scanned_rows", 0)
                tot_rows += plan.__dict__.pop("table_rows", 0)
                parts[b] = {k: path[k] for k in _PART_KEYS if path.get(k) is not None}
                self._free_staging(child, plan)
                self.store.evict()
                resident = self.store.partitions
                for bb in list(self._execs):
                    if self._execs[bb].store is not resident.get(bb):
                        del self._execs[bb]
        finally:
            # the worker stops on this thread, not at some later collection
            pipe.close()
            # an early exit closes the generator at the yield: fold in the
            # counters of the partition that was running
            plan.__dict__["scanned_rows"] = tot_scanned + plan.__dict__.get("scanned_rows", 0)
            plan.__dict__["table_rows"] = tot_rows + plan.__dict__.get("table_rows", 0)

    def _pushed(self, plan: QueryPlan, push: bool = True) -> Iterator[Tuple[int, Executor]]:
        """:meth:`_each` with the plan's pushdown window (when ``push``),
        noting the fallbacks once the scan ends."""
        window = self._push_window(plan) if push else None
        try:
            yield from self._each(plan, window=window)
        finally:
            self._note_pushdown_fallbacks(plan, window)

    # -- the degradation contract ------------------------------------------------
    @staticmethod
    def _contain(plan: QueryPlan, b: int, err: BaseException, source: str,
                 phase: str) -> None:
        """A partition that failed before its scan (a spill load, or the
        prefetch's staging): under ``allow_partial()`` it is recorded in the
        collector and ``plan.degraded`` and skipped; strict mode, a
        deadline and any non-``Exception`` re-raise here, where the
        sequential load would have raised."""
        if isinstance(err, QueryTimeoutError) or not isinstance(err, Exception) \
                or not resilience.partial_allowed():
            raise err
        rec = resilience.record_skip(source, f"bin:{b}", err, phase=phase)
        plan.__dict__.setdefault("degraded", []).append(rec)

    @staticmethod
    def _scan_part(plan: QueryPlan, b: int, op: str, fn, probe: bool = True):
        """``fn()``, one partition's scan (or, ``probe=False``, the merge of
        its partial, where a device error surfaces at the sync) under the
        degradation contract: strict mode re-raises; under
        ``allow_partial()`` / ``geomesa.scan.partial`` a failure is recorded
        and :data:`_SKIPPED` returned. The ``exec.partition.scan`` fault
        point fires once a partition, before its scan."""
        try:
            if not probe:
                return fn()
            resilience.fault_point("exec.partition.scan", bin=b, op=op)
            with tracing.span("scan.partition", part=int(b), op=op):
                return fn()
        except QueryTimeoutError:
            raise
        except Exception as e:
            if not resilience.partial_allowed():
                raise
            rec = resilience.record_skip("exec.partition.scan", f"bin:{b}", e, phase=op)
            plan.__dict__.setdefault("degraded", []).append(rec)
            return _SKIPPED

    def _additive(self, plan: QueryPlan, op: str, parts, dispatch, finish) -> None:
        """Each partition of ``parts`` ((bin, executor) in pruned-bin order):
        ``dispatch(ex)``, then ``finish(partial)`` unless the partition was
        skipped or empty, both under :meth:`_scan_part`, so the merge sees
        the survivors in pruned-bin order. A raise closes ``parts`` (and
        its prefetch worker) here."""
        with closing(parts):
            for b, ex in parts:
                r = self._scan_part(plan, b, op, lambda: dispatch(ex))
                if r is not _SKIPPED and r is not None:
                    self._scan_part(plan, b, op, lambda: finish(r), probe=False)

    # -- additive operations -----------------------------------------------------
    def count(self, plan: QueryPlan) -> int:
        """Exact host integers, summed in pruned-bin order."""
        totals: List[int] = []
        self._additive(plan, "count", self._pushed(plan),
                       lambda ex: ex.count_partial(plan), lambda p: totals.append(int(p)))
        return sum(totals)

    def density(self, plan: QueryPlan, bbox, width: int, height: int,
                weight: Optional[str] = None) -> np.ndarray:
        """Per-partition grids merged on the device by :class:`TreeReducer`
        (the reference's association: unweighted grids are exact, weighted
        ones add in the same order), then one copy to the host."""
        red = TreeReducer(lambda a, b: a + b)
        self._additive(plan, "density", self._pushed(plan, push=weight is None),
                       lambda ex: ex.density(plan, bbox, width, height, weight, as_numpy=False),
                       red.push)
        out = red.result()
        return np.zeros((height, width), np.float32) if out is None else out.cpu().numpy()

    def stats(self, plan: QueryPlan, stat: sk.Stat) -> sk.Stat:
        """Each partition's scan absorbs into ``stat`` in pruned-bin order
        (sketches observe only matching rows, so pushdown is exact)."""
        with closing(self._pushed(plan)) as each:
            for b, ex in each:
                self._scan_part(plan, b, "stats", lambda: ex.stats(plan, stat))
        return stat

    # -- curve-aligned density -------------------------------------------------
    @staticmethod
    def _curve_zeros(block_window) -> np.ndarray:
        ix0, iy0, ix1, iy1 = block_window
        return np.zeros((iy1 - iy0 + 1, ix1 - ix0 + 1), np.float64)

    def density_curve(self, plan: QueryPlan, level: int, block_window,
                      weight: Optional[str] = None) -> np.ndarray:
        """Each partition's host f64 grid, reduced in pruned-bin tree order
        (integer counts are exact to 2^53)."""
        red = TreeReducer(lambda a, b: a + b)
        self._additive(plan, "density_curve", self._pushed(plan, push=weight is None),
                       lambda ex: ex.density_curve_raw(plan, level, block_window, weight),
                       lambda p: red.push(Executor.decode_curve(p)))
        out = red.result()
        return self._curve_zeros(block_window) if out is None else out

    @staticmethod
    def _member_reducer() -> TreeReducer:
        """A tree reduction over per-partition member lists: elementwise, so
        each member's association is that of its own tree merge."""
        return TreeReducer(lambda A, B: [a + b for a, b in zip(A, B)])

    def _curve_grids(self, merged, block_windows):
        return [self._curve_zeros(bw) if merged is None else merged[i]
                for i, bw in enumerate(block_windows)]

    def density_curve_batch(self, plan: QueryPlan, level: int, block_windows,
                            weight: Optional[str] = None):
        """Crops of one filter: each pruned partition runs one shared scan
        for every crop, and per-crop grids tree-merge across partitions."""
        red = self._member_reducer()
        self._additive(plan, "density_curve", self._each(plan),
                       lambda ex: ex.density_curve_batch_raw(plan, level, block_windows, weight),
                       lambda p: red.push(Executor.decode_curve_batch(p)))
        return self._curve_grids(red.result(), block_windows)

    def density_curve_filter_batch(self, plans: List[QueryPlan], spec, level: int,
                                   block_windows, weight: Optional[str] = None):
        """Distinct-filter crops over the members' pruned-bin union, one
        batched pass per partition (None = ineligible). A partition where
        the batch is ineligible (surviving f32 band rows there) runs its
        members' serial curves instead; the other partitions keep the
        batch."""
        bins = self._union_bins(plans)
        if not self._batch_ok(plans, spec, bins, [weight] if weight else []):
            return None
        red = self._member_reducer()

        def dispatch(ex):
            r = ex.density_curve_filter_batch_raw(plans, spec, level, block_windows, weight)
            if r is None:
                return [Executor.decode_curve(ex.density_curve_raw(p, level, bw, weight))
                        for p, bw in zip(plans, block_windows)]
            return Executor.decode_curve_filter_batch(r)

        self._additive(plans[0], "density_curve", self._each(plans[0], bins), dispatch, red.push)
        return self._curve_grids(red.result(), block_windows)

    # -- query-axis batches: each pruned partition runs one batched pass for
    # every member, and per-member partials merge in the serial path's
    # pruned-bin order. -----------------------------------------------------
    def _union_bins(self, plans: List[QueryPlan]) -> List[int]:
        """The members' pruned-bin union, in partition order. A bin outside
        a member's own pruning gives that member an empty window set there:
        a zero partial, the additive identity."""
        sel = set()
        for p in plans:
            sel.update(self.prune(p))
        return [b for b in self.store.partition_bins() if b in sel]

    def _batch_ok(self, plans: List[QueryPlan], spec, bins: List[int],
                  agg_cols=()) -> bool:
        """Batch eligibility, decided on the first non-empty partition of
        ``bins`` (children share the schema, dictionaries and column
        layout). ``agg_cols`` are the op's aggregate columns: a host-only
        one makes the batch ineligible."""
        for b in bins:
            child = self.store.child(b)
            if child is None or child.count == 0:
                continue
            return self._executor_for(b, child)._batch_setups(plans, spec, agg_cols) is not None
        return True  # nothing to scan: zeros for every member

    def count_batch(self, plans: List[QueryPlan], spec):
        """M distinct counts, one batched pass per pruned partition (None =
        ineligible)."""
        bins = self._union_bins(plans)
        if not self._batch_ok(plans, spec, bins):
            return None
        totals = [0] * len(plans)

        def dispatch(ex):
            r = ex.count_batch_partial(plans, spec)
            if r is None:
                # eligibility holds for every partition (checked above): a
                # None here would drop the partition's counts
                raise RuntimeError("batched count ineligible mid-scan")
            return r

        def finish(r):
            for m, v in enumerate(Executor.decode_count_batch(r, len(plans))):
                totals[m] += v

        self._additive(plans[0], "count", self._each(plans[0], bins), dispatch, finish)
        return totals

    def density_batch(self, plans: List[QueryPlan], spec, bboxes, width: int,
                      height: int, weight: Optional[str] = None):
        """M distinct heatmaps (None = ineligible); per-member grids reduce
        across partitions in the serial path's tree order."""
        geom = self.store.ft.geom_field
        agg_cols = [geom + "__x", geom + "__y"] + ([weight] if weight else [])
        bins = self._union_bins(plans)
        if not self._batch_ok(plans, spec, bins, agg_cols):
            return None
        red = self._member_reducer()

        def dispatch(ex):
            r = ex.density_batch_partial(plans, spec, bboxes, width, height, weight)
            if r is None:
                raise RuntimeError("batched density ineligible mid-scan")
            return r

        self._additive(plans[0], "density", self._each(plans[0], bins), dispatch,
                       lambda r: red.push(Executor.decode_density_batch(
                           r, len(plans), width, height)))
        merged = red.result()
        if merged is None:
            return [np.zeros((height, width), np.float32) for _ in plans]
        return merged

    def stats_batch(self, plans: List[QueryPlan], spec, stats):
        """M distinct stats scans (None = ineligible): per-member partials
        absorb in pruned-bin order, each member's serial sequence. A
        partition whose band rows would send a member to the host makes
        the whole batch ineligible, and the remaining partitions are not
        scanned."""
        if any(not kstats.batch_supported(s) for s in stats):
            return None
        bins = self._union_bins(plans)
        if not self._batch_ok(plans, spec, bins):
            return None
        with closing(self._each(plans[0], bins)) as each:
            for b, ex in each:
                r = self._scan_part(plans[0], b, "stats",
                                    lambda: ex.stats_batch_partials(plans, spec, stats))
                if r is _SKIPPED:
                    continue
                if r is None:
                    return None
                self._scan_part(plans[0], b, "stats",
                                lambda: Executor.absorb_stats_batch(r, stats, self.store.dicts),
                                probe=False)
        return stats

    # -- features ---------------------------------------------------------------
    def features_iter(self, plan: QueryPlan, batch_rows: Optional[int] = None,
                      window: Optional[Dict] = None):
        """Matching rows partition at a time (peak memory is one
        partition's matches); ``max_features`` ends an unsorted stream.
        ``window``: a pushdown window (:meth:`_push_window`); the filter
        still runs on every loaded row, so the rows are exactly the
        plan's matches."""
        got = 0
        limit = plan.hints.max_features if not plan.hints.sort_by else None
        with closing(self._each(plan, window=window)) as each:
            for b, ex in each:
                if resilience.partial_allowed():
                    # materialize the partition before any yield, so a failing
                    # partition drops whole, never half-streamed
                    batches = self._scan_part(plan, b, "features",
                                              lambda: list(ex.features_iter(plan, batch_rows)))
                    if batches is _SKIPPED:
                        continue
                else:
                    # strict mode streams chunk at a time: max_features can end
                    # mid-partition
                    resilience.fault_point("exec.partition.scan", bin=b, op="features")
                    batches = ex.features_iter(plan, batch_rows)
                for batch in batches:
                    if not batch.n:
                        continue
                    if limit is not None:
                        if got >= limit:
                            return
                        if got + batch.n > limit:
                            keep = limit - got
                            yield ColumnBatch({k: v[:keep] for k, v in batch.columns.items()},
                                              keep)
                            return
                    got += batch.n
                    yield batch
                if limit is not None and got >= limit:
                    return

    def features(self, plan: QueryPlan) -> ColumnBatch:
        batches = list(self.features_iter(plan))
        return ColumnBatch.concat(batches) if batches else ColumnBatch({}, 0)

    def features_pushdown(self, plan: QueryPlan) -> ColumnBatch:
        """The matching rows with the pushdown window engaged: spilled lake
        partitions load only the row groups whose statistics meet the
        plan's bounds, which hold every matching row (the join's side
        scan)."""
        window = self._push_window(plan)
        try:
            batches = list(self.features_iter(plan, window=window))
        finally:
            self._note_pushdown_fallbacks(plan, window)
        return ColumnBatch.concat(batches) if batches else ColumnBatch({}, 0)

    def top_batch(self, plan: QueryPlan, attr: str, descending: bool, k: int,
                  names=None, include_ties: bool = False) -> Optional[ColumnBatch]:
        """Candidate rows of a sorted, limited query: each partition's own
        device top-k candidates (ties included when asked), or its full
        match set where its selection declines, so the union holds the
        global top-k; the caller sorts and truncates. None when no
        partition selected on the device."""
        parts: List[ColumnBatch] = []
        pushed = 0
        with closing(self._each(plan)) as each:
            for b, ex in each:
                def one_part(ex=ex):
                    pos = ex.top_rows(plan, attr, descending, k, include_ties=include_ties)
                    if pos is None:
                        return False, ex.features(plan)
                    if not len(pos):
                        return True, None  # the device ran and found nothing
                    return True, ex.store.tables[plan.index_name].gather_sorted(pos, names)

                got = self._scan_part(plan, b, "top", one_part)
                if got is _SKIPPED:
                    continue
                dev, batch = got
                pushed += dev
                if batch is not None and batch.n:
                    parts.append(batch)
        if pushed == 0:
            return None
        return ColumnBatch.concat(parts) if parts else ColumnBatch({}, 0)

    def knn_features(self, plan: QueryPlan, x: float, y: float, k: int,
                     boxes=None) -> ColumnBatch:
        """Each partition's k nearest rows, gathered in table order; the
        union holds the global k nearest (the caller orders and cuts)."""
        parts = []
        with closing(self._each(plan)) as each:
            for b, ex in each:
                def one_part(ex=ex):
                    pos, _ = ex.knn(plan, x, y, k, boxes=boxes)
                    if not len(pos):
                        return None
                    return ex.store.tables[plan.index_name].gather_sorted(np.sort(pos))

                batch = self._scan_part(plan, b, "knn", one_part)
                if batch is not _SKIPPED and batch is not None:
                    parts.append(batch)
        return ColumnBatch.concat(parts) if parts else ColumnBatch({}, 0)
