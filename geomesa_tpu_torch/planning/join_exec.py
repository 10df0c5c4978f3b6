"""SFC co-partitioned spatial-join executor.

Port of ``geomesa_tpu/planning/join_exec.py``: a cheap grid filter prunes
candidate pairs, then an exact test runs on the survivors. Both join sides
co-partition by cell of the 2^level x 2^level lon/lat grid
(``cache/cells.py``; a cell's identity is its z2 prefix), so only
same-cell (plus boundary-strip) pairs are tested:

* the **build** (left) side lands in exactly one cell — the one holding
  its point;
* the **probe** (right) side replicates into every cell its reach box
  ``point ± (reach + CLASSIFY_MARGIN)`` touches (the boundary strip), so
  an f32-rounded pair that passes the exact predicate never hides in an
  unprobed neighbour cell;
* a candidate pair is tested iff the build row's cell is among the probe
  row's cells — exactly once, because the build cell is unique.

Each joint cell routes by its (n_left, n_right) to a strategy
(``geomesa.join.adaptive``): **pairwise** tiles of at most
``geomesa.join.tile`` rows a side, **brute** (a flat candidate list for
cells of at most ``geomesa.join.adaptive.brute.pairs`` pairs), or
**split.l / split.r** (skewed cells in a section whose short axis pads
narrow). Every strategy runs the same f32 ``kernels/join.pair_mask``
arithmetic, and the pairs come out sorted row-major, so the join equals
the NumPy N*M brute force bit for bit.

Tiles are padded to the reference's pow2 buckets (``Bp``/``Pp`` per
section, ``Cp`` tiles per dispatch, ``Kp`` brute slots; ``Np``/``Ep``/
``Pfp``/``Rp`` for polygons), so ``JoinStats`` equals the reference's.
The tile operands are gathered on the host, as in the reference, and the
verdicts run on the dataset's device: the ``pair_tiles`` / ``pair_flat``
/ ``polygon_verdict`` CUDA kernels on a CUDA device, their plain versions
on the CPU. One device runs every section (the reference's multi-device
fan-out is not ported), so each section is one tile range, labelled as
the reference labels its single-device slices (``tiles[0:n]``,
``brute[lo:hi]``, ``poly[0:n]``). The deadline is checked before each
range; a failing range raises in strict mode, and under
``resilience.allow_partial()`` it is recorded in ``JoinStats.skipped``
and the pairs and total are exact over the ranges that completed.

Polygon-dataset joins (:func:`run_polygon_join`) classify each occupied
point cell against each candidate polygon row with
``kernels/join.classify_cells`` + ``CLASSIFY_MARGIN``: interior cells match
wholesale with no pairwise work, outside cells are skipped, and only the
points of boundary cells go through the polygon kernel.

Under tracing, a ``scan.join.partition`` span covers the co-partition and
``scan.join.pairs`` / ``scan.join.brute`` / ``scan.join.poly`` spans each
launch; ``join_cells`` and ``join_candidate_pairs`` go to the trace's
cost ledger.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config, metrics, tracing, utilization
from geomesa_tpu_torch.cache.cells import CLASSIFY_MARGIN
from geomesa_tpu_torch.kernels import join as kjoin
from geomesa_tpu_torch.kernels.registry import KernelRegistry
from geomesa_tpu_torch.resilience import (
    QueryTimeoutError, check_deadline, partial_allowed, record_skip,
)

#: fixed section order: sections execute in this order, pairs concatenate
#: in section order, and the canonical row-major sort at the end makes the
#: surfaced set independent of the routing anyway
SECTION_ORDER = ("pairwise", "split.l", "split.r")


#: one process-wide registry of join callables: the pair and polygon
#: verdicts are pure in (shapes, predicate), so their keys carry no store
_REGISTRY: Optional[KernelRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def join_registry() -> KernelRegistry:
    """The process-wide join-callable registry (the reference's: its
    ``traces('join.pairs')`` is the join recompile count)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = KernelRegistry()
        return _REGISTRY


def _pairs_kernel(site: str, Bp: int, Pp: int, Cp: int, predicate: str):
    """The registry's ``pair_tiles`` callable of one bucketed tile shape,
    under the reference's key ``(site, Bp, Pp, Cp, predicate)``; the
    predicate's parameters are call operands, so distances never rebuild."""
    reg = join_registry()
    key = (site, Bp, Pp, Cp, predicate)
    go = reg.get(key)
    if go is None:
        def go(lxb, lyb, rxb, ryb, lval, rval, p0, p1, want_mask, lzb, rzb):
            return kjoin.pair_tiles(lxb, lyb, rxb, ryb, lval, rval, predicate, p0, p1,
                                    want_mask=want_mask, lzb=lzb, rzb=rzb)

        reg.put(key, go)
    return go


def _brute_kernel(Kp: int, predicate: str):
    """The registry's ``pair_flat`` callable of one length bucket."""
    reg = join_registry()
    key = ("join.brute", Kp, predicate)
    go = reg.get(key)
    if go is None:
        def go(lxv, lyv, rxv, ryv, kvalid, p0, p1, want_mask, lzv, rzv):
            return kjoin.pair_flat(lxv, lyv, rxv, ryv, kvalid, predicate, p0, p1,
                                   want_mask=want_mask, lzv=lzv, rzv=rzv)

        reg.put(key, go)
    return go


def _poly_kernel(Np: int, Ep: int, Pfp: int, Rp: int, predicate: str):
    """The registry's ``polygon_verdict`` callable of one padded shape."""
    reg = join_registry()
    key = ("join.poly", Np, Ep, Pfp, Rp, predicate)
    go = reg.get(key)
    if go is None:
        def go(pxv, pyv, tables):
            return kjoin.polygon_verdict(pxv, pyv, tables, predicate)

        reg.put(key, go)
    return go


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _tile() -> int:
    t = config.JOIN_TILE.to_int()
    return 64 if t is None else max(int(t), 8)


def _brute_max() -> int:
    v = config.JOIN_ADAPTIVE_BRUTE_PAIRS.to_int()
    return 256 if v is None else max(int(v), 0)


def _skew_ratio() -> int:
    v = config.JOIN_ADAPTIVE_SKEW_RATIO.to_int()
    return 8 if v is None else max(int(v), 2)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


@dataclass
class JoinStats:
    """The explain account of one co-partitioned join: how much the grid
    filter pruned vs the naive N*M, and which strategy each joint cell
    routed to."""

    level: int = 0
    n_left: int = 0
    n_right: int = 0
    cells_left: int = 0
    cells_right: int = 0
    #: cells populated on BOTH sides (only these dispatch)
    cells_joint: int = 0
    #: exact pairwise tests dispatched (same-cell + strip candidates)
    candidate_pairs: int = 0
    #: probe rows replicated beyond their home cell (the boundary strip)
    strip_entries: int = 0
    tiles: int = 0
    matched: int = 0
    devices: int = 1
    #: tile ranges and polygon slices an ``allow_partial()`` join skipped
    skipped: List[str] = field(default_factory=list)
    #: whether per-cell strategy selection ran (vs the single-strategy A/B)
    adaptive: bool = False
    #: joint cells per strategy (pairwise / brute / split.l / split.r;
    #: polygon joins: interior / boundary incidences)
    strategy_cells: Dict[str, int] = field(default_factory=dict)
    #: candidate pairs per strategy as estimated at classification time
    est_pairs: Dict[str, int] = field(default_factory=dict)
    #: pair slots dispatched per strategy AFTER padding
    dispatched_pairs: Dict[str, int] = field(default_factory=dict)
    #: polygon-join pairs matched wholesale from INTERIOR cells
    wholesale_pairs: int = 0
    #: a pushdown count's account (chunks, cells, bytes and row groups
    #: loaded against the whole side, residency hits and bytes they saved;
    #: empty for a join that scanned both sides whole)
    pushdown: Dict[str, int] = field(default_factory=dict)

    @property
    def naive_pairs(self) -> int:
        return self.n_left * self.n_right

    @property
    def candidate_fraction(self) -> float:
        return self.candidate_pairs / max(self.naive_pairs, 1)

    @property
    def strip_fraction(self) -> float:
        """Fraction of probe-side cell memberships that are strip
        replicas (0 = every probe row stayed in its home cell)."""
        total = self.n_right + self.strip_entries
        return self.strip_entries / max(total, 1)


def choose_level(n_left: int, n_right: int, reach: float,
                 bounds: Optional[Tuple[float, float, float, float]]) -> int:
    """Co-partition level: fine enough that the denser side averages
    ~tile rows per occupied cell over its extent, coarse enough that a
    probe reach box spans at most 2 cells per axis."""
    tile = _tile()
    max_level = config.JOIN_MAX_LEVEL.to_int() or 12
    if bounds is None:
        span = 360.0
    else:
        span = max(bounds[2] - bounds[0], (bounds[3] - bounds[1]) * 2, 1e-6)
    target_axis = float(np.sqrt(max(n_left, n_right, 1) / tile))
    target_axis = min(max(target_axis, 1.0), 1024.0)
    want_span = max(span / target_axis, 1e-9)
    level_data = int(np.ceil(np.log2(360.0 / want_span)))
    reach = max(float(reach), 0.0) + CLASSIFY_MARGIN
    level_reach = int(np.floor(np.log2(360.0 / max(2.0 * reach, 1e-9))))
    return int(np.clip(min(level_data, level_reach), 1, max_level))


def _cell_ids(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Absolute cell identity: the z2 curve prefix (interleave2)."""
    from geomesa_tpu_torch.curves.zorder import interleave2

    return interleave2(ix.astype(np.uint64), iy.astype(np.uint64))


@dataclass
class TileSection:
    """One strategy's padded tile blocks: [C, Bp] / [C, Pp] global row
    positions (0-padded; valid counts mask), pow2-bucketed independently
    of every other section."""

    strategy: str  # "pairwise" | "split.l" | "split.r"
    site: str  # the reference's kernel-registry site of the section
    l_rows: np.ndarray
    r_rows: np.ndarray
    l_valid: np.ndarray  # [C] int32
    r_valid: np.ndarray  # [C] int32
    Bp: int
    Pp: int

    @property
    def n_tiles(self) -> int:
        return len(self.l_rows)


@dataclass
class JoinPlan:
    """Host-side co-partition product: per-strategy tile sections plus
    the flat brute-force candidate list for sparse cells. All index arrays
    are int32 positions into the caller's left/right row sets."""

    predicate: str
    p0: np.float32
    p1: np.float32
    stats: JoinStats
    sections: List[TileSection] = field(default_factory=list)
    #: flat sparse-cell candidate pairs (global row positions, aligned)
    brute_l: Optional[np.ndarray] = None
    brute_r: Optional[np.ndarray] = None

    @property
    def n_tiles(self) -> int:
        return sum(s.n_tiles for s in self.sections)

    @property
    def n_brute(self) -> int:
        return 0 if self.brute_l is None else len(self.brute_l)

    @property
    def Bp(self) -> int:
        return max((s.Bp for s in self.sections), default=0)

    @property
    def Pp(self) -> int:
        return max((s.Pp for s in self.sections), default=0)


def co_partition(lx, ly, rx, ry, predicate: str, reach_x,
                 reach_y: float, level: Optional[int] = None,
                 p0=None, p1=None, wrap_x: bool = False,
                 adaptive: Optional[bool] = None) -> JoinPlan:
    """Group both sides by SFC cell at ``level`` (chosen when None),
    classify each joint cell's strategy from its (n_left, n_right), and
    chunk into per-strategy padded tile sections plus the flat brute
    list. Pure host numpy.

    ``adaptive`` None reads ``geomesa.join.adaptive``; False forces every
    joint cell through the single "pairwise" section with exact-maxima
    padding. ``reach_x`` may be a per-probe-row array (``dwithin_meters``:
    the lon reach grows with |latitude|). ``wrap_x`` wraps the probe reach
    box across the antimeridian (modular lon cells) — a great-circle
    predicate matches across lon ±180, so its strip must too."""
    lx = np.asarray(lx, np.float64)
    ly = np.asarray(ly, np.float64)
    rx = np.asarray(rx, np.float64)
    ry = np.asarray(ry, np.float64)
    # level choice uses the TYPICAL reach (per-row reach_x arrays rank by
    # their minimum — high-latitude rows widen their own windows instead
    # of coarsening every cell)
    rx_typ = (float(np.min(reach_x)) if np.ndim(reach_x) and len(reach_x)
              else float(reach_x) if not np.ndim(reach_x) else 0.0)
    reach = max(rx_typ, float(reach_y))
    if level is None:
        n_l, n_r = len(lx), len(rx)
        bounds = None
        if n_l and n_r:
            bounds = (
                min(lx.min(), rx.min()), min(ly.min(), ry.min()),
                max(lx.max(), rx.max()), max(ly.max(), ry.max()),
            )
        level = choose_level(n_l, n_r, reach, bounds)
    if adaptive is None:
        adaptive = config.JOIN_ADAPTIVE.to_bool()
        adaptive = True if adaptive is None else bool(adaptive)
    stats = JoinStats(level=level, n_left=len(lx), n_right=len(rx),
                      adaptive=bool(adaptive))
    plan = JoinPlan(predicate=predicate, p0=p0, p1=p1, stats=stats)
    if not len(lx) or not len(rx):
        return plan
    n = 1 << level
    sx, sy = 360.0 / n, 180.0 / n

    def cell_of(x, y):
        ix = np.clip(np.floor((x + 180.0) / sx), 0, n - 1).astype(np.int64)
        iy = np.clip(np.floor((y + 90.0) / sy), 0, n - 1).astype(np.int64)
        return ix, iy

    lix, liy = cell_of(lx, ly)
    lcell = _cell_ids(lix, liy)
    stats.cells_left = len(np.unique(lcell))

    # probe reach box, inflated by the classify margin: every cell the box
    # touches gets a membership
    mx = np.asarray(reach_x, np.float64) + CLASSIFY_MARGIN
    my = float(reach_y) + CLASSIFY_MARGIN
    if wrap_x:
        # modular lon: the window spans [ix0, ix1] mod n, capped at one
        # full wrap (a reach past 180° of longitude covers every column)
        ix0 = np.floor((rx - mx + 180.0) / sx).astype(np.int64)
        ix1 = np.floor((rx + mx + 180.0) / sx).astype(np.int64)
        wx = np.minimum(ix1 - ix0 + 1, n).astype(np.int64)
    else:
        ix0 = np.clip(np.floor((rx - mx + 180.0) / sx), 0, n - 1).astype(np.int64)
        ix1 = np.clip(np.floor((rx + mx + 180.0) / sx), 0, n - 1).astype(np.int64)
        wx = (ix1 - ix0 + 1).astype(np.int64)
    iy0 = np.clip(np.floor((ry - my + 90.0) / sy), 0, n - 1).astype(np.int64)
    iy1 = np.clip(np.floor((ry + my + 90.0) / sy), 0, n - 1).astype(np.int64)
    wy = (iy1 - iy0 + 1).astype(np.int64)
    w = wx * wy
    rid = np.repeat(np.arange(len(rx), dtype=np.int64), w)
    # per-membership (dx, dy) offsets within each row's window, row-major
    off = np.arange(int(w.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(w) - w, w
    )
    gx = ix0[rid] + off % wx[rid]
    if wrap_x:
        gx %= n  # python modulo: non-negative for ix0 < 0
    gy = iy0[rid] + off // wx[rid]
    rcell = _cell_ids(gx, gy)
    rhome = _cell_ids(*cell_of(rx, ry))
    stats.cells_right = len(np.unique(rhome))

    # keep only memberships whose cell holds build rows (the joint cells)
    ucell, linv = np.unique(lcell, return_inverse=True)
    pos = np.searchsorted(ucell, rcell)
    pos_c = np.minimum(pos, len(ucell) - 1)
    keep = ucell[pos_c] == rcell
    rid, rcell_k, pos_c = rid[keep], rcell[keep], pos_c[keep]
    stats.strip_entries = int((rhome[rid] != rcell_k).sum())
    if not len(rid):
        return plan

    # group both sides by joint-cell index (stable order: row order within
    # a cell, cells in ucell order — deterministic for any input)
    lorder = np.argsort(linv, kind="stable")
    lsorted = lorder.astype(np.int32)
    lcounts = np.bincount(linv, minlength=len(ucell))
    rorder = np.argsort(pos_c, kind="stable")
    rsorted = rid[rorder].astype(np.int32)
    rcounts = np.bincount(pos_c, minlength=len(ucell))
    joint = (lcounts > 0) & (rcounts > 0)
    stats.cells_joint = int(joint.sum())
    stats.candidate_pairs = int(
        (lcounts[joint].astype(np.int64) * rcounts[joint]).sum()
    )
    lstart = np.concatenate(([0], np.cumsum(lcounts)))
    rstart = np.concatenate(([0], np.cumsum(rcounts)))

    # per-cell strategy classification: sparse cells gather flat, skewed
    # cells bucket in their own orientation section so the short axis pads
    # narrow, dense balanced cells tile. Adaptive tile shapes are static
    # per strategy — (Tp, Tp), (Tp, SPLIT_SHORT), (SPLIT_SHORT, Tp);
    # single-strategy mode keeps the exact-maxima padding
    T = _tile()
    Tp = _pow2(T)
    brute_max = _brute_max() if adaptive else 0
    skew = _skew_ratio()
    # fixed short-axis chunk for split sections
    split_short = min(8, Tp)
    bl_list: List[np.ndarray] = []
    br_list: List[np.ndarray] = []
    # strategy -> [tl_rows, tr_rows, tl_valid, tr_valid, max_b, max_p]
    buckets: Dict[str, list] = {}
    for c in np.nonzero(joint)[0]:
        lrows = lsorted[lstart[c]: lstart[c + 1]]
        rrows = rsorted[rstart[c]: rstart[c + 1]]
        nl, nr = len(lrows), len(rrows)
        if adaptive and nl * nr <= brute_max:
            strat = "brute"
            # flat candidate list, left-major (the global sort
            # re-establishes row-major order across strategies anyway)
            bl_list.append(np.repeat(lrows, nr))
            br_list.append(np.tile(rrows, nl))
        elif adaptive and max(nl, nr) >= skew * max(min(nl, nr), 1) \
                and max(nl, nr) > T:
            strat = "split.l" if nl >= nr else "split.r"
        else:
            strat = "pairwise"
        stats.strategy_cells[strat] = stats.strategy_cells.get(strat, 0) + 1
        stats.est_pairs[strat] = stats.est_pairs.get(strat, 0) + nl * nr
        if strat == "brute":
            continue
        if strat == "split.l":
            tb, tp = T, split_short
        elif strat == "split.r":
            tb, tp = split_short, T
        else:
            tb = tp = T
        bucket = buckets.setdefault(strat, [[], [], [], [], 1, 1])
        tl_rows, tr_rows, tl_valid, tr_valid = bucket[0], bucket[1], \
            bucket[2], bucket[3]
        for bl in range(0, nl, tb):
            lchunk = lrows[bl: bl + tb]
            for pl in range(0, nr, tp):
                rchunk = rrows[pl: pl + tp]
                tl_rows.append(lchunk)
                tr_rows.append(rchunk)
                tl_valid.append(len(lchunk))
                tr_valid.append(len(rchunk))
                bucket[4] = max(bucket[4], len(lchunk))
                bucket[5] = max(bucket[5], len(rchunk))
    for strat in SECTION_ORDER:
        if strat not in buckets:
            continue
        tl_rows, tr_rows, tl_valid, tr_valid, max_b, max_p = buckets[strat]
        C = len(tl_rows)
        if not adaptive:
            Bp, Pp = _pow2(max_b), _pow2(max_p)  # legacy exact padding
        elif strat == "split.l":
            Bp, Pp = Tp, split_short
        elif strat == "split.r":
            Bp, Pp = split_short, Tp
        else:
            Bp = Pp = Tp
        l_rows = np.zeros((C, Bp), np.int32)
        r_rows = np.zeros((C, Pp), np.int32)
        for i in range(C):
            l_rows[i, : tl_valid[i]] = tl_rows[i]
            r_rows[i, : tr_valid[i]] = tr_rows[i]
        site = "join.pairs" if strat == "pairwise" else "join.pairs.split"
        plan.sections.append(TileSection(
            strategy=strat, site=site, l_rows=l_rows, r_rows=r_rows,
            l_valid=np.asarray(tl_valid, np.int32),
            r_valid=np.asarray(tr_valid, np.int32), Bp=Bp, Pp=Pp,
        ))
        stats.tiles += C
        stats.dispatched_pairs[strat] = C * Bp * Pp
    if bl_list:
        plan.brute_l = np.concatenate(bl_list)
        plan.brute_r = np.concatenate(br_list)
        stats.dispatched_pairs["brute"] = len(plan.brute_l)
    return plan


# ---------------------------------------------------------------------------
# Execution on the device
# ---------------------------------------------------------------------------

def _pad_tiles(sec: TileSection, lo: int, hi: int, lx32, ly32, rx32, ry32,
               lz32=None, rz32=None):
    """One dispatch's padded kernel operands: tile rows [Cp, Bp/Pp]
    gathered into coordinate blocks, Cp = pow2 bucket of the slice.
    ``lz32``/``rz32`` (dwithin_meters unit vectors) gather to z blocks."""
    C = hi - lo
    Cp = _pow2(C)
    lrows = np.zeros((Cp, sec.Bp), np.int32)
    rrows = np.zeros((Cp, sec.Pp), np.int32)
    lval = np.zeros(Cp, np.int32)
    rval = np.zeros(Cp, np.int32)
    lrows[:C] = sec.l_rows[lo:hi]
    rrows[:C] = sec.r_rows[lo:hi]
    lval[:C] = sec.l_valid[lo:hi]
    rval[:C] = sec.r_valid[lo:hi]
    lzb = None if lz32 is None else lz32[lrows]
    rzb = None if rz32 is None else rz32[rrows]
    return (lx32[lrows], ly32[lrows], rx32[rrows], ry32[rrows],
            lval, rval, Cp, C, lzb, rzb)


def _on(device, *arrays):
    return tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _range_or_skip(stats: "JoinStats", label: str, fn):
    """One tile range or polygon slice under the degradation contract: the
    deadline first; a failure re-raises in strict mode, and under
    ``allow_partial()`` is recorded as ``label`` and returns None. A
    deadline is never degraded."""
    try:
        check_deadline()
        return fn()
    except Exception as e:
        if isinstance(e, QueryTimeoutError) or not partial_allowed():
            raise
        record_skip("join", label, e, phase="pairs")
        stats.skipped.append(label)
        return None


def execute(plan: JoinPlan, lx, ly, rx, ry, device=None,
            want_pairs: bool = True, lz=None, rz=None):
    """Run every strategy section and the flat brute list on ``device``
    (default: the CUDA device). Returns ``(pairs, total)``: matched global
    (left, right) row positions as int64 [K, 2] sorted row-major (None when
    ``want_pairs`` is False) and the match total, exact over the ranges
    that completed (see :func:`_range_or_skip`). For ``dwithin_meters``,
    the coordinate operands are the sides' f32 unit vectors ((lx, ly, lz) /
    (rx, ry, rz) — kernels/join.unit_vectors)."""
    stats = plan.stats
    if plan.n_tiles == 0 and plan.n_brute == 0:
        return (np.zeros((0, 2), np.int64) if want_pairs else None), 0
    device = _device(device)
    lx32 = np.asarray(lx, np.float32)
    ly32 = np.asarray(ly, np.float32)
    rx32 = np.asarray(rx, np.float32)
    ry32 = np.asarray(ry, np.float32)
    lz32 = None if lz is None else np.asarray(lz, np.float32)
    rz32 = None if rz is None else np.asarray(rz, np.float32)
    # one dispatch per section (the reference's single-device fan-out),
    # then fixed-size brute chunks: every brute dispatch, the last one
    # included, pads to the same Kp of four dense tiles' slots
    partials = [
        _range_or_skip(stats, f"tiles[0:{sec.n_tiles}]", lambda sec=sec: _run_slice(
            plan, sec, lx32, ly32, rx32, ry32, device, want_pairs, lz32=lz32, rz32=rz32))
        for sec in plan.sections if sec.n_tiles]
    if plan.n_brute:
        bchunk = 4 * _pow2(_tile()) ** 2
        for lo in range(0, plan.n_brute, bchunk):
            hi = min(lo + bchunk, plan.n_brute)
            partials.append(_range_or_skip(
                stats, f"brute[{lo}:{hi}]",
                lambda lo=lo, hi=hi: _run_brute_slice(
                    plan, lo, hi, lx32, ly32, rx32, ry32, device, want_pairs,
                    lz32=lz32, rz32=rz32, Kp=bchunk)))
    partials = [p for p in partials if p is not None]
    total = int(sum(p[1] for p in partials))
    stats.matched = total
    if not want_pairs:
        return None, total
    blocks = [p[0] for p in partials if len(p[0])]
    if not blocks:
        return np.zeros((0, 2), np.int64), total
    pairs = np.concatenate(blocks, axis=0)
    # canonical row-major order == the brute-force reference's nonzero
    # order: this is also what makes the adaptive routing invisible
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order], total


def _run_slice(plan: JoinPlan, sec: TileSection, lx32, ly32, rx32, ry32,
               device, want_pairs: bool, lz32=None, rz32=None):
    """One section's tiles through ``pair_tiles``: (pairs int64 [k, 2] in
    tile order, match count). A count-only join copies back the counts
    alone."""
    (lxb, lyb, rxb, ryb, lval, rval, Cp, C, lzb, rzb) = _pad_tiles(
        sec, 0, sec.n_tiles, lx32, ly32, rx32, ry32, lz32, rz32
    )
    ops = _on(device, lxb, lyb, rxb, ryb, lval, rval, lzb, rzb)
    go = _pairs_kernel(sec.site, sec.Bp, sec.Pp, Cp, plan.predicate)
    dev = _device(device)
    with tracing.span("scan.join.pairs", tiles=C, device=dev.index), \
            utilization.device_busy(dev):
        metrics.inc(metrics.EXEC_DEVICE_DISPATCH)
        m, counts = go(*ops[:6], plan.p0, plan.p1, want_pairs, ops[6], ops[7])
    n = int(counts[:C].sum())
    if not want_pairs:
        return np.zeros((0, 2), np.int64), n
    c, b, p = np.nonzero(m[:C].cpu().numpy())
    pairs = np.stack([
        sec.l_rows[c, b].astype(np.int64), sec.r_rows[c, p].astype(np.int64)
    ], axis=1)
    return pairs, n


def _run_brute_slice(plan: JoinPlan, lo: int, hi: int, lx32, ly32,
                     rx32, ry32, device, want_pairs: bool,
                     lz32=None, rz32=None, Kp: Optional[int] = None):
    """One flat brute-force slice through ``pair_flat``: the sparse-cell
    candidate pairs [lo:hi) gathered into 1-D operands padded to ``Kp``
    (pow2 of the slice length when not given). Returns (pairs, count)."""
    bl = plan.brute_l[lo:hi]
    br = plan.brute_r[lo:hi]
    K = hi - lo
    if Kp is None:
        Kp = _pow2(K)
    lidx = np.zeros(Kp, np.int32)
    ridx = np.zeros(Kp, np.int32)
    lidx[:K] = bl
    ridx[:K] = br
    lzv = None if lz32 is None else lz32[lidx]
    rzv = None if rz32 is None else rz32[ridx]
    ops = _on(device, lx32[lidx], ly32[lidx], rx32[ridx], ry32[ridx], lzv, rzv)
    go = _brute_kernel(Kp, plan.predicate)
    dev = _device(device)
    with tracing.span("scan.join.brute", pairs=K, device=dev.index), \
            utilization.device_busy(dev):
        metrics.inc(metrics.EXEC_DEVICE_DISPATCH)
        m, n = go(*ops[:4], K, plan.p0, plan.p1, want_pairs, ops[4], ops[5])
    n = int(n)
    if not want_pairs:
        return np.zeros((0, 2), np.int64), n
    k = np.nonzero(m[:K].cpu().numpy())[0]
    pairs = np.stack([bl[k].astype(np.int64), br[k].astype(np.int64)],
                     axis=1)
    return pairs, n


def meters_reach_deg(distance_m: float, lat) -> Tuple[np.ndarray, float]:
    """Conservative lon/lat reach (degrees) of ``distance_m`` meters of
    great-circle distance around probe rows at latitudes ``lat`` —
    ``(reach_x [per-row], reach_y)``. The lat reach is the central angle;
    the lon reach is the maximal longitude span of the spherical circle,
    ``arcsin(sin θ / cos φ)``, going full wrap (360°) where the circle
    reaches a pole."""
    theta = float(distance_m) / kjoin.EARTH_RADIUS_M  # central angle, rad
    reach_y = float(np.degrees(theta))
    if theta >= np.pi / 2:
        return np.full(np.shape(lat), 360.0), reach_y
    cphi = np.cos(np.deg2rad(np.asarray(lat, np.float64)))
    s = np.sin(theta)
    safe = s < cphi
    reach_x = np.where(
        safe,
        np.degrees(np.arcsin(np.minimum(s / np.maximum(cphi, 1e-300), 1.0))),
        360.0,
    )
    return reach_x, reach_y


def join_reach(predicate: str, p0, p1, distance, ry):
    """``(reach_x, reach_y, wrap_x)`` of a pairwise predicate: the box
    half-widths for ``bbox``, the per-row latitude-dependent reach with
    antimeridian wrap for ``dwithin_meters``, else the planar distance."""
    if predicate == kjoin.JOIN_BBOX:
        return float(p0), float(p1), False
    if predicate == kjoin.JOIN_DWITHIN_METERS:
        reach_x, reach_y = meters_reach_deg(float(distance), ry)
        return reach_x, reach_y, True
    return float(distance), float(distance), False


def run_join(lx, ly, rx, ry, predicate: str, distance=None, dx=None,
             dy=None, level: Optional[int] = None, device=None,
             want_pairs: bool = True, adaptive: Optional[bool] = None):
    """Full co-partitioned join: plan + execute. Returns
    ``(pairs, total, stats)``. ``predicate``: ``"bbox"`` (half-widths
    ``dx``/``dy``), ``"dwithin"`` (planar degree ``distance``), or
    ``"dwithin_meters"`` (haversine great-circle ``distance`` meters).
    ``adaptive`` None reads ``geomesa.join.adaptive``."""
    p0, p1 = kjoin.pair_params(predicate, distance=distance, dx=dx, dy=dy)
    reach_x, reach_y, wrap_x = join_reach(predicate, p0, p1, distance, ry)
    with tracing.span("scan.join.partition"):
        plan = co_partition(lx, ly, rx, ry, predicate, reach_x, reach_y,
                            level=level, p0=p0, p1=p1, wrap_x=wrap_x,
                            adaptive=adaptive)
    _record_cells(plan.stats)
    tracing.add_cost("join_cells", float(plan.stats.cells_joint))
    tracing.add_cost("join_candidate_pairs", float(plan.stats.candidate_pairs))
    pairs, total = execute_predicate(plan, lx, ly, rx, ry, predicate,
                                     device=device, want_pairs=want_pairs)
    metrics.inc(metrics.JOIN_PAIRS, total)
    return pairs, total, plan.stats


def _record_cells(stats: JoinStats) -> None:
    metrics.inc(metrics.JOIN_CELLS, stats.cells_joint)
    metrics.inc(metrics.JOIN_CANDIDATE_PAIRS, stats.candidate_pairs)
    for s, k in stats.strategy_cells.items():
        metrics.inc(metrics.JOIN_CELLS_STRATEGY + s, k)


def record_metrics(stats: JoinStats, total: int) -> None:
    """One join's ``join.cells``, ``join.candidate.pairs``,
    ``join.cells.<strategy>`` and ``join.pairs`` (the pairwise join counts
    its cells before its kernels run, as the reference's does)."""
    _record_cells(stats)
    metrics.inc(metrics.JOIN_PAIRS, total)


def execute_predicate(plan: JoinPlan, lx, ly, rx, ry, predicate: str,
                      device=None, want_pairs: bool = True):
    """:func:`execute` with the predicate's operand convention applied:
    ``dwithin_meters`` runs on the f32 unit vectors (host trig once,
    shared by kernel and reference), every other predicate on lon/lat.
    The one dispatch :func:`run_join` and ``explain_join(analyze=True)``
    share."""
    if predicate == kjoin.JOIN_DWITHIN_METERS:
        lux, luy, luz = kjoin.unit_vectors(lx, ly)
        rux, ruy, ruz = kjoin.unit_vectors(rx, ry)
        return execute(plan, lux, luy, rux, ruy, device=device,
                       want_pairs=want_pairs, lz=luz, rz=ruz)
    return execute(plan, lx, ly, rx, ry, device=device, want_pairs=want_pairs)


# ---------------------------------------------------------------------------
# Polygon-dataset joins: point side x POLYGON side
# ---------------------------------------------------------------------------

def _polygon_level(n_points: int, bnds: np.ndarray) -> int:
    """Cell level for a polygon join: the median polygon should span a
    few cells per axis — fine enough that INTERIOR cells exist, coarse
    enough that per-polygon candidate cell counts stay bounded."""
    max_level = config.JOIN_MAX_LEVEL.to_int() or 12
    spans = np.maximum(
        np.maximum(bnds[:, 2] - bnds[:, 0], (bnds[:, 3] - bnds[:, 1]) * 2.0),
        1e-9,
    )
    med = float(np.median(spans))
    level = int(np.round(np.log2(360.0 / max(med / 4.0, 1e-9))))
    return int(np.clip(level, 1, max_level))


def run_polygon_join(px, py, geoms, predicate: str,
                     level: Optional[int] = None, device=None,
                     want_pairs: bool = True):
    """Join a point side against a polygon-dataset side. Returns
    ``(pairs, total, stats)``: matched (point_row, polygon_row) positions
    in canonical row-major order, equal to
    ``kernels/join.polygon_brute_force``.

    Occupied point cells classify against each candidate polygon via
    ``classify_cells`` + ``CLASSIFY_MARGIN``: INTERIOR cells match
    wholesale (every point is at least the margin inside, so the f32
    verdict is True for all of them), OUTSIDE cells are skipped, and the
    points of BOUNDARY cells go through ``polygon_verdict`` (the same
    ``polygon_mask`` f32 arithmetic as the reference).

    ``predicate``: ``"pip"`` (even-odd point-in-polygon; holes and
    multipolygon parts per ``polygon_mask``) or ``"poly_bbox"`` (point in
    the row's bounds, inclusive edges — classification runs against the
    bounds rectangle)."""
    from geomesa_tpu_torch.cache import cells as gcells
    from geomesa_tpu_torch.utils import geometry as geo

    px = np.asarray(px, np.float64)
    py = np.asarray(py, np.float64)
    geoms = list(geoms)
    stats = JoinStats(n_left=len(px), n_right=len(geoms), adaptive=True)
    empty = np.zeros((0, 2), np.int64)
    if not len(px) or not len(geoms):
        return (empty if want_pairs else None), 0, stats
    bnds = np.asarray([g.bounds() for g in geoms], np.float64)  # [R, 4]
    if level is None:
        level = _polygon_level(len(px), bnds)
    stats.level = level
    ix, iy = gcells.point_cells(px, py, level)
    cell = _cell_ids(ix, iy)
    order = np.argsort(cell, kind="stable")
    sorted_cells = cell[order]
    ucell, starts = np.unique(sorted_cells, return_index=True)
    ends = np.concatenate([starts[1:], [len(order)]])
    stats.cells_left = len(ucell)
    stats.cells_right = len(geoms)
    boxes = gcells.cell_boxes(level, ix[order][starts], iy[order][starts])
    m = CLASSIFY_MARGIN

    wholesale_blocks: List[np.ndarray] = []
    R = len(geoms)
    boundary_pts = np.zeros(len(px), bool)
    # per-polygon boundary cell lists (classified into the candidate mask
    # AFTER the boundary point set is known)
    boundary_cells: List[np.ndarray] = []
    interior_cells = boundary_count = 0
    for j, g in enumerate(geoms):
        bx0, by0, bx1, by1 = bnds[j]
        cand = np.nonzero(
            (boxes[:, 0] <= bx1 + m) & (boxes[:, 2] >= bx0 - m)
            & (boxes[:, 1] <= by1 + m) & (boxes[:, 3] >= by0 - m)
        )[0]
        if not len(cand):
            boundary_cells.append(cand)
            continue
        stats.cells_joint += len(cand)
        target = g if predicate == kjoin.JOIN_PIP \
            else geo.bbox_polygon(bx0, by0, bx1, by1)
        cls = kjoin.classify_cells(boxes[cand], target, CLASSIFY_MARGIN)
        interior = cand[cls == kjoin.CELL_INTERIOR]
        boundary = cand[cls == kjoin.CELL_BOUNDARY]
        interior_cells += len(interior)
        boundary_count += len(boundary)
        for u in interior:
            rows = order[starts[u]: ends[u]]
            wholesale_blocks.append(np.stack([
                rows.astype(np.int64),
                np.full(len(rows), j, np.int64),
            ], axis=1))
        for u in boundary:
            boundary_pts[order[starts[u]: ends[u]]] = True
        boundary_cells.append(boundary)
    stats.strategy_cells["interior"] = interior_cells
    stats.strategy_cells["boundary"] = boundary_count
    wholesale = (np.concatenate(wholesale_blocks, axis=0)
                 if wholesale_blocks else empty)
    stats.wholesale_pairs = len(wholesale)

    # boundary phase: unique boundary points x candidate polygons through
    # the polygon kernel (the only pairwise work in the whole join)
    brows = np.nonzero(boundary_pts)[0]
    matched_blocks: List[np.ndarray] = []
    kernel_total = 0
    if len(brows):
        # candmask[b, j]: point b's cell is a boundary cell of polygon j —
        # interior cells are EXCLUDED (already matched wholesale)
        bpos = np.full(len(px), -1, np.int64)
        bpos[brows] = np.arange(len(brows))
        candmask = np.zeros((len(brows), R), bool)
        for j, bcells in enumerate(boundary_cells):
            for u in bcells:
                rows = order[starts[u]: ends[u]]
                candmask[bpos[rows], j] = True
        stats.candidate_pairs = int(candmask.sum())
        tables = kjoin.polygon_tables(geoms)
        Ep = _pow2(tables["n_edges"])
        Pfp = _pow2(tables["n_parts"])
        Rp = _pow2(tables["n_rows"])
        tables = kjoin.polygon_tables(geoms, pad_edges=Ep, pad_parts=Pfp,
                                      pad_rows=Rp)
        dev_tables = kjoin.table_tensors(tables, _device(device))
        px32 = px.astype(np.float32)
        py32 = py.astype(np.float32)
        verdict = _range_or_skip(
            stats, f"poly[0:{len(brows)}]",
            lambda: _run_poly_slice(brows, px32, py32, dev_tables, predicate,
                                    _device(device), Ep, Pfp, Rp))
        if verdict is not None:
            hit = verdict[:, :R] & candmask
            kernel_total = int(hit.sum())
            b, j = np.nonzero(hit)
            if len(b):
                matched_blocks.append(np.stack([
                    brows[b].astype(np.int64),
                    j.astype(np.int64),
                ], axis=1))
    total = len(wholesale) + kernel_total
    stats.matched = total
    record_metrics(stats, total)
    if not want_pairs:
        return None, total, stats
    blocks = [b for b in ([wholesale] + matched_blocks) if len(b)]
    if not blocks:
        return empty, total, stats
    pairs = np.concatenate(blocks, axis=0)
    order2 = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order2], total, stats


def _run_poly_slice(rows: np.ndarray, px32, py32, tables, predicate: str, device,
                    Ep: int, Pfp: int, Rp: int):
    """One boundary-point slice: [len(rows), Rp] verdicts of
    ``polygon_verdict`` over the points padded to Np = pow2(len(rows))."""
    K = len(rows)
    Np = _pow2(K)
    idx = np.zeros(Np, np.int64)
    idx[:K] = rows
    pxv, pyv = _on(device, px32[idx], py32[idx])
    go = _poly_kernel(Np, Ep, Pfp, Rp, predicate)
    dev = _device(device)
    with tracing.span("scan.join.poly", points=K, device=dev.index), \
            utilization.device_busy(dev):
        metrics.inc(metrics.EXEC_DEVICE_DISPATCH)
        verdict = go(pxv, pyv, tables)
    return verdict[:K].cpu().numpy()
