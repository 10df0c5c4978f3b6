"""Hierarchical pre-aggregation over the SFC cell quadtree.

Copy of ``geomesa_tpu/cache/hierarchy.py`` (GeoBlocks' idea: every
level-k cell is the disjoint union of its four level-(k+1) children, so a
coarse aggregate is the merge of the children's). Counts add, unweighted
f32 density grids add and curve-block grids downsample-add exactly, and
exact-algebra sketches merge. Two ways in:

* lazily on a miss (:func:`assemble`): a coarse cell the cache has not
  seen tries its children (recursively, ``geomesa.cache.hierarchy.depth``
  levels down) before a scan, so a zoom-out over a region warmed by finer
  pans costs O(visible cells) lookups and no device launch;
* bottom-up on put (:func:`rollup`): storing a cell whose three siblings
  are resident writes the parent too, recursing upward.

Children always merge in SW, SE, NW, NE order (x fastest from the
southwest), so every assembly of a subtree reproduces the same bytes.
Hierarchy entries live in the same ``CacheStore`` scope (uid, epoch) as
the cells they were merged from: a mutation drops every subtree at once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config, metrics

Cell = Tuple[int, int]

#: THE child-merge order: SW, SE, NW, NE (x-fastest from the southwest)
CHILD_ORDER = ((0, 0), (1, 0), (0, 1), (1, 1))


def enabled() -> bool:
    return bool(config.CACHE_HIERARCHY.to_bool())


def depth() -> int:
    d = config.CACHE_HIERARCHY_DEPTH.to_int()
    return 2 if d is None else max(int(d), 0)


def children(cell: Cell) -> List[Cell]:
    """A cell's four children one level finer, in :data:`CHILD_ORDER`."""
    ix, iy = cell
    return [(2 * ix + dx, 2 * iy + dy) for dx, dy in CHILD_ORDER]


def parent(cell: Cell) -> Cell:
    return (cell[0] >> 1, cell[1] >> 1)


def assemble(
    get: Callable[[int, Cell], Optional[Any]],
    put: Callable[[int, Cell, Any], Any],
    merge4: Callable[[List[Any]], Any],
    level: int,
    cell: Cell,
    max_depth: Optional[int] = None,
    max_level: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
    count_promotes: bool = True,
) -> Optional[Any]:
    """Assemble ``cell`` at ``level`` from cached children, recursively up
    to ``max_depth`` levels down; promote (``put``) every assembled node
    so the next query hits it directly. Returns the assembled (packed)
    value, or None when any descendant subtree is missing — all-or-
    nothing, so a partially warm quad falls back to one exact residual
    scan instead of a wrong partial merge.

    ``get``/``put`` speak PACKED (storable) values; ``merge4`` receives
    the four packed children in :data:`CHILD_ORDER` and returns the packed
    parent. ``stats`` (optional) accumulates ``assembled`` node counts and
    the ``deepest`` child level consulted, for the exec-path notes.
    ``count_promotes=False``: a dry run (``explain``'s residency probe
    passes a no-op put) leaves ``cache.hierarchy.promote`` alone."""
    if max_depth is None:
        max_depth = depth()
    if max_level is None:
        max_level = config.CACHE_MAX_LEVEL.to_int() or 12
    if max_depth <= 0 or level + 1 > max_level:
        return None
    vals: List[Any] = []
    for ch in children(cell):
        v = get(level + 1, ch)
        if v is None:
            v = assemble(get, put, merge4, level + 1, ch,
                         max_depth - 1, max_level, stats, count_promotes)
            if v is None:
                return None
        elif stats is not None:
            stats["deepest"] = max(stats.get("deepest", 0), level + 1)
        vals.append(v)
    packed = merge4(vals)
    put(level, cell, packed)
    if count_promotes:
        metrics.inc(metrics.CACHE_HIER_PROMOTE)
    if stats is not None:
        stats["assembled"] = stats.get("assembled", 0) + 1
        stats["deepest"] = max(stats.get("deepest", 0), level + 1)
    return packed


def rollup(
    get: Callable[[int, Cell], Optional[Any]],
    put: Callable[[int, Cell, Any], Any],
    merge4: Callable[[List[Any]], Any],
    level: int,
    cell: Cell,
    min_level: int = 1,
) -> int:
    """Bottom-up population: after ``cell`` lands at ``level``, write its
    parent whenever all four siblings are resident (and recurse upward
    while quads keep completing). Idempotent — an already-present parent
    stops the walk (it was merged from the same epoch's children, so
    rewriting it could only produce the same bytes). Returns the number of
    parents written."""
    wrote = 0
    while level > min_level:
        par = parent(cell)
        if get(level - 1, par) is not None:
            break
        vals = []
        for ch in children(par):
            v = get(level, ch)
            if v is None:
                return wrote
            vals.append(v)
        put(level - 1, par, merge4(vals))
        metrics.inc(metrics.CACHE_HIER_PROMOTE)
        wrote += 1
        cell, level = par, level - 1
    return wrote


# -- curve-block grids (density_curve; block space) -------------------------
#
# Chunks in block space nest 1:1 across levels: the chunk (cx, cy) of side
# c at level k covers blocks [cx*c, (cx+1)*c) x [cy*c, (cy+1)*c), which at
# level k+1 is exactly the chunk (cx, cy) of side 2c — so a zoom-out step
# is a single child lookup plus one downsample-add, and a stored chunk
# pre-merges ALL its coarser projections bottom-up for free.

def downsample(grid: np.ndarray) -> np.ndarray:
    """One zoom-out step in block space: 2x2 blocks of a level-(k+1) count
    grid sum into one level-k block. Exact for the unweighted path — the
    grids are f64 integer counts (decode_curve), and a level-k block's
    rows are exactly the union of its four children's rows by the z2
    prefix nesting — in the fixed SW,SE,NW,NE order of the reshape."""
    h, w = grid.shape
    return grid.reshape(h // 2, 2, w // 2, 2).sum(axis=(3, 1))


def assemble_curve(
    get: Callable[[int, int, int, int], Optional[np.ndarray]],
    put: Callable[[int, int, int, int, np.ndarray], Any],
    level: int,
    side: int,
    cx: int,
    cy: int,
    max_depth: Optional[int] = None,
    max_level: int = 15,
    stats: Optional[Dict[str, int]] = None,
) -> Optional[np.ndarray]:
    """Assemble the (cx, cy) chunk of ``side`` at ``level`` by
    downsample-adding its level-(k+1) projection (recursively, up to
    ``max_depth`` levels down), promoting every assembled grid.
    ``get``/``put`` take (level, side, cx, cy)."""
    if max_depth is None:
        max_depth = depth()
    if max_depth <= 0 or level + 1 > max_level:
        return None
    g = get(level + 1, side * 2, cx, cy)
    if g is None:
        g = assemble_curve(get, put, level + 1, side * 2, cx, cy,
                           max_depth - 1, max_level, stats)
        if g is None:
            return None
    elif stats is not None:
        stats["deepest"] = max(stats.get("deepest", 0), level + 1)
    out = downsample(g)
    put(level, side, cx, cy, out)
    metrics.inc(metrics.CACHE_HIER_PROMOTE)
    if stats is not None:
        stats["assembled"] = stats.get("assembled", 0) + 1
        stats["deepest"] = max(stats.get("deepest", 0), level + 1)
    return out


def rollup_curve(
    get: Callable[[int, int, int, int], Optional[np.ndarray]],
    put: Callable[[int, int, int, int, np.ndarray], Any],
    level: int,
    side: int,
    cx: int,
    cy: int,
    grid: np.ndarray,
    min_level: int = 1,
) -> int:
    """Bottom-up population for curve chunks: a freshly stored chunk
    pre-merges its coarser projections (halving the side each step) until
    one already exists, the side reaches one block, or ``min_level``."""
    wrote = 0
    while side >= 2 and level - 1 >= min_level:
        level, side = level - 1, side // 2
        if get(level, side, cx, cy) is not None:
            break
        grid = downsample(grid)
        put(level, side, cx, cy, grid)
        metrics.inc(metrics.CACHE_HIER_PROMOTE)
        wrote += 1
    return wrote
