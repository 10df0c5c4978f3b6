"""The partitioned scan's merge order and the serving pool's device claim.

Copy of ``tree_merge``, ``TreeReducer``, ``register_pool`` /
``unregister_pool`` / ``pool_width`` and ``healthy_device_count`` from
``geomesa_tpu/parallel/devices.py``: partials merge in one fixed balanced
association of their pruned-bin order, so float grids add up in the same
order as the JAX package's; a started serving scheduler records its pool
width, which the healthy card count clamps. The port drives one card, so
the count is 1 (0 healthy cards still leave the one default placement).
The device fan-out and the slot -> device map wait for ROADMAP Queue 1's
multi-GPU item.
"""

from __future__ import annotations

import threading
import weakref
from typing import List

#: live executor pools: scheduler -> width
_pools: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_lock = threading.Lock()


def register_pool(owner, n: int) -> None:
    """Record ``owner``'s live executor-pool width (a started scheduler)."""
    with _lock:
        _pools[owner] = max(1, int(n))


def unregister_pool(owner) -> None:
    """Forget ``owner``'s pool (a stopped scheduler)."""
    with _lock:
        _pools.pop(owner, None)


def pool_width() -> int:
    """Width of the widest live pool (1 when none runs)."""
    with _lock:
        return max(_pools.values(), default=1)


def healthy_device_count() -> int:
    """Cards the health registry allows scheduling on, at least 1: a
    cordoned or broken card caps capacity, never zeroes it. The port
    serves card 0 alone, so the count is 1 on the H100 and on the CPU."""
    return 1


def tree_merge(parts, combine):
    """Fixed balanced pairwise reduction of ``parts`` (None = empty): with
    ``[p0, p1, p2, p3, p4]`` in pruned-bin order, round 1 combines adjacent
    pairs left to right, ``(p0+p1), (p2+p3), p4``, and rounds repeat until
    one remains: ``((p0+p1)+(p2+p3)) + p4``."""
    items = [p for p in parts if p is not None]
    if not items:
        return None
    while len(items) > 1:
        nxt = [combine(items[j], items[j + 1]) for j in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


class TreeReducer:
    """Streaming :func:`tree_merge`: push partials in pruned-bin order and
    :meth:`result` gives the same association while holding O(log n)
    partials. A pushed value combines with the stack top while both sit at
    the same level; the leftover stack folds lowest level first."""

    def __init__(self, combine):
        self.combine = combine
        self._stack: List = []  # (level, value), levels strictly decreasing

    def push(self, v) -> None:
        if v is None:
            return
        lvl = 0
        while self._stack and self._stack[-1][0] == lvl:
            _, u = self._stack.pop()
            v = self.combine(u, v)
            lvl += 1
        self._stack.append((lvl, v))

    def result(self):
        if not self._stack:
            return None
        vals = [v for _, v in self._stack]
        v = vals[-1]
        for u in reversed(vals[:-1]):
            v = self.combine(u, v)
        return v
