"""Scan-window mask for the padded [S, L] layout.

Port of ``geomesa_tpu/kernels/masks.py::window_mask``: per-shard row windows
(resolved on the host by ``searchsorted``) become a boolean mask by a +1/-1
scatter and a cumulative sum, ANDed with the padding-validity mask. Plain
PyTorch, as the reference leaves it to XLA.
"""

from __future__ import annotations

import torch


def window_mask(starts: torch.Tensor, ends: torch.Tensor, counts: torch.Tensor,
                L: int) -> torch.Tensor:
    """[S, K] local-row windows + [S] shard row counts -> [S, L] bool mask.
    Windows within a shard never overlap; padded windows are (0, 0)."""
    S = starts.shape[0]
    d = torch.zeros((S, L + 1), dtype=torch.int32, device=starts.device)
    one = torch.ones(starts.shape, dtype=torch.int32, device=starts.device)
    d.scatter_add_(1, starts.to(torch.int64), one)
    d.scatter_add_(1, ends.to(torch.int64), -one)
    # each shard's +1/-1 marks cancel within its own L + 1 slots, so one
    # flat scan gives every shard's running count (and runs as a device-wide
    # scan instead of one long scan per shard)
    wm = torch.cumsum(d.reshape(-1), 0).reshape(S, L + 1)[:, :L] > 0
    iota = torch.arange(L, dtype=torch.int32, device=starts.device)
    return wm & (iota[None, :] < counts[:, None])
