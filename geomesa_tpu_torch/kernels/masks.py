"""Scan-window and sampling masks.

Port of ``geomesa_tpu/kernels/masks.py``. ``window_mask``: per-shard row
windows (resolved on the host by ``searchsorted``) become a boolean mask by
a +1/-1 scatter and a cumulative sum, ANDed with the padding-validity mask.
The sampling masks keep a deterministic 1-in-n of the matched rows in row
order (the reference's SamplingIterator): overall, or per key value. The
torch functions run on the scan's device; each ``*_np`` / host function is
the NumPy twin the host paths use. Plain PyTorch, as the reference leaves
these to XLA.
"""

from __future__ import annotations

import numpy as np
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


def window_mask_batch(starts: torch.Tensor, ends: torch.Tensor,
                      counts: torch.Tensor, L: int, member: int) -> torch.Tensor:
    """One member's [S, L] mask out of query-axis-stacked [M, S, K] window
    tensors: :func:`window_mask` of that member's windows, so the member's
    mask is its serial scan's. Members padded to the batch bucket carry
    (0, 0) windows and mask to False everywhere."""
    return window_mask(starts[member], ends[member], counts, L)


def sampling_mask(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Keep the 1st, (n+1)th, ... matched row in row order."""
    seq = torch.cumsum(mask.reshape(-1).to(torch.int32), 0) - 1
    return mask & ((seq % n) == 0).reshape(mask.shape)


def sampling_mask_np(mask: np.ndarray, n: int) -> np.ndarray:
    """Host twin of :func:`sampling_mask`."""
    seq = np.cumsum(mask.reshape(-1).astype(np.int32)) - 1
    return mask & ((seq % n) == 0).reshape(mask.shape)


def sampling_mask_by_key(mask: np.ndarray, n: int, key_codes: np.ndarray) -> np.ndarray:
    """Keep every nth matched row *per key value* (host, exact): a
    deterministic counter per key. ``key_codes``: int codes aligned with
    ``mask``."""
    flat = mask.reshape(-1)
    keys = np.asarray(key_codes).reshape(-1)
    out = np.zeros_like(flat)
    idx = np.nonzero(flat)[0]
    if idx.size == 0:
        return out.reshape(mask.shape)
    k = keys[idx]
    # running index within key: stable sort by key, position - first-position
    order = np.argsort(k, kind="stable")
    ks = k[order]
    first = np.concatenate(([True], ks[1:] != ks[:-1]))
    group_start = np.maximum.accumulate(np.where(first, np.arange(ks.size), 0))
    within = np.arange(ks.size) - group_start
    keep = np.zeros(ks.size, bool)
    keep[order] = (within % n) == 0
    out[idx[keep]] = True
    return out.reshape(mask.shape)


def _keep_in_groups(mask: torch.Tensor, n: int, groups: torch.Tensor,
                    n_groups: int) -> torch.Tensor:
    """Keep the 1st, (n+1)th, ... matched row of each group in row order
    (groups in [0, n_groups); others are never kept). One stable sort by
    group gives every row its rank within the group, the same ranks as the
    reference's one masked cumsum per group."""
    flat = mask.reshape(-1)
    g = groups.reshape(-1).to(torch.int32)
    g = torch.where(flat & (g >= 0) & (g < n_groups), g,
                    torch.full_like(g, n_groups))
    sk, perm = torch.sort(g, stable=True)
    first = torch.searchsorted(sk, sk)
    rank = torch.arange(sk.numel(), device=sk.device) - first
    keep = torch.zeros_like(flat)
    keep[perm] = (sk < n_groups) & (rank % n == 0)
    return keep.reshape(mask.shape)


def sampling_mask_by_key_device(mask: torch.Tensor, n: int, codes: torch.Tensor,
                                vocab_size: int) -> torch.Tensor:
    """Exact per-key counter for int32 keys coded in [-1, vocab_size)
    (-1 = null, its own group, as on the host)."""
    return _keep_in_groups(mask, n, codes.to(torch.int32) + 1, vocab_size + 1)


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Deterministic hash bucket of int keys: the reference's 32-bit
    splitmix-style mixer, masked to ``n_buckets`` (a power of two). uint32
    arithmetic is emulated in int64, each 32-bit product taken in 16-bit
    halves so nothing overflows."""
    m32 = 0xFFFFFFFF

    def mul32(h, c):
        lo = h * (c & 0xFFFF)
        hi = ((h * (c >> 16)) & 0xFFFF) << 16
        return (lo + hi) & m32

    h = keys.to(torch.int64) & m32
    h = mul32(h ^ (h >> 16), 0x7FEB352D)
    h = mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return (h & (n_buckets - 1)).to(torch.int32)


def bucket_of_np(keys, n_buckets: int) -> np.ndarray:
    """Host twin of :func:`bucket_of` (native uint32 arithmetic)."""
    h = np.asarray(keys).astype(np.uint32)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x7FEB352D)
    h = (h ^ (h >> np.uint32(15))) * np.uint32(0x846CA68B)
    h = h ^ (h >> np.uint32(16))
    return (h & np.uint32(n_buckets - 1)).astype(np.int32)


def sampling_mask_by_key_hash(mask: torch.Tensor, n: int, keys: torch.Tensor,
                              n_buckets: int) -> torch.Tensor:
    """Per-key sampling for wide key spaces: keys hash into ``n_buckets``
    groups, each keeps a deterministic 1-in-n of its matches in row order.
    Keys sharing a bucket share a counter: the reference's documented
    approximation of an exact per-key counter."""
    return _keep_in_groups(mask, n, bucket_of(keys, n_buckets), n_buckets)


def sampling_mask_by_key_hash_np(mask: np.ndarray, n: int, keys,
                                 n_buckets: int) -> np.ndarray:
    """Host twin of :func:`sampling_mask_by_key_hash`."""
    return sampling_mask_by_key(mask, n, bucket_of_np(keys, n_buckets))
