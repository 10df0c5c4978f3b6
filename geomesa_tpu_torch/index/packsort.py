"""Radix pack-sort: the bulk-ingest sort engine (NumPy path).

Copy of ``geomesa_tpu/index/packsort.py::pack_sort`` (with its
``force_shift``) without the native C++ pack/unpack or the tiebreak key.
Packs ``[prefix | quantized key | row index]`` into one uint64, value-sorts
it, and unpacks both the permutation and the sorted quantized key column
from the same array. The stored key is the QUANTIZED key; window
resolution shifts its query bounds identically, so windows stay supersets.
The quantization and shifts match the JAX package bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: refuse to quantize a key below this many bits (fall back to argsort)
MIN_KEY_BITS = 16


def bits_for(n: int) -> int:
    """Bits needed to represent values 0..n-1 (at least 1)."""
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def pack_sort(
    key: np.ndarray,
    key_bits: int,
    prefix: Optional[np.ndarray] = None,
    force_shift: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]]:
    """Sort rows by (prefix, key) via one packed radix sort.

    ``force_shift`` pins the key quantization (an LSM append must match the
    existing table's stored keys); None picks the finest shift that fits.
    Returns (perm, key_quantized_sorted uint64, prefix_sorted or None,
    key_shift), or None when the bit budget leaves the key too coarse (or
    cannot hold the forced quantization)."""
    n = len(key)
    if n == 0:
        return None
    idx_bits = bits_for(n)
    if prefix is not None:
        pmin = int(prefix.min())
        prefix_bits = bits_for(int(prefix.max()) - pmin + 1)
    else:
        pmin = 0
        prefix_bits = 0
    avail = 64 - idx_bits - prefix_bits
    if avail <= 0:
        return None
    shift = max(0, key_bits - avail) if force_shift is None else force_shift
    kq_bits = key_bits - shift
    if kq_bits < min(MIN_KEY_BITS, key_bits) or kq_bits > avail or kq_bits <= 0:
        return None
    kq = key >> np.uint64(shift) if shift else key
    packed = kq << np.uint64(idx_bits)
    if prefix is not None:
        # subtract in int64 then reinterpret as u64 (values nonnegative)
        p64 = (prefix.astype(np.int64, copy=False) - np.int64(pmin)).view(np.uint64)
        packed |= p64 << np.uint64(64 - prefix_bits)
    packed |= np.arange(n, dtype=np.uint64)
    packed.sort()
    perm = (packed & np.uint64((1 << idx_bits) - 1)).astype(
        np.int32 if n < 2**31 else np.int64
    )
    key_sorted = (packed >> np.uint64(idx_bits)) & np.uint64((1 << kq_bits) - 1)
    prefix_sorted = None
    if prefix is not None:
        prefix_sorted = (
            (packed >> np.uint64(64 - prefix_bits)).view(np.int64) + np.int64(pmin)
        ).astype(prefix.dtype, copy=False)
    return perm, key_sorted, prefix_sorted, shift
