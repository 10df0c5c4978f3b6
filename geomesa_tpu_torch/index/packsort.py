"""Radix pack-sort: the bulk-ingest sort engine (NumPy path), and the
order-preserving key maps and fid hash the index tables sort by.

Copy of ``geomesa_tpu/index/packsort.py`` without the native C++ pack /
unpack and hash. Packs ``[prefix | quantized key | tiebreak | row index]``
into one uint64, value-sorts it, and unpacks both the permutation and the
sorted quantized key column from the same array. The stored key is the
QUANTIZED key; window resolution shifts its query bounds identically, so
windows stay supersets. Keys, shifts and hashes match the JAX package bit
for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from geomesa_tpu_torch.schema.columns import _u_to_s

#: refuse to quantize a key below this many bits (fall back to argsort)
MIN_KEY_BITS = 16


def bits_for(n: int) -> int:
    """Bits needed to represent values 0..n-1 (at least 1)."""
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def to_ordered_u64(a: np.ndarray) -> Tuple[np.ndarray, int]:
    """Order-preserving map of a numeric column into uint64: (u64 array,
    significant bits). 32-bit types map losslessly; 64-bit types use their
    full width (callers quantize by shifting, which keeps order)."""
    k = a.dtype.kind
    if a.dtype == np.int32:
        return (a.astype(np.int64) + 2**31).astype(np.uint64), 32
    if a.dtype == np.uint32:
        return a.astype(np.uint64), 32
    if a.dtype == np.int64:
        return (a.astype(np.uint64) + np.uint64(2**63)), 64
    if a.dtype == np.uint64:
        return a, 64
    if a.dtype == np.float32:
        b = a.view(np.uint32).astype(np.uint64)
        sign = (b >> np.uint64(31)).astype(bool)
        return np.where(sign, np.uint64(2**32 - 1) - b, b + np.uint64(2**31)), 33
    if a.dtype == np.float64:
        b = a.view(np.uint64)
        sign = (b >> np.uint64(63)).astype(bool)
        return np.where(sign, ~b, b | np.uint64(2**63)), 64
    if k == "b":
        return a.astype(np.uint64), 1
    if a.dtype == np.int16 or a.dtype == np.int8:
        return (a.astype(np.int64) + 2**15).astype(np.uint64), 16
    raise TypeError(f"no u64 ordering for dtype {a.dtype}")


def ordered_u64_scalar(v, dtype) -> int:
    """:func:`to_ordered_u64` of one query bound. Out-of-range integer
    bounds clamp to the dtype's limits (still a superset)."""
    dt = np.dtype(dtype)
    if dt.kind in "iu" and not isinstance(v, float):
        info = np.iinfo(dt)
        v = min(max(int(v), info.min), info.max)
    out, _ = to_ordered_u64(np.asarray([v], dtype=dt))
    return int(out[0])


def pack_sort(
    key: np.ndarray,
    key_bits: int,
    prefix: Optional[np.ndarray] = None,
    tiebreak: Optional[np.ndarray] = None,
    tiebreak_bits: int = 0,
    force_shift: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]]:
    """Sort rows by (prefix, key[, tiebreak]) via one packed radix sort.

    ``tiebreak``: optional uint64 whose top bits order equal keys (locality
    only; not stored). ``force_shift`` pins the key quantization (an LSM
    append must match the existing table's stored keys); None picks the
    finest shift that fits. Returns (perm, key_quantized_sorted uint64,
    prefix_sorted or None, key_shift), or None when the bit budget leaves
    the key too coarse (or cannot hold the forced quantization)."""
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
    spare = avail - kq_bits
    tb_bits = min(tiebreak_bits, spare) if tiebreak is not None else 0
    kq = key >> np.uint64(shift) if shift else key
    packed = kq << np.uint64(idx_bits + tb_bits)
    if tb_bits:
        packed |= (tiebreak >> np.uint64(64 - tb_bits)) << np.uint64(idx_bits)
    if prefix is not None:
        # subtract in int64 then reinterpret as u64 (values nonnegative)
        p64 = (prefix.astype(np.int64, copy=False) - np.int64(pmin)).view(np.uint64)
        packed |= p64 << np.uint64(64 - prefix_bits)
    packed |= np.arange(n, dtype=np.uint64)
    packed.sort()
    perm = (packed & np.uint64((1 << idx_bits) - 1)).astype(
        np.int32 if n < 2**31 else np.int64
    )
    key_sorted = (packed >> np.uint64(idx_bits + tb_bits)) & np.uint64(
        (1 << kq_bits) - 1
    )
    prefix_sorted = None
    if prefix is not None:
        prefix_sorted = (
            (packed >> np.uint64(64 - prefix_bits)).view(np.int64) + np.int64(pmin)
        ).astype(prefix.dtype, copy=False)
    return perm, key_sorted, prefix_sorted, shift


_HASH_PRIMES = np.array(
    [
        0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
        0x27D4EB2F165667C5, 0x85EBCA77C2B2AE63, 0xFF51AFD7ED558CCD,
        0xC4CEB9FE1A85EC53, 0x2545F4914F6CDD1D,
    ],
    dtype=np.uint64,
)


def fid_hash64(fids: np.ndarray) -> np.ndarray:
    """Order-free 64-bit hash of a string / bytes column, vectorized:
    UTF-8 bytes NUL-padded to 8-byte chunks, ``XOR_j(chunk_j * prime_j)``,
    then an avalanche. Width-independent (zero chunks add nothing), and
    always over the UTF-8 byte form, so an id hashes the same from any
    array layout. The id index sorts by it; lookups hash query ids the
    same way and the exact fid mask resolves collisions."""
    a = np.asarray(fids)
    if a.dtype.kind == "O":
        a = a.astype(str)
    if a.dtype.kind == "U":
        a = _u_to_s(a)
        if a.dtype.kind == "U":  # non-ASCII present: per-element UTF-8
            a = np.char.encode(a, "utf-8")
    if a.dtype.kind != "S":
        raise TypeError(f"fid hash needs a string column, got {a.dtype}")
    w = a.dtype.itemsize
    n = len(a)
    k = (w + 7) // 8
    m = np.zeros((n, k * 8), np.uint8)
    m[:, :w] = np.frombuffer(a.tobytes(), dtype=np.uint8).reshape(n, w)
    q = m.view(np.uint64)
    h = np.zeros(n, np.uint64)
    for j in range(k):
        h ^= q[:, j] * _HASH_PRIMES[j % 8]
    # avalanche so quantized top bits spread (the table stores h >> shift)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(29)
    return h


def fid_hash64_one(fid: str) -> int:
    """Scalar counterpart of :func:`fid_hash64` (query-time lookups)."""
    return int(fid_hash64(np.asarray([fid]))[0])
