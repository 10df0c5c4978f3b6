"""Footer-indexed blob container and lossless column encoding.

Copy of ``geomesa_tpu/lake/format.py``. The file grammar::

    [8B magic "GMLAKE01"]
    [blob 0][blob 1]...[blob B-1]          # encoded bytes, contiguous
    [footer: JSON, utf-8]
    [8B footer length, little-endian][8B magic]

The footer holds the blob table (offset, length, crc32 per blob) and
whatever the layer above stores (row groups, statistics). A reader reads
the 16-byte tail and the footer, then exactly the blobs it wants.

Column encoding is lossless and self-describing, and its bytes equal the
JAX package's for the same array:

* integer and datetime columns: zigzag(delta) bit-packed at the least
  width that holds every code;
* float columns: the raw IEEE bits, delta-encoded the same way;
* bool: packbits; strings (U/S) and anything else: an npy payload;
* ``raw`` bytes whenever the packed form would not be smaller.

The bit packing works on 64-bit words: 64 values of ``w`` bits fill ``w``
words exactly, so a column packs in 64 vectorized shift-or steps over
``n / 64`` rows, with no per-bit temporaries, and only when the packed
length (known from the width) beats the raw bytes. A crc mismatch, a bad magic
or a torn footer raises :class:`LakeCorruptError`; the partitioned store
quarantines the snapshot (``index/partitioned.py``). Each blob write and
read passes the ``lake.write`` / ``lake.read`` fault point.
"""

from __future__ import annotations

import io
import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import metrics, resilience

MAGIC = b"GMLAKE01"
_TAIL = len(MAGIC) + 8


class LakeCorruptError(ValueError):
    """A structural failure: bad magic, torn footer, truncated blob or
    crc mismatch."""


# -- bit packing --------------------------------------------------------------------
def _cycle(width: int):
    """(j, word, shift, spills) for the 64 values of one packing cycle:
    value j starts at bit ``j * width``, in word ``word`` at ``shift``, and
    spills into the next word when it crosses a word boundary."""
    for j in range(64):
        o = j * width
        word, shift = o >> 6, o & 63
        yield j, word, shift, shift + width > 64


def _pack_u64(values: np.ndarray, width: int) -> bytes:
    """Little-endian bit-pack ``values`` (uint64, each below 2**width) to
    ``width`` bits each: value i holds bits [i*width, (i+1)*width) of the
    stream, least significant bit first."""
    n = len(values)
    if width == 0 or not n:
        return b""
    g = -(-n // 64)
    v = np.zeros(g * 64, np.uint64)
    v[:n] = values
    v = np.ascontiguousarray(v.reshape(g, 64).T)  # row j: value j of each cycle
    words = np.zeros((width, g), np.uint64)
    for j, word, shift, spills in _cycle(width):
        words[word] |= v[j] << np.uint64(shift)
        if spills:
            words[word + 1] |= v[j] >> np.uint64(64 - shift)
    return np.ascontiguousarray(words.T).astype("<u8", copy=False).tobytes()[: -(-n * width // 8)]


def _unpack_u64(buf: bytes, width: int, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_u64`: uint64 [n]."""
    if width == 0 or n == 0:
        return np.zeros(n, np.uint64)
    g = -(-n // 64)
    raw = np.zeros(g * width * 8, np.uint8)
    src = np.frombuffer(buf, np.uint8)
    raw[: len(src)] = src
    words = np.ascontiguousarray(raw.view("<u8").astype(np.uint64, copy=False)
                                 .reshape(g, width).T)
    mask = np.uint64((1 << width) - 1)
    out = np.empty((64, g), np.uint64)
    for j, word, shift, spills in _cycle(width):
        col = words[word] >> np.uint64(shift)
        if spills:
            col |= words[word + 1] << np.uint64(64 - shift)
        col &= mask
        out[j] = col
    return out.T.reshape(-1)[:n]


def _zigzag(d: np.ndarray) -> np.ndarray:
    """int64 -> uint64 zigzag (small magnitudes -> small codes)."""
    d = d.astype(np.int64, copy=False)
    z = d << np.int64(1)
    z ^= d >> np.int64(63)
    return z.view(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.view(np.int64)
    out = z >> np.int64(1)
    out ^= -(z & np.int64(1))
    return out


# -- array encoding -------------------------------------------------------------------
def encode_array(a: np.ndarray) -> Tuple[Dict[str, Any], bytes]:
    """Encode one column chunk losslessly: ``(meta, payload)``; ``meta``
    is JSON-able and enough for :func:`decode_array`."""
    a = np.ascontiguousarray(a)
    kind = a.dtype.kind
    if a.ndim == 1 and kind in "iufM" and a.dtype.itemsize in (1, 2, 4, 8):
        # int64 bit patterns: wrapping delta arithmetic is exact and
        # self-inverse whatever the signedness or float layout
        if kind == "f":
            bits = a.view(f"u{a.dtype.itemsize}").astype(np.uint64)
        elif kind == "M":
            bits = a.view(np.int64).view(np.uint64)
        else:
            bits = a.astype(np.int64, copy=False).view(np.uint64) \
                if kind == "i" else a.astype(np.uint64, copy=False)
        d = np.empty_like(bits, dtype=np.uint64)
        if len(bits):
            d[0] = bits[0]
            np.subtract(bits[1:], bits[:-1], out=d[1:])  # wrapping
        # the largest zigzag code, from the deltas' extremes: 2d for d >= 0,
        # -2d - 1 below; the packed length then says whether packing wins
        di = d.view(np.int64)
        top = max(2 * int(di.max()), -2 * int(di.min()) - 1) if len(di) else 0
        width = top.bit_length() if top else (1 if len(di) else 0)
        if -(-len(a) * width // 8) < a.nbytes:
            return ({"enc": "delta", "dtype": str(a.dtype), "n": len(a),
                     "width": width}, _pack_u64(_zigzag(di), width))
        return ({"enc": "raw", "dtype": str(a.dtype), "n": len(a)}, a.tobytes())
    if a.ndim == 1 and kind == "b":
        return ({"enc": "bits", "dtype": "bool", "n": len(a)},
                np.packbits(a.view(np.uint8), bitorder="little").tobytes())
    if kind == "O":
        a = a.astype("U")
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return ({"enc": "npy"}, buf.getvalue())


def decode_array(meta: Dict[str, Any], payload: bytes) -> np.ndarray:
    enc = meta["enc"]
    if enc == "delta":
        n, width = int(meta["n"]), int(meta["width"])
        d = _unzigzag(_unpack_u64(payload, width, n)).view(np.uint64)
        bits = np.cumsum(d, dtype=np.uint64)  # wrapping inverse of diff
        dt = np.dtype(meta["dtype"])
        if dt.kind == "f":
            return bits.astype(f"u{dt.itemsize}").view(dt) \
                if dt.itemsize != 8 else bits.view(dt)
        if dt.kind == "M":
            return bits.view(np.int64).view(dt)
        if dt.kind == "i":
            return bits.view(np.int64).astype(dt)
        return bits.astype(dt)
    if enc == "raw":
        return np.frombuffer(payload, np.dtype(meta["dtype"])).copy()
    if enc == "bits":
        n = int(meta["n"])
        return np.unpackbits(np.frombuffer(payload, np.uint8),
                             bitorder="little")[:n].astype(bool)
    if enc == "npy":
        return np.load(io.BytesIO(payload), allow_pickle=False)
    raise LakeCorruptError(f"unknown lake encoding {enc!r}")


# -- container ------------------------------------------------------------------------
class LakeWriter:
    """Streaming writer: blobs append in call order; :meth:`finish` seals
    the footer and tail. The caller owns the tmp-then-rename step."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "wb")
        self._fh.write(MAGIC)
        self._off = len(MAGIC)
        #: blob table rows: [offset, length, crc32]
        self.blobs: List[List[int]] = []

    def add_blob(self, payload: bytes) -> int:
        """Append one blob; returns its index in the blob table."""
        resilience.fault_point("lake.write", path=self.path, blob=len(self.blobs))
        self._fh.write(payload)
        self.blobs.append([self._off, len(payload), zlib.crc32(payload) & 0xFFFFFFFF])
        self._off += len(payload)
        return len(self.blobs) - 1

    def add_array(self, a: np.ndarray) -> Dict[str, Any]:
        """Encode and append one column chunk; returns its JSON-able ref
        (``{"b": blob index, ...encoding meta, "nbytes": ...}``)."""
        meta, payload = encode_array(a)
        meta["b"] = self.add_blob(payload)
        meta["nbytes"] = len(payload)
        return meta

    def finish(self, footer: Dict[str, Any]) -> None:
        footer = dict(footer)
        footer["blobs"] = self.blobs
        raw = json.dumps(footer, separators=(",", ":")).encode()
        self._fh.write(raw)
        self._fh.write(len(raw).to_bytes(8, "little"))
        self._fh.write(MAGIC)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()

    def abort(self) -> None:
        try:
            self._fh.close()
        finally:
            try:
                os.remove(self.path)
            except OSError:
                pass


class LakeFile:
    """Range reader over one lake file. Opening reads only the tail and the
    footer; blobs load on demand with their crc checked.

    The handle opened here is held for the reader's life and every blob
    read goes through it: a lazy decode (a pruned child's columns) can come
    after a re-spill replaced the file at the same path, and reopening by
    path would read the new file at the old footer's offsets. An unlinked
    but open file keeps serving its own bytes."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        fh = self._fh = open(path, "rb")
        try:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size < len(MAGIC) + _TAIL:
                raise LakeCorruptError(f"{path}: truncated lake file")
            fh.seek(size - _TAIL)
            tail = fh.read(_TAIL)
            if tail[8:] != MAGIC:
                raise LakeCorruptError(f"{path}: bad tail magic")
            flen = int.from_bytes(tail[:8], "little")
            foot_at = size - _TAIL - flen
            if flen <= 0 or foot_at < len(MAGIC):
                raise LakeCorruptError(f"{path}: bad footer length {flen}")
            fh.seek(0)
            if fh.read(len(MAGIC)) != MAGIC:
                raise LakeCorruptError(f"{path}: bad head magic")
            fh.seek(foot_at)
            try:
                self.footer: Dict[str, Any] = json.loads(fh.read(flen))
            except ValueError as e:
                raise LakeCorruptError(f"{path}: torn footer: {e}") from e
        except BaseException:
            fh.close()
            raise
        self.blobs: List[List[int]] = self.footer.get("blobs", [])
        metrics.inc(metrics.LAKE_BYTES_READ, flen + _TAIL)

    def close(self) -> None:
        self._fh.close()

    def read_blob(self, ref: int) -> bytes:
        off, length, crc = self.blobs[ref]
        resilience.fault_point("lake.read", path=self.path, blob=ref)
        with self._lock:
            self._fh.seek(off)
            payload = self._fh.read(length)
        if len(payload) != length:
            raise LakeCorruptError(
                f"{self.path}: blob {ref} truncated ({len(payload)}/{length} bytes)")
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise LakeCorruptError(f"{self.path}: blob {ref} crc mismatch")
        metrics.inc(metrics.LAKE_BYTES_READ, length)
        return payload

    def read_array(self, ref_meta: Dict[str, Any]) -> np.ndarray:
        return decode_array(ref_meta, self.read_blob(int(ref_meta["b"])))

    def blob_nbytes(self, ref_meta: Optional[Dict[str, Any]]) -> int:
        if ref_meta is None:
            return 0
        return int(self.blobs[int(ref_meta["b"])][1])
