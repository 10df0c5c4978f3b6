"""Durable mutation journal: a per-root write-ahead log with group commit.

Copy of ``geomesa_tpu/fs/journal.py``. The store lives in memory between
explicit checkpoints (``GeoDataset.save``), so an acked insert, delete or
schema change made after the last checkpoint would die with the process.
With the journal attached, every mutation appends a typed record first
and returns only once the record is on disk (ack = durable):

* **Framing**: each record is one crc32-guarded frame,
  ``u32le json_len | u32le blob_len | u32le crc32(json + blob) | json |
  blob``, appended to a segment file ``<root>/journal/seg-<start seq>-<pid>.gmj``
  that begins with the magic ``GMJ2``. Bulk arrays ride the raw blob
  section (``ndr`` markers in the JSON), so the JSON encoder never scans
  them. A torn tail (a crash mid-write) is truncated at the last valid
  frame when the journal opens; it never fails the root.
* **Group commit**: the first appender to take the commit mutex writes
  every pending frame with one ``write`` and one ``fsync``; frames that
  arrive during that fsync ride the next round. After a round that held
  more than one frame, the next leader first waits
  ``geomesa.journal.group.ms`` to widen its group.
* **Checkpoints**: ``GeoDataset.save`` stamps each schema's manifest
  entry with the journal position it captured and then deletes the
  segments every schema has checkpointed past (:meth:`MutationJournal.checkpoint`);
  ``GeoDataset.load`` replays the records past each schema's position, in
  sequence order.
* **Fault points**: ``journal.append`` (the appending thread, before the
  record is queued), ``journal.fsync`` (the committing thread, before each
  group's fsync) and ``journal.replay`` (per segment read), as the
  reference's.

Each journal also keeps its own counters (:meth:`MutationJournal.counters`)
beside the process registry's ``journal.*`` series, which it bumps where
the reference does. Not here: the fleet epoch marker.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import threading
import time
import weakref
import zlib
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config, metrics, resilience
from geomesa_tpu_torch.resilience import fsync_dir

#: json bytes, blob bytes, crc32(json + blob)
_FRAME_HDR = struct.Struct("<III")
_SEG_MAGIC = b"GMJ2"
_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".gmj"
JOURNAL_DIR = "journal"


class JournalError(Exception):
    """A journal append could not be made durable (the mutation that asked
    for it must not be acked)."""


# -- typed record payloads (exact round trip, JSON carrier) ---------------------------------

_PLIST_TYPES = frozenset({bool, int, float, str, type(None)})


def enc_value(v: Any, sink: Optional[List[bytes]] = None) -> Any:
    """Encode one value (or column of values) to a JSON-safe form that
    :func:`dec_value` restores exactly: tuples stay tuples, arrays keep
    their dtype and bits, datetimes keep ms precision.

    With a ``sink`` (the list handed to :meth:`MutationJournal.append` as
    ``blobs``) an array's raw bytes go to the frame's blob section and the
    JSON carries an ``ndr`` marker; without one, base64 in the JSON
    (``ndb``)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.datetime64):
        return {"~": "dt64", "v": int(v.astype("datetime64[ms]").astype(np.int64))}
    if isinstance(v, np.generic):
        return enc_value(v.item())
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "M":
            v = v.astype("datetime64[ms]")
        if v.dtype.kind in "OU":
            return {"~": "list", "v": [enc_value(x, sink) for x in v.tolist()]}
        a = np.ascontiguousarray(v)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        if sink is not None:
            raw = a.tobytes()
            sink.append(raw)
            return {"~": "ndr", "d": str(a.dtype), "s": list(a.shape),
                    "i": len(sink) - 1, "n": len(raw)}
        return {"~": "ndb", "d": str(a.dtype), "s": list(a.shape),
                "v": base64.b64encode(a.tobytes()).decode()}
    if isinstance(v, tuple):
        return {"~": "tup", "v": [enc_value(x, sink) for x in v]}
    if isinstance(v, list):
        # a list of JSON scalars rides verbatim (one type() per element)
        if set(map(type, v)) <= _PLIST_TYPES:
            return {"~": "plist", "v": v}
        return {"~": "list", "v": [enc_value(x, sink) for x in v]}
    if isinstance(v, bytes):
        return {"~": "b64", "v": base64.b64encode(v).decode()}
    if isinstance(v, dict):
        return {"~": "map", "v": {str(k): enc_value(x, sink) for k, x in v.items()}}
    raise TypeError(f"unjournalable value type {type(v).__name__}")


def dec_value(v: Any) -> Any:
    if not isinstance(v, dict):
        return v
    t = v["~"]
    if t == "dt64":
        return np.datetime64(int(v["v"]), "ms")
    if t == "ndt":
        return np.asarray(v["v"], np.int64).astype("datetime64[ms]")
    if t == "nd":
        return np.asarray(v["v"], np.dtype(v["d"]))
    if t in ("ndb", "ndr"):
        if t == "ndb":
            raw = base64.b64decode(v["v"])
        else:
            # the blob bytes were attached when the segment was read
            raw = v.get("_raw")
            if raw is None:
                raise ValueError("ndr marker with no attached blob bytes")
        a = np.frombuffer(raw, np.dtype(v["d"]))
        return a.reshape(v.get("s") or (a.size,)).copy()
    if t == "plist":
        return list(v["v"])
    if t == "tup":
        return tuple(dec_value(x) for x in v["v"])
    if t == "list":
        return [dec_value(x) for x in v["v"]]
    if t == "b64":
        return base64.b64decode(v["v"])
    if t == "map":
        return {k: dec_value(x) for k, x in v["v"].items()}
    raise ValueError(f"unknown journal value tag {t!r}")


def enc_columns(data: Dict[str, Any], sink: Optional[List[bytes]] = None) -> Dict[str, Any]:
    return {k: enc_value(v, sink) for k, v in data.items()}


def dec_columns(data: Dict[str, Any]) -> Dict[str, Any]:
    return {k: dec_value(v) for k, v in data.items()}


def _attach_blobs(rec: Dict[str, Any], blob: bytes) -> None:
    """Attach the frame's blob section to the record's ``ndr`` markers in
    place, by each marker's declared length in blob-index order."""
    markers: List[Dict[str, Any]] = []

    def walk(o: Any) -> None:
        if isinstance(o, dict):
            if o.get("~") == "ndr":
                markers.append(o)
                return
            for x in o.values():
                walk(x)
        elif isinstance(o, list):
            for x in o:
                walk(x)

    walk(rec)
    off = 0
    for m in sorted(markers, key=lambda m: int(m.get("i", 0))):
        n = int(m.get("n", 0))
        m["_raw"] = blob[off:off + n]
        off += n


def frame(record: Dict[str, Any], blob: bytes = b"") -> bytes:
    """One record's frame (the record already carries its ``seq``)."""
    payload = json.dumps(record, separators=(",", ":")).encode()
    crc = zlib.crc32(blob, zlib.crc32(payload)) & 0xFFFFFFFF
    return _FRAME_HDR.pack(len(payload), len(blob), crc) + payload + blob


# -- the journal ------------------------------------------------------------------------------

class _Pending:
    __slots__ = ("frame", "event", "error")

    def __init__(self, frame_bytes: bytes):
        self.frame = frame_bytes
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


#: every live journal of the process (the /healthz journal section)
_JOURNALS: "weakref.WeakSet" = weakref.WeakSet()


def lag_snapshot() -> Dict[str, int]:
    """root -> appended records not yet durable, across every live journal
    of the process."""
    out: Dict[str, int] = {}
    for j in list(_JOURNALS):
        try:
            out[j.root] = j.lag()
        except Exception:
            continue
    return out


class MutationJournal:
    """Append-only, crc-framed, fsynced mutation log of one storage root.

    :meth:`append` blocks until the record is durable and returns its
    sequence number; :meth:`records` replays in sequence order;
    :meth:`checkpoint` deletes the segments a ``save`` covered. Counters
    (appends, fsyncs, group sizes, torn tails, truncated bytes) are
    reported by :meth:`status`."""

    def __init__(self, root: str, create: bool = True):
        self.root = root
        self.dir = os.path.join(root, JOURNAL_DIR)
        if create and not os.path.isdir(self.dir):
            os.makedirs(self.dir, exist_ok=True)
            fsync_dir(os.path.abspath(root))
        self._lock = threading.Lock()          # seq, pending queue, counters
        self._io_lock = threading.Lock()       # the segment file handle
        self._commit_mutex = threading.Lock()  # at most one commit leader
        self._fh = None
        self._seg_bytes = 0
        self._pending: List[_Pending] = []
        self._widen = False
        self._closed = False
        self.group_ms = _to_float(config.JOURNAL_GROUP_MS, 2.0)
        self.segment_bytes = max(1 << 16, config.JOURNAL_SEGMENT_BYTES.to_int() or (8 << 20))
        self._seq = 0
        self.appends = 0
        self.fsyncs = 0
        self.fsync_seconds = 0.0
        #: records per committed group -> groups
        self.group_sizes: Counter = Counter()
        self.torn_tails = 0
        self.truncated_bytes = 0
        self._recover_segments()
        _JOURNALS.add(self)
        # the process-wide pending-frame gauge (per root: lag_snapshot)
        metrics.registry().gauge(
            metrics.JOURNAL_LAG,
            fn=lambda: float(sum(lag_snapshot().values())), replace=True)

    # -- write path -------------------------------------------------------------------
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def adopt_seq(self, seq: int) -> None:
        """Continue the sequence after ``seq`` at least (a checkpoint's
        stamp, when no segment holds it any more)."""
        with self._lock:
            self._seq = max(self._seq, int(seq))

    def lag(self) -> int:
        """Appended records not yet durable."""
        with self._lock:
            return len(self._pending)

    def append(self, record: Dict[str, Any], blobs: Optional[List[bytes]] = None) -> int:
        """Frame and group-commit one record; blocks until it is on disk
        (or raises :class:`JournalError`, and then the caller must not ack
        the mutation). Returns its sequence number. ``blobs``: the sink
        :func:`enc_columns` / :func:`enc_value` filled."""
        if self._closed:
            raise JournalError("journal is closed")
        resilience.fault_point("journal.append", kind=record.get("kind"),
                               schema=record.get("schema"), root=self.root)
        blob = b"".join(blobs) if blobs else b""
        with self._lock:
            self._seq += 1
            record = dict(record)
            record["seq"] = seq = self._seq
            p = _Pending(frame(record, blob))
            self._pending.append(p)
        self._commit_or_follow(p)
        if p.error is not None:
            raise JournalError(f"journal append not durable: {p.error!r}") from p.error
        with self._lock:
            self.appends += 1
        metrics.inc(metrics.JOURNAL_APPENDS)
        return seq

    def _commit_or_follow(self, p: _Pending) -> None:
        # Leader-based group commit: the first appender to take the mutex
        # drains the whole queue into one write + fsync; frames arriving
        # meanwhile ride the next leader's batch. The widening wait opens
        # only after a batch held more than one frame (concurrency seen),
        # so a lone writer runs at fsync speed.
        while not p.event.is_set():
            if self._commit_mutex.acquire(timeout=0.05):
                try:
                    if p.event.is_set():
                        return
                    if self._widen and self.group_ms > 0:
                        time.sleep(self.group_ms / 1000.0)
                    with self._lock:
                        batch, self._pending = self._pending, []
                    if batch:
                        self._widen = len(batch) > 1
                        self._commit_batch(batch)
                finally:
                    self._commit_mutex.release()
            else:
                p.event.wait(timeout=0.05)

    def _commit_batch(self, batch: List[_Pending]) -> None:
        err: Optional[BaseException] = None
        t0 = time.perf_counter()
        try:
            with self._io_lock:
                self._ensure_segment(sum(len(p.frame) for p in batch))
                self._fh.write(b"".join(p.frame for p in batch))
                self._fh.flush()
                resilience.fault_point("journal.fsync", root=self.root, batch=len(batch))
                os.fsync(self._fh.fileno())
        except BaseException as e:  # waiters must never hang
            err = e
            # the segment's tail is unknown after a failed write or fsync:
            # roll to a fresh segment (replay truncates the tear)
            with self._io_lock:
                self._close_segment()
        fsync_s = time.perf_counter() - t0
        with self._lock:
            self.fsyncs += 1
            self.fsync_seconds += fsync_s
            self.group_sizes[len(batch)] += 1
        metrics.registry().histogram(
            metrics.JOURNAL_FSYNC_MS, metrics.JOURNAL_FSYNC_BUCKETS_MS,
            unit=None).observe(fsync_s * 1000.0)
        metrics.registry().histogram(
            metrics.JOURNAL_GROUP_SIZE, metrics.JOURNAL_GROUP_BUCKETS,
            unit=None).observe(float(len(batch)))
        for p in batch:
            p.error = err
            p.event.set()

    def _ensure_segment(self, nbytes: int) -> None:
        if self._fh is not None and self._seg_bytes + nbytes > self.segment_bytes:
            self._close_segment()
        if self._fh is None:
            with self._lock:
                start = self._seq
            name = f"{_SEG_PREFIX}{start:016d}-{os.getpid()}{_SEG_SUFFIX}"
            os.makedirs(self.dir, exist_ok=True)  # the dir may have been swept
            self._fh = open(os.path.join(self.dir, name), "ab")
            if self._fh.tell() == 0:
                self._fh.write(_SEG_MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            fsync_dir(self.dir)  # the segment's directory entry is durable
            self._seg_bytes = self._fh.tell()
        # the bytes about to be written count toward the roll threshold
        # (the reference sets this only when a segment opens, so its
        # segments roll only for a single group above the threshold)
        self._seg_bytes += nbytes

    def _close_segment(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
            self._seg_bytes = 0

    def close(self) -> None:
        self._closed = True
        with self._commit_mutex:
            with self._lock:
                batch, self._pending = self._pending, []
            if batch:
                self._commit_batch(batch)
            with self._io_lock:
                self._close_segment()

    # -- read / recovery path -----------------------------------------------------
    def _segments(self) -> List[str]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        segs = [n for n in names if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)]
        # (start seq, pid) names order one process's segments by position
        # and break ties between processes deterministically
        return [os.path.join(self.dir, n) for n in sorted(segs)]

    def _truncate(self, path: str, good: int, total: int) -> None:
        if _truncate_segment(path, good):
            with self._lock:
                self.torn_tails += 1
                self.truncated_bytes += max(total - good, 0)
            metrics.registry().counter(
                metrics.JOURNAL_TRUNCATED_BYTES).inc(max(total - good, 0))
            metrics.inc(metrics.JOURNAL_TORN_TAILS)

    def _recover_segments(self) -> None:
        """Truncate torn tails now (before an append could extend past
        them) and adopt ``max(seq)``, so new records follow every durable
        one."""
        top = 0
        for path in self._segments():
            recs, good, total = _read_segment(path)
            if good < total:
                self._truncate(path, good, total)
            for r in recs:
                top = max(top, int(r.get("seq", 0)))
        self._seq = top

    def records(self, schema: Optional[str] = None, after_seq: int = 0,
                truncate: bool = False) -> List[Dict[str, Any]]:
        """Every valid record in sequence order. ``truncate=True`` also
        repairs torn tails on disk (recovery); leave it False on a root
        another process may still be appending to."""
        out: List[Dict[str, Any]] = []
        for path in self._segments():
            resilience.fault_point("journal.replay", segment=os.path.basename(path))
            recs, good, total = _read_segment(path)
            if good < total and truncate:
                self._truncate(path, good, total)
            out.extend(recs)
        if schema is not None:
            out = [r for r in out if r.get("schema") == schema]
        if after_seq:
            out = [r for r in out if int(r.get("seq", 0)) > after_seq]
        out.sort(key=lambda r: int(r.get("seq", 0)))
        return out

    def checkpoint(self, upto_seq: int) -> int:
        """Delete the segments whose every record has ``seq <= upto_seq``
        (a checkpoint covers them). The active segment closes first, so it
        qualifies too. Returns the bytes reclaimed."""
        with self._io_lock:
            self._close_segment()
            freed = 0
            for path in self._segments():
                recs, _good, _total = _read_segment(path)
                if recs and max(int(r.get("seq", 0)) for r in recs) > upto_seq:
                    continue
                try:
                    freed += os.path.getsize(path)
                    os.remove(path)
                except OSError:
                    continue
            if freed:
                fsync_dir(self.dir)
                with self._lock:
                    self.truncated_bytes += freed
                metrics.registry().counter(metrics.JOURNAL_TRUNCATED_BYTES).inc(freed)
        return freed

    # -- status --------------------------------------------------------------------
    def counters(self) -> Dict[str, Any]:
        """This journal's counters since it opened."""
        with self._lock:
            groups = dict(sorted(self.group_sizes.items()))
            return {
                "appends": self.appends,
                "fsyncs": self.fsyncs,
                "fsync_seconds": self.fsync_seconds,
                "groups": groups,
                "max_group": max(groups, default=0),
                "torn_tails": self.torn_tails,
                "truncated_bytes": self.truncated_bytes,
            }

    def status(self) -> Dict[str, Any]:
        segs = []
        n = 0
        for path in self._segments():
            recs, good, total = _read_segment(path)
            segs.append({
                "file": os.path.basename(path),
                "bytes": total,
                "records": len(recs),
                "seq_lo": min((int(r["seq"]) for r in recs), default=0),
                "seq_hi": max((int(r["seq"]) for r in recs), default=0),
                "torn_bytes": total - good,
            })
            n += len(recs)
        return {"dir": self.dir, "segments": segs, "records": n,
                "last_seq": self.last_seq(), "pending": self.lag(),
                "counters": self.counters()}


def _read_segment(path: str) -> Tuple[List[Dict[str, Any]], int, int]:
    """Parse one segment: ``(records, last good offset, total bytes)``. A
    crc mismatch, a short header or a short payload stops the parse at the
    last valid frame boundary (a torn tail)."""
    try:
        with open(path, "rb") as fh:
            buf = fh.read()
    except OSError:
        return [], 0, 0
    total = len(buf)
    off = len(_SEG_MAGIC) if buf[:len(_SEG_MAGIC)] == _SEG_MAGIC else 0
    recs: List[Dict[str, Any]] = []
    good = off
    while off + _FRAME_HDR.size <= total:
        jln, bln, crc = _FRAME_HDR.unpack_from(buf, off)
        start = off + _FRAME_HDR.size
        end = start + jln + bln
        if jln <= 0 or end > total:
            break
        if (zlib.crc32(buf[start:end]) & 0xFFFFFFFF) != crc:
            break
        try:
            rec = json.loads(buf[start:start + jln])
        except ValueError:
            break
        if bln:
            _attach_blobs(rec, buf[start + jln:end])
        recs.append(rec)
        off = good = end
    return recs, good, total


def _truncate_segment(path: str, good: int) -> bool:
    """Clip a torn tail at the last valid frame boundary (the partial frame
    was never acked). False when the file could not be truncated."""
    try:
        with open(path, "r+b") as fh:
            fh.truncate(good)
            fh.flush()
            os.fsync(fh.fileno())
    except OSError:
        return False
    return True


def _to_float(prop, default: float) -> float:
    try:
        v = prop.get()
        return default if v is None else float(v)
    except (TypeError, ValueError):
        return default


def journal_exists(root: str) -> bool:
    """True when ``root`` has a journal directory holding segments (the
    load-time attach decision; nothing is created here)."""
    try:
        return any(n.endswith(_SEG_SUFFIX) for n in os.listdir(os.path.join(root, JOURNAL_DIR)))
    except OSError:
        return False
