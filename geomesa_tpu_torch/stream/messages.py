"""Message layer: the GeoMessage wire format and an in-process topic bus.

Copy of ``geomesa_tpu/stream/messages.py``. Features travel as
``GeoMessage``s (change, delete, clear) on partitioned topics; consumers
track offsets. The in-process ``MessageBus`` plays the broker's role; the
byte wire format is the JAX package's, so the two packages' producers and
consumers read each other's bytes.

Wire format (little-endian):
    [1: kind (0=change 1=delete 2=clear)][8: timestamp ms]
    [2: fid len][fid utf8][4: payload len][payload json utf8]
"""

from __future__ import annotations

import json
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

CHANGE, DELETE, CLEAR = 0, 1, 2
_KINDS = {0: "change", 1: "delete", 2: "clear"}


@dataclass(frozen=True)
class GeoMessage:
    kind: int
    ts_ms: int
    fid: str = ""
    payload: Optional[Dict[str, Any]] = None

    @staticmethod
    def change(fid: str, attributes: Dict[str, Any], ts_ms: int) -> "GeoMessage":
        return GeoMessage(CHANGE, ts_ms, fid, attributes)

    @staticmethod
    def delete(fid: str, ts_ms: int) -> "GeoMessage":
        return GeoMessage(DELETE, ts_ms, fid)

    @staticmethod
    def clear(ts_ms: int) -> "GeoMessage":
        return GeoMessage(CLEAR, ts_ms)

    def serialize(self) -> bytes:
        fid_b = self.fid.encode()
        payload_b = b"" if self.payload is None else json.dumps(self.payload).encode()
        return (
            struct.pack("<BqH", self.kind, self.ts_ms, len(fid_b))
            + fid_b
            + struct.pack("<I", len(payload_b))
            + payload_b
        )

    @staticmethod
    def deserialize(data: bytes) -> "GeoMessage":
        kind, ts, fid_len = struct.unpack_from("<BqH", data, 0)
        off = 11
        fid = data[off : off + fid_len].decode()
        off += fid_len
        (plen,) = struct.unpack_from("<I", data, off)
        off += 4
        payload = json.loads(data[off : off + plen]) if plen else None
        return GeoMessage(kind, ts, fid, payload)


class Topic:
    """An append-only partitioned log with consumer offsets (broker analog).

    Messages are stored serialized — producers/consumers always cross the
    byte boundary, keeping the wire format honest."""

    def __init__(self, name: str, partitions: int = 4):
        self.name = name
        self.partitions = partitions
        self._logs: List[List[bytes]] = [[] for _ in range(partitions)]
        self._lock = threading.Lock()

    def send(self, msg: GeoMessage):
        # fid-hash partitioner: the same feature id always lands on the
        # same partition, which keeps each feature's order. Python salts
        # str hashes per process, so a fid's partition differs between
        # processes and agrees within one. Control messages (CLEAR) go to
        # partition 0 only: the consumer reads every partition, so one
        # delivery suffices and listeners fire exactly once
        p = (hash(msg.fid) & 0x7FFFFFFF) % self.partitions if msg.fid else 0
        data = msg.serialize()
        with self._lock:
            self._logs[p].append(data)

    def poll(self, offsets: List[int], max_messages: int = 10_000,
             on_error=None) -> Tuple[List[GeoMessage], List[int]]:
        """Read from per-partition ``offsets``; returns (messages, new offsets).

        ``on_error(partition, offset, raw_bytes, exc)`` — when given, an
        undecodable (poison) message is reported and SKIPPED, and the offset
        still advances past it; without it, decode errors raise (a consumer
        that doesn't opt into quarantine must not silently lose data)."""
        from geomesa_tpu_torch import resilience

        out: List[GeoMessage] = []
        new = list(offsets)
        with self._lock:
            for p in range(self.partitions):
                log = self._logs[p]
                end = min(len(log), offsets[p] + max_messages)
                for i in range(offsets[p], end):
                    try:
                        resilience.fault_point(
                            "stream.poll.decode", topic=self.name,
                            partition=p, offset=i,
                        )
                        out.append(GeoMessage.deserialize(log[i]))
                    except Exception as e:
                        if on_error is None:
                            raise
                        on_error(p, i, log[i], e)
                new[p] = end
        out.sort(key=lambda m: m.ts_ms)
        return out, new

    def end_offsets(self) -> List[int]:
        with self._lock:
            return [len(log) for log in self._logs]


class MessageBus:
    """Topic registry (the in-proc 'broker')."""

    def __init__(self):
        self._topics: Dict[str, Topic] = {}
        self._lock = threading.Lock()

    def create(self, name: str, partitions: int = 4) -> Topic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = Topic(name, partitions)
            return self._topics[name]

    def topic(self, name: str) -> Topic:
        t = self._topics.get(name)
        if t is None:
            raise KeyError(f"no topic {name!r}")
        return t

    def delete(self, name: str):
        with self._lock:
            self._topics.pop(name, None)
