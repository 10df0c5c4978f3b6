"""Confluent-style schema-registry Avro streaming ingest.

Copy of ``geomesa_tpu/stream/confluent.py``. Feature messages on the wire
are **registry-framed Avro**: a magic byte, a 4-byte big-endian schema id,
then the Avro binary record. Consumers resolve the WRITER schema by id
against their own READER schema, so producers and consumers can evolve
schemas independently (the Confluent wire format and resolution rules).

- :class:`SchemaRegistry`: subject -> versioned schemas with global ids
  (the Confluent Schema Registry's data model, in process).
- :class:`ConfluentSerializer`: feature dict -> framed bytes.
- :class:`ConfluentDeserializer`: framed bytes -> (fid, attributes),
  applying Avro schema resolution: fields matched by name, writer-only
  fields skipped, reader-only fields filled from their defaults.

Deletes follow Kafka semantics: a tombstone (``None`` payload) keyed by
feature id. Point geometries arrive as WKT and go through the port's
parser.
"""

from __future__ import annotations

import io
import json
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

from geomesa_tpu_torch.io.avro_io import (
    _read_value, _write_row, avro_schema, read_bytes,
)
from geomesa_tpu_torch.schema.feature_type import FeatureType

#: Confluent wire format magic byte
MAGIC_BYTE = 0


class SchemaRegistry:
    """In-process schema registry (Confluent data model: globally unique
    schema ids; per-subject version lists; structurally identical schemas
    deduplicate to one id)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[int, Dict[str, Any]] = {}
        self._ids_by_canon: Dict[str, int] = {}
        self._subjects: Dict[str, List[int]] = {}
        self._next = 1

    @staticmethod
    def _canon(schema: Dict[str, Any]) -> str:
        return json.dumps(schema, sort_keys=True, separators=(",", ":"))

    def register(self, subject: str, schema: Dict[str, Any]) -> int:
        """Register a schema under a subject; returns its global id
        (existing id when the schema is already registered)."""
        canon = self._canon(schema)
        with self._lock:
            sid = self._ids_by_canon.get(canon)
            if sid is None:
                sid = self._next
                self._next += 1
                self._ids_by_canon[canon] = sid
                self._by_id[sid] = json.loads(canon)
            versions = self._subjects.setdefault(subject, [])
            if sid not in versions:
                versions.append(sid)
            return sid

    def by_id(self, schema_id: int) -> Dict[str, Any]:
        schema = self._by_id.get(schema_id)
        if schema is None:
            raise KeyError(f"no schema with id {schema_id} in the registry")
        return schema

    def latest(self, subject: str) -> Tuple[int, Dict[str, Any]]:
        versions = self._subjects.get(subject)
        if not versions:
            raise KeyError(f"no subject {subject!r} in the registry")
        sid = versions[-1]
        return sid, self._by_id[sid]

    def versions(self, subject: str) -> List[int]:
        return list(self._subjects.get(subject, ()))


def _frame(schema_id: int, payload: bytes) -> bytes:
    return struct.pack(">bI", MAGIC_BYTE, schema_id) + payload


def _unframe(data: bytes) -> Tuple[int, bytes]:
    if len(data) < 5 or data[0] != MAGIC_BYTE:
        raise ValueError(
            "not a registry-framed Avro message (missing magic byte 0)"
        )
    (schema_id,) = struct.unpack(">I", data[1:5])
    return schema_id, data[5:]


class ConfluentSerializer:
    """Feature -> framed Avro bytes under a registered schema."""

    def __init__(self, registry: SchemaRegistry, subject: str,
                 ft: FeatureType):
        self.ft = ft
        self.schema = avro_schema(ft)
        self.schema_id = registry.register(subject, self.schema)
        self._names = [f["name"] for f in self.schema["fields"]]
        self._types = [f["type"] for f in self.schema["fields"]]

    def serialize(self, fid: str, attributes: Dict[str, Any]) -> bytes:
        buf = io.BytesIO()
        row = tuple(
            fid if n == "__fid__" else attributes.get(n)
            for n in self._names
        )
        _write_row(buf, row, self._types)
        return _frame(self.schema_id, buf.getvalue())


class ConfluentDeserializer:
    """Framed Avro bytes -> (fid, attributes) under the READER schema,
    resolving the writer schema from the registry by id (Avro schema
    resolution: name-matched fields, writer-only fields decoded and
    dropped, reader-only fields filled from their declared defaults)."""

    def __init__(self, registry: SchemaRegistry,
                 reader: "FeatureType | Dict[str, Any]"):
        self.registry = registry
        self.reader = (avro_schema(reader)
                       if isinstance(reader, FeatureType) else reader)
        self._reader_names = {f["name"] for f in self.reader["fields"]}
        self._defaults = {
            f["name"]: f.get("default")
            for f in self.reader["fields"] if f["name"] != "__fid__"
        }

    def deserialize(self, data: bytes) -> Tuple[str, Dict[str, Any]]:
        schema_id, payload = _unframe(data)
        writer = self.registry.by_id(schema_id)
        buf = io.BytesIO(payload)
        decoded: Dict[str, Any] = {}
        for f in writer["fields"]:
            v = _read_value(buf, f["type"])
            if f["name"] in self._reader_names:
                decoded[f["name"]] = v
            # writer-only field: decoded (the bytes must be consumed) and
            # dropped — Avro resolution's "ignored" rule
        fid = str(decoded.pop("__fid__", ""))
        attrs = dict(self._defaults)
        attrs.update(decoded)
        return fid, attrs


def attach_confluent(sds, name: str, registry: SchemaRegistry):
    """Wire a ``StreamingDataset`` schema for framed-Avro ingest: returns
    (serializer, ingest) where ``ingest(data: bytes | None, fid=None,
    ts_ms=None)`` routes one Kafka-style record into the live cache —
    framed Avro value = upsert, ``None`` value + fid = tombstone delete
    (ConfluentKafkaDataStore's consumer loop semantics).

    Observability: each record applies under a
    ``stream.apply`` span + timer, and the ``stream.lag`` gauge tracks
    poll→apply latency (apply wall-clock minus the record's event time) —
    the same lag signal ``StreamingDataset.poll`` exposes, here measured
    at the broker-facing decode/apply edge.

    Resilience (the ``stream.confluent.ingest`` fault point): a poison
    record — unframeable bytes, an unresolvable schema
    id, a malformed geometry, a keyless tombstone — must never kill the
    consumer loop: it QUARANTINES (counted in
    ``stream.confluent.quarantined`` + the per-schema breakdown, recorded
    through the audit degradation trail) and ``ingest`` returns ``""``;
    the consumer's offset advances past it. Corruption quarantines —
    there is nothing to retry in a broken payload; transient broker
    errors live on the broker client's side of this edge and are its
    retry domain."""
    import time as _time

    from geomesa_tpu_torch import metrics, resilience, tracing

    ft = sds.get_schema(name)
    ser = ConfluentSerializer(registry, name, ft)
    de = ConfluentDeserializer(registry, ft)
    # metric objects are invariant for the attachment's lifetime — resolve
    # them once here, not per record under the registry lock on the
    # broker-facing hot path
    apply_timer = metrics.registry().timer(metrics.STREAM_APPLY)
    lag_gauge = metrics.registry().gauge(metrics.STREAM_LAG)
    lag_gauge_schema = metrics.registry().gauge(f"{metrics.STREAM_LAG}.{name}")

    def ingest(data: Optional[bytes], fid: Optional[str] = None,
               ts_ms: Optional[int] = None,
               offset: Optional[int] = None) -> str:
        with tracing.span("stream.apply", schema=name, edge="confluent") \
                as sp, apply_timer.time():
            try:
                resilience.fault_point("stream.confluent.ingest",
                                       schema=name, fid=fid)
                out = _ingest(data, fid, ts_ms, sp)
            except resilience.QueryTimeoutError:
                raise
            except Exception as e:
                # poison-record quarantine (never kill the consumer)
                metrics.inc(metrics.STREAM_CONFLUENT_QUARANTINED)
                metrics.inc(f"{metrics.STREAM_CONFLUENT_QUARANTINED}.{name}")
                resilience.record_skip(
                    "stream.confluent.ingest", f"{name}/{fid or '?'}", e,
                    phase="decode",
                )
                sp.set(quarantined=True, error=type(e).__name__)
                return ""
        if offset is not None and getattr(sds, "_journal", None) is not None:
            # durable broker-offset high-water mark (the stream-resume
            # contract): once this record is down, a
            # restarted consumer resumes PAST this broker offset via
            # confluent_resume_offset — the acked record can never be lost
            # (the feature data itself rides the stream-batch records
            # journaled by StreamingDataset.poll)
            sds._journal.append({
                "kind": "confluent-offset", "schema": name,
                "offset": int(offset), "fid": out,
            })
        return out

    def _ingest(data: Optional[bytes], fid: Optional[str],
                ts_ms: Optional[int], sp) -> str:
        now = int(_time.time() * 1000) if ts_ms is None else int(ts_ms)
        if ts_ms is not None:
            # lag is only meaningful against a real record timestamp — a
            # producer that sets none would pin the gauge at 0 and mask
            # genuine consumer lag (same guard as StreamingDataset.poll's
            # applied_ts check)
            lag_ms = max(int(_time.time() * 1000) - int(ts_ms), 0)
            sp.set(lag_ms=lag_ms)
            lag_gauge.set(lag_ms)
            lag_gauge_schema.set(lag_ms)
        if data is None:
            if not fid:
                raise ValueError("a tombstone needs a feature id")
            sds.delete(name, fid)
            return fid
        rid, attrs = de.deserialize(data)
        rid = fid or rid
        import math

        cols: Dict[str, Any] = {}
        for a in ft.attributes:
            v = attrs.get(a.name)
            if a.is_geom:
                if a.is_point and isinstance(v, str):
                    from geomesa_tpu_torch.utils.geometry import parse_wkt

                    g = parse_wkt(v)
                    cols[a.name] = [(g.x, g.y)]
                else:
                    cols[a.name] = [v]
            elif a.type == "date":
                cols[a.name] = [now if v is None else int(v)]
            elif a.type == "string":
                cols[a.name] = ["" if v is None else str(v)]
            elif a.type in ("float32", "float64"):
                cols[a.name] = [math.nan if v is None else float(v)]
            elif a.type == "bool":
                cols[a.name] = [bool(v)]
            elif a.type == "json":
                cols[a.name] = [v if isinstance(v, str) else json.dumps(v)]
            else:
                cols[a.name] = [0 if v is None else int(v)]
        sds.write(name, cols, [rid], ts_ms=[now])
        return rid

    return ser, ingest


def confluent_resume_offset(sds, name: str) -> int:
    """Highest broker offset journaled for ``name``'s Confluent edge, or
    ``-1`` when none was recorded — seek the external consumer to
    ``resume + 1`` after a restart and no acked record replays twice
    (the stream-offset resume)."""
    j = getattr(sds, "_journal", None)
    if j is None:
        return -1
    hi = -1
    for rec in j.records():
        if (rec.get("kind") == "confluent-offset"
                and rec.get("schema") == name):
            hi = max(hi, int(rec.get("offset", -1)))
    return hi
