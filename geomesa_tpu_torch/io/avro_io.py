"""Avro records and Object Container Files.

Copy of ``geomesa_tpu/io/avro_io.py`` (pure Python). Features serialize to
an Avro record schema derived from the FeatureType (geometry as WKT string,
date as long ``timestamp-millis``, every field nullable); the container
format is the standard one (magic ``Obj\\x01``, metadata map with the
inline JSON schema, ``null`` codec, sync-marker-delimited blocks). The
Confluent stream edge (``stream/confluent.py``) frames single records with
``_write_row`` / ``_read_value``.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"Obj\x01"

_AVRO_TYPES = {
    "int": "int", "int32": "int", "integer": "int",
    "long": "long", "int64": "long",
    "float": "float", "float32": "float",
    "double": "double", "float64": "double",
    "bool": "boolean", "boolean": "boolean",
    "string": "string",
}


# ---------------------------------------------------------------------------
# primitive codec
# ---------------------------------------------------------------------------

def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(buf: io.BytesIO, n: int):
    n = _zigzag(int(n))
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def read_long(buf) -> int:
    shift = 0
    acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            return _unzigzag(acc)
        shift += 7


def write_bytes(buf: io.BytesIO, b: bytes):
    write_long(buf, len(b))
    buf.write(b)


def read_bytes(buf) -> bytes:
    return buf.read(read_long(buf))


def write_string(buf: io.BytesIO, s: str):
    write_bytes(buf, s.encode("utf-8"))


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def avro_schema(ft, attrs: Optional[List[str]] = None) -> Dict[str, Any]:
    """FeatureType -> Avro record schema (every field nullable).

    ``attrs`` restricts the schema to a projection's attributes."""
    fields: List[Dict[str, Any]] = [
        {"name": "__fid__", "type": "string"}
    ]
    for a in ft.attributes:
        if attrs is not None and a.name not in attrs:
            continue
        if a.is_geom:
            typ: Any = "string"  # WKT
        elif a.type == "date":
            typ = {"type": "long", "logicalType": "timestamp-millis"}
        else:
            typ = _AVRO_TYPES.get(a.type, "string")
        fields.append({"name": a.name, "type": ["null", typ]})
    return {
        "type": "record",
        "name": ft.name,
        "namespace": "geomesa_tpu",
        "fields": fields,
    }


def _rows(ft, d, names) -> Iterator[Tuple[Any, ...]]:
    """Iterate already-decoded columns ``d`` in schema order over ``names``."""
    geom_names = {a.name for a in ft.attributes if a.is_geom}
    point_names = {
        a.name for a in ft.attributes if a.is_geom and a.is_point
    }
    n = len(d["__fid__"])
    for i in range(n):
        row: List[Any] = [str(d["__fid__"][i])]
        for name in names:
            v = d[name][i]
            if name in point_names and not isinstance(v, str):
                v = f"POINT ({v[0]} {v[1]})"
            elif name in geom_names:
                v = None if v is None else str(v)
            row.append(v)
        yield tuple(row)


def write_avro(path_or_buf, ft, batch, dicts, sync: Optional[bytes] = None):
    """Write a feature batch as an Avro container file. Projected batches
    (missing columns) produce a correspondingly reduced schema."""
    from geomesa_tpu_torch.schema.columns import decode_batch

    d = decode_batch(ft, batch, dicts)
    attrs = [a.name for a in ft.attributes if a.name in d]
    schema = avro_schema(ft, attrs)
    types = [f["type"] for f in schema["fields"]]
    sync = sync or os.urandom(16)
    own = isinstance(path_or_buf, str)
    out = open(path_or_buf, "wb") if own else path_or_buf
    try:
        out.write(MAGIC)
        meta = io.BytesIO()
        write_long(meta, 2)
        write_string(meta, "avro.schema")
        write_bytes(meta, json.dumps(schema).encode())
        write_string(meta, "avro.codec")
        write_bytes(meta, b"null")
        write_long(meta, 0)
        out.write(meta.getvalue())
        out.write(sync)

        block = io.BytesIO()
        n = 0
        for row in _rows(ft, d, attrs):
            _write_row(block, row, types)
            n += 1
        if n:
            head = io.BytesIO()
            write_long(head, n)
            write_bytes(head, block.getvalue())
            out.write(head.getvalue())
            out.write(sync)
    finally:
        if own:
            out.close()


def _write_row(buf: io.BytesIO, row, types):
    for v, t in zip(row, types):
        if isinstance(t, list):  # nullable union
            if v is None or (
                isinstance(v, (float, np.floating)) and np.isnan(v)
            ):
                write_long(buf, 0)
                continue
            write_long(buf, 1)
            t = t[1]
        _write_value(buf, v, t)


def _write_value(buf: io.BytesIO, v, t):
    if isinstance(t, dict):
        t = t["type"]
    if t == "string":
        write_string(buf, str(v))
    elif t in ("int", "long"):
        if isinstance(v, np.datetime64):
            v = v.astype("datetime64[ms]").astype(np.int64)
        write_long(buf, int(v))
    elif t == "float":
        buf.write(struct.pack("<f", float(v)))
    elif t == "double":
        buf.write(struct.pack("<d", float(v)))
    elif t == "boolean":
        buf.write(b"\x01" if v else b"\x00")
    else:
        raise ValueError(f"unsupported avro type {t!r}")


def read_avro(path_or_buf) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Read an Avro container file -> (schema, records). Null codec only."""
    own = isinstance(path_or_buf, str)
    f = open(path_or_buf, "rb") if own else path_or_buf
    try:
        if f.read(4) != MAGIC:
            raise ValueError("not an Avro container file")
        meta: Dict[str, bytes] = {}
        while True:
            cnt = read_long(f)
            if cnt == 0:
                break
            if cnt < 0:  # block-size-prefixed variant
                read_long(f)
                cnt = -cnt
            for _ in range(cnt):
                k = read_bytes(f).decode()
                meta[k] = read_bytes(f)
        codec = meta.get("avro.codec", b"null")
        if codec not in (b"null", b""):
            raise ValueError(f"unsupported avro codec {codec!r}")
        schema = json.loads(meta["avro.schema"])
        sync = f.read(16)
        records: List[Dict[str, Any]] = []
        fields = schema["fields"]
        rest = f.read()  # container files are block-seekable; buffer whole
        buf = io.BytesIO(rest)
        while buf.tell() < len(rest):
            n = read_long(buf)
            blen = read_long(buf)
            bbuf = io.BytesIO(buf.read(blen))
            for _ in range(n):
                rec = {}
                for fl in fields:
                    rec[fl["name"]] = _read_value(bbuf, fl["type"])
                records.append(rec)
            if buf.read(16) != sync:
                raise ValueError("sync marker mismatch")
        return schema, records
    finally:
        if own:
            f.close()


def _read_value(buf, t):
    if isinstance(t, list):
        idx = read_long(buf)
        if t[idx] == "null":
            return None
        return _read_value(buf, t[idx])
    if isinstance(t, dict):
        t = t["type"]
    if t == "string":
        return read_bytes(buf).decode("utf-8")
    if t in ("int", "long"):
        return read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t == "null":
        return None
    raise ValueError(f"unsupported avro type {t!r}")
