"""Query audit log: ``QueryEvent`` per call and ``DegradationEvent`` per
skipped unit of work.

Copy of ``geomesa_tpu/audit.py`` (GeoMesa's ``QueryEvent`` /
``AuditWriter``). Each completed query produces a structured
``QueryEvent`` (store, type name, user, filter, hints, plan and scan
times, hits, scanned and table rows), appended to an in-memory ring and,
when ``geomesa.audit.path`` is set, to a JSONL file. Every record kind
(query events, degradations, slow-query traces) goes through one held
append handle, so the file's order is the events' order. The records'
fields and JSON equal the JAX package's.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

from geomesa_tpu_torch import config


class _JsonlAppender:
    """One held append handle for the audit JSONL file. The handle
    reopens only when ``geomesa.audit.path`` changes or the file at that
    path was rotated away. Every record kind (query events, degradations,
    slow traces) flushes through this one writer, so the file's order is
    the events' order. A record is encoded only when a file is open: with
    no ``geomesa.audit.path`` an event costs no JSON encoding."""

    def __init__(self):
        self._lock = threading.Lock()
        self._path: Optional[str] = None
        self._fh = None

    def write(self, encode: Callable[[], str]) -> None:
        """Append the line ``encode()`` returns."""
        with self._lock:
            path = config.AUDIT_PATH.get()
            reopen = path != self._path
            if not reopen and self._fh is not None:
                # rotation check: logrotate renames or removes the file
                # while the path stays the same; one stat per event detects
                # it and reopens, so records land in the new file
                try:
                    st = os.stat(path)
                    fst = os.fstat(self._fh.fileno())
                    reopen = (st.st_ino, st.st_dev) != (fst.st_ino, fst.st_dev)
                except OSError:
                    reopen = True  # target missing: recreate it
            if reopen:
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                self._fh = open(path, "a") if path else None
                self._path = path
            if self._fh is not None:
                self._fh.write(encode() + "\n")
                self._fh.flush()

    def reset(self) -> None:
        """Close the held handle (tests; a removed-but-same-path file)."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
            self._fh = None
            self._path = None


#: process-wide JSONL appender shared by every audit record kind
_appender = _JsonlAppender()


def append_record(obj: Dict[str, Any]) -> None:
    """Append one structured record (e.g. a slow-trace tree from
    tracing.py) through the shared audit appender. Honors the same
    enabled/path gates as query events."""
    if not config.AUDIT_ENABLED.to_bool():
        return
    _appender.write(lambda: json.dumps(obj, default=str))


@dataclass
class QueryEvent:
    """One audited query (QueryEvent.scala:14 field parity)."""

    store: str
    type_name: str
    user: str
    filter: str
    hints: Dict[str, Any] = field(default_factory=dict)
    date: float = 0.0          # epoch seconds
    plan_time_ms: float = 0.0
    scan_time_ms: float = 0.0
    hits: int = 0
    #: coarse-window candidate rows (scanned) and table size — selectivity
    #: of the index pushdown; hits/scanned ratios near 1 mean tight windows
    scanned: int = 0
    table_rows: int = 0

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str)


class AuditWriter:
    """Collects QueryEvents; optionally appends JSONL to a file."""

    def __init__(self, store_name: str = "geomesa-tpu", max_events: int = 10_000):
        self.store_name = store_name
        self.events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return config.AUDIT_ENABLED.to_bool()

    def write(self, event: QueryEvent):
        if not self.enabled:
            return
        event.store = event.store or self.store_name
        if not event.date:
            event.date = time.time()
        with self._lock:
            # file append INSIDE the registry lock (via the held appender
            # handle): ring order and file order stay identical even under
            # concurrent writers
            self.events.append(event)
            _appender.write(event.to_json)

    def record(self, type_name: str, filter_text: str, hints: Dict[str, Any],
               plan_time_ms: float, scan_time_ms: float, hits: int,
               user: str = "", scanned: int = 0, table_rows: int = 0):
        self.write(
            QueryEvent(
                store=self.store_name, type_name=type_name, user=user,
                filter=filter_text, hints=hints, plan_time_ms=plan_time_ms,
                scan_time_ms=scan_time_ms, hits=hits, scanned=scanned,
                table_rows=table_rows,
            )
        )

    def recent(self, n: int = 100) -> List[QueryEvent]:
        with self._lock:
            return list(self.events)[-n:]


# ---------------------------------------------------------------------------
# Degradation trail (resilience layer; docs/RESILIENCE.md). Every skipped
# partition / quarantined message / corrupt file records a DegradationEvent
# here — the operational answer to "what did my degraded aggregate drop?".
# ---------------------------------------------------------------------------


@dataclass
class DegradationEvent:
    """One unit of work dropped by the resilience layer."""

    source: str        # fault-point site, e.g. "fs.read_partition"
    part: str          # partition name / file path / message id
    error: str         # repr of the failure
    phase: str = ""
    date: float = 0.0  # epoch seconds

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=str)


class DegradationLog:
    """In-memory ring of DegradationEvents (JSONL-appended alongside the
    query audit when ``geomesa.audit.path`` is set)."""

    def __init__(self, max_events: int = 10_000):
        self.events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    def write(self, event: DegradationEvent):
        if not config.AUDIT_ENABLED.to_bool():
            return  # same gate AuditWriter honors: disabled means disabled
        if not event.date:
            event.date = time.time()
        with self._lock:
            self.events.append(event)
            _appender.write(event.to_json)

    def recent(self, n: int = 100) -> List[DegradationEvent]:
        with self._lock:
            return list(self.events)[-n:]

    def clear(self):
        with self._lock:
            self.events.clear()


#: process-wide degradation trail
degradations = DegradationLog()


def record_degradation(rec) -> None:
    """Record a resilience-layer skip (``rec`` is a ``resilience.Skipped``
    or anything with source/part/error/phase attributes)."""
    degradations.write(
        DegradationEvent(
            source=getattr(rec, "source", ""),
            part=getattr(rec, "part", ""),
            error=getattr(rec, "error", ""),
            phase=getattr(rec, "phase", ""),
        )
    )
