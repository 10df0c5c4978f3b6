"""Live feature cache and streaming dataset (the Kafka datastore analog).

Copy of ``geomesa_tpu/stream/live.py``:

* ``LiveFeatureCache``: the current state of each feature id, with
  event-time ordering (a stale update is dropped), optional event-time
  expiry, and a uniform grid bucket index for spatial candidate pruning.
* ``StreamingDataset``: schemas map to topics; writers produce
  GeoMessages; ``poll()`` is the micro-batch consumer that fills the cache;
  queries run the compiled ECQL mask on the host over the live window.
* feature listeners: one callable per applied message.

The live window is columnar: the cache rebuilds (and caches) a ColumnBatch
on demand. The mask stays on the host, as the reference's; ``density``
uploads the window's points per call and bins them on the dataset's device
(``prefer_device``, the default) or on the host (``prefer_device=False``).
The dataset runs on the CUDA card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.kernels import density as kdensity
from geomesa_tpu_torch.schema.columns import (
    ColumnBatch, DictionaryEncoder, encode_batch,
)
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stream.messages import (
    CHANGE, CLEAR, DELETE, GeoMessage, MessageBus, Topic,
)


def _cell_of(v: np.ndarray, off: float, span: float, n: int) -> np.ndarray:
    """Grid cell index along one axis (NaN-safe: NaN clamps to cell 0; null
    geometries are excluded by the caller's validity mask anyway)."""
    with np.errstate(invalid="ignore"):
        return np.clip(
            np.nan_to_num((np.asarray(v) + off) / span * n).astype(np.int64),
            0, n - 1,
        )


class LiveFeatureCache:
    """Current feature state keyed by fid (KafkaFeatureCache analog)."""

    def __init__(self, ft: FeatureType, expiry_ms: Optional[int] = None,
                 grid_bins: int = 64):
        self.ft = ft
        self.expiry_ms = expiry_ms
        self.grid_bins = grid_bins
        self.dicts: Dict[str, DictionaryEncoder] = {}
        self._state: Dict[str, Tuple[int, Dict[str, Any]]] = {}  # fid -> (ts, attrs)
        self._lock = threading.Lock()
        self._batch: Optional[ColumnBatch] = None  # columnar view cache
        self._grid: Optional[Dict[int, List[str]]] = None
        #: mutation epoch: bumped by every applied change/delete/clear/expiry
        #: — the invalidation key for anything caching aggregates over the
        #: live window (the same contract as FeatureStore.version)
        self.epoch = 0
        #: standing-query event hook: called as
        #: ``observer(event, fid, old_attrs, new_attrs)`` for every APPLIED
        #: mutation (stale-dropped puts don't fire) — the subscribe
        #: engine's delta feed. None = no subscriptions, zero overhead.
        self.observer: Optional[Callable] = None

    def __len__(self):
        return len(self._state)

    # -- mutation ----------------------------------------------------------
    def validate(self, attrs: Dict[str, Any]) -> None:
        """Reject a payload the columnar encode could not absorb (poison
        protection: an unappliable feature must fail HERE, at the message,
        not later in ``batch()`` where it would poison every query of the
        window). Point geometries must be None or an (x, y) pair of
        numbers; extent geometries must be None or a WKT string."""
        for a in self.ft.attributes:
            if not a.is_geom:
                continue
            v = attrs.get(a.name)
            if v is None:
                continue
            if a.is_point:
                try:
                    float(v[0]), float(v[1])
                except (TypeError, ValueError, IndexError, KeyError) as e:
                    raise ValueError(
                        f"bad point payload for {a.name!r}: {v!r}"
                    ) from e
            elif not isinstance(v, str):
                raise ValueError(
                    f"bad geometry payload for {a.name!r}: {type(v).__name__}"
                )

    def put(self, fid: str, attrs: Dict[str, Any], ts_ms: int):
        with self._lock:
            cur = self._state.get(fid)
            if cur is not None and cur[0] > ts_ms:
                return  # event-time ordering: drop stale update
            self._state[fid] = (ts_ms, attrs)
            self._invalidate()
        if self.observer is not None:
            # old attrs distinguish a MOVE (delta -old/+new) from an add
            self.observer("put", fid, cur[1] if cur else None, attrs)

    def remove(self, fid: str):
        with self._lock:
            old = self._state.pop(fid, None)
            if old is not None:
                self._invalidate()
        if old is not None and self.observer is not None:
            self.observer("remove", fid, old[1], None)

    def clear(self):
        with self._lock:
            self._state.clear()
            self._invalidate()
        if self.observer is not None:
            self.observer("clear", None, None, None)

    def expire(self, now_ms: Optional[int] = None) -> int:
        """Drop features older than the event-time expiry. Returns #dropped."""
        if self.expiry_ms is None:
            return 0
        now_ms = int(time.time() * 1000) if now_ms is None else now_ms
        cutoff = now_ms - self.expiry_ms
        with self._lock:
            stale = [(f, self._state[f][1]) for f, (ts, _)
                     in self._state.items() if ts < cutoff]
            for f, _ in stale:
                del self._state[f]
            if stale:
                self._invalidate()
        if stale and self.observer is not None:
            # expiry is the stream's age-off: non-additive, dirty-scoped
            for f, old in stale:
                self.observer("remove", f, old, None)
        return len(stale)

    def _invalidate(self):
        self._batch = None
        self._grid = None
        self.epoch += 1

    # -- columnar view ------------------------------------------------------
    def batch(self) -> ColumnBatch:
        """The live window as encoded columns (rebuilt lazily)."""
        with self._lock:
            if self._batch is not None:
                return self._batch
            if not self._state:
                self._batch = ColumnBatch({}, 0)
                return self._batch
            fids = list(self._state)
            rows = [self._state[f][1] for f in fids]
            data: Dict[str, list] = {}
            for a in self.ft.attributes:
                if a.is_geom and not a.is_point:
                    data[a.name] = [r.get(a.name) for r in rows]
                elif a.is_geom:
                    # points arrive as (x, y) / [x, y]; null/missing geometry
                    # rides as NaN and is excluded by the query validity mask
                    xs, ys = [], []
                    for r in rows:
                        v = r.get(a.name)
                        if v is None:
                            xs.append(np.nan)
                            ys.append(np.nan)
                        else:
                            xs.append(float(v[0]))
                            ys.append(float(v[1]))
                    data[a.name + "__x"] = np.array(xs)
                    data[a.name + "__y"] = np.array(ys)
                else:
                    data[a.name] = [r.get(a.name) for r in rows]
            self._batch = encode_batch(self.ft, data, self.dicts, fids)
            return self._batch

    def grid_index(self, b: Optional[ColumnBatch] = None) -> Dict[int, np.ndarray]:
        """Uniform grid bucket index over the window (BucketIndex analog):
        cell id -> row indices. The cached grid is tied to the batch snapshot
        it was built from, so row indices can never point into a different
        (concurrently rebuilt) batch."""
        if b is None:
            b = self.batch()
        with self._lock:
            if self._grid is not None and self._grid[0] is b:
                return self._grid[1]
        g = self.ft.geom_field
        out: Dict[int, np.ndarray] = {}
        if b.n and g is not None and g + "__x" in b.columns:
            n = self.grid_bins
            if g + "__xmin" in b.columns:
                # extent geometries: bucket every cell the row bbox overlaps
                # (a centroid-only bucket would hide rows from queries that
                # hit the geometry far from its centroid)
                x0 = _cell_of(b.columns[g + "__xmin"], 180.0, 360.0, n)
                x1 = _cell_of(b.columns[g + "__xmax"], 180.0, 360.0, n)
                y0 = _cell_of(b.columns[g + "__ymin"], 90.0, 180.0, n)
                y1 = _cell_of(b.columns[g + "__ymax"], 90.0, 180.0, n)
                ok = np.isfinite(b.columns[g + "__x"])
                cell_l: List[int] = []
                row_l: List[int] = []
                for i in np.nonzero(ok)[0]:
                    for cy in range(y0[i], y1[i] + 1):
                        base = cy * n
                        for cx in range(x0[i], x1[i] + 1):
                            cell_l.append(base + cx)
                            row_l.append(i)
                cell = np.asarray(cell_l, np.int64)
                order_rows = np.asarray(row_l, np.int64)
            else:
                cell = (
                    _cell_of(b.columns[g + "__y"], 90.0, 180.0, n) * n
                    + _cell_of(b.columns[g + "__x"], 180.0, 360.0, n)
                )
                order_rows = np.arange(b.n, dtype=np.int64)
            order = np.argsort(cell, kind="stable")
            cells, starts = np.unique(cell[order], return_index=True)
            bounds = np.append(starts, len(order))
            for i, c in enumerate(cells):
                out[int(c)] = order_rows[order[bounds[i]: bounds[i + 1]]]
        with self._lock:
            self._grid = (b, out)
        return out

    def candidate_rows(self, f: ir.Filter,
                       b: Optional[ColumnBatch] = None) -> Optional[np.ndarray]:
        """Row candidates from the grid index for the filter's bbox, or None
        for 'all rows'. Pass the batch snapshot the caller is masking so grid
        rows and batch rows stay coherent under concurrent writes."""
        g = self.ft.geom_field
        if g is None:
            return None
        fv = ir.extract_geometries(f, g)
        if fv.is_empty or fv.disjoint:
            return None
        n = self.grid_bins
        idx = self.grid_index(b)
        rows: List[np.ndarray] = []
        for geom in fv.values:
            xmin, ymin, xmax, ymax = geom.bounds()
            x0 = max(0, int((xmin + 180.0) / 360.0 * n))
            x1 = min(n - 1, int((xmax + 180.0) / 360.0 * n))
            y0 = max(0, int((ymin + 90.0) / 180.0 * n))
            y1 = min(n - 1, int((ymax + 90.0) / 180.0 * n))
            for cy in range(y0, y1 + 1):
                for cx in range(x0, x1 + 1):
                    got = idx.get(cy * n + cx)
                    if got is not None:
                        rows.append(got)
        if not rows:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(rows))


class StreamingDataset:
    """Topic-backed streaming datastore (KafkaDataStore analog)."""

    def __init__(self, bus: Optional[MessageBus] = None,
                 expiry_ms: Optional[int] = None, partitions: int = 4,
                 device=None, prefer_device: bool = True):
        from geomesa_tpu_torch.api.dataset import resolve_device

        self.bus = bus or MessageBus()
        self.expiry_ms = expiry_ms
        self.partitions = partitions
        #: the device ``density`` bins on (None: the CUDA card)
        self.device = resolve_device(device)
        #: True bins on :attr:`device` with the f32 pixel mapping (the
        #: reference's ``jnp`` path); False on the host in f64 (its default)
        self.prefer_device = prefer_device
        self._schemas: Dict[str, FeatureType] = {}
        self._topics: Dict[str, Topic] = {}
        self._caches: Dict[str, LiveFeatureCache] = {}
        self._offsets: Dict[str, List[int]] = {}
        self._listeners: Dict[str, List[Callable[[GeoMessage], None]]] = {}
        #: poison-message quarantine counters per schema:
        #: a message that fails to decode or apply is counted + recorded and
        #: skipped — it can never kill the consumer loop
        self.quarantined: Dict[str, int] = {}
        #: durable mutation journal (``fs/journal.py``). When attached,
        #: every applied poll batch is journaled WITH its source offsets, so
        #: a restarted consumer resumes exactly where the crashed one acked.
        self._journal = None
        self._replaying = False
        #: standing-query engine over the live windows (``subscribe/``);
        #: created lazily on the first subscribe()
        self.standing = None

    # -- durability --------------------------------------------------------
    def attach_journal(self, root: str) -> None:
        """Journal applied batches under ``root``.

        The record goes down AFTER the batch applies — the live cache is
        idempotent under event-time ordering (re-putting a feature at the
        same ts is a no-op state-wise), so a crash in the journal-after-
        apply gap re-consumes at most one batch from the topic, never
        loses an acked one."""
        from geomesa_tpu_torch import config
        from geomesa_tpu_torch.fs.journal import MutationJournal

        if self._journal is not None or not config.JOURNAL_ENABLED.to_bool():
            return
        self._journal = MutationJournal(root)

    def recover(self) -> int:
        """Replay the attached journal: recreate journaled schemas, restore
        the live caches from applied batches, and restore consumer offsets
        so the next :meth:`poll` resumes past everything already applied.
        Returns the number of records replayed."""
        if self._journal is None:
            return 0
        applied = 0
        self._replaying = True
        try:
            applied = self._recover_records()
        finally:
            self._replaying = False
        return applied

    def _recover_records(self) -> int:
        from geomesa_tpu_torch import metrics, resilience

        applied = 0
        for rec in self._journal.records():
            kind = rec.get("kind")
            nm = rec.get("schema", "")
            seq = int(rec.get("seq", 0))
            try:
                if kind == "stream-create":
                    if nm not in self._schemas:
                        self.create_schema(
                            FeatureType.from_spec(nm, rec["spec"]))
                elif kind == "stream-batch":
                    cache = self._caches.get(nm)
                    if cache is None:
                        continue  # schema dropped since: batch is moot
                    for mk, fid, payload, ts_ms in rec.get("msgs", []):
                        if mk == CHANGE:
                            cache.put(fid, payload or {}, int(ts_ms))
                        elif mk == DELETE:
                            cache.remove(fid)
                        elif mk == CLEAR:
                            cache.clear()
                    offs = rec.get("offsets")
                    if offs and nm in self._offsets:
                        self._offsets[nm] = [
                            max(a, int(b))
                            for a, b in zip(self._offsets[nm], offs)
                        ]
                else:
                    continue
                applied += 1
                metrics.inc(metrics.JOURNAL_REPLAYED)
            except Exception as e:
                # one bad record must not fail the whole recovery
                resilience.record_skip(
                    "journal.replay", f"{nm}@{seq}", e, phase="stream")
        return applied

    # -- schema CRUD -------------------------------------------------------
    def create_schema(self, name_or_ft, spec: Optional[str] = None) -> FeatureType:
        ft = (
            name_or_ft if isinstance(name_or_ft, FeatureType)
            else FeatureType.from_spec(name_or_ft, spec)
        )
        if ft.name in self._schemas:
            raise ValueError(f"schema {ft.name!r} already exists")
        self._schemas[ft.name] = ft
        self._topics[ft.name] = self.bus.create(f"geomesa-{ft.name}", self.partitions)
        self._caches[ft.name] = LiveFeatureCache(ft, self.expiry_ms)
        self._offsets[ft.name] = [0] * self.partitions
        self._listeners[ft.name] = []
        if self._journal is not None and not self._replaying:
            self._journal.append({
                "kind": "stream-create", "schema": ft.name,
                "spec": ft.spec(),
            })
        return ft

    def get_schema(self, name: str) -> FeatureType:
        return self._schemas[name]

    def list_schemas(self) -> List[str]:
        return sorted(self._schemas)

    def cache(self, name: str) -> LiveFeatureCache:
        return self._caches[name]

    def add_listener(self, name: str, fn: Callable[[GeoMessage], None]):
        self._listeners[name].append(fn)

    # -- standing queries (subscribe/) ---------------------------------------
    def _standing_engine(self):
        if self.standing is None:
            from geomesa_tpu_torch.subscribe import (
                LiveWindow, StandingQueryEngine,
            )

            self.standing = StandingQueryEngine(
                lambda nm: LiveWindow(self, nm)
            )
        return self.standing

    def subscribe(self, name: str, aggregate: str, bbox=None, region=None,
                  width: int = 256, height: int = 256,
                  levels: Optional[int] = None,
                  stat_spec: Optional[str] = None,
                  sub_id: Optional[str] = None) -> str:
        """Register a standing viewport over the live window: each applied
        poll batch updates the result incrementally — moves delta-apply
        (-old, +new), deletes/expiry re-scan only intersecting groups."""
        from geomesa_tpu_torch.subscribe import spec as subspec

        sp = subspec.make_spec(
            name, aggregate, bbox=bbox, region=region, width=width,
            height=height, levels=levels, stat_spec=stat_spec,
        )
        cache = self._caches[name]  # raise on unknown schema
        eng = self._standing_engine()
        sid = eng.register(sp, sub_id=sub_id)
        if cache.observer is None:
            cache.observer = eng.live_observer(name)
        return sid

    def unsubscribe(self, sub_id: str) -> bool:
        return (self.standing is not None
                and self.standing.unregister(sub_id))

    def subscription_poll(self, sub_id: str, cursor: int = 0):
        """Drain pending stream messages, then return the standing result
        + update records past ``cursor``."""
        from geomesa_tpu_torch.subscribe import UnknownSubscription

        if self.standing is None:
            raise UnknownSubscription(sub_id)
        self.poll()
        return self.standing.poll(sub_id, cursor)

    # -- producer ----------------------------------------------------------
    def write(self, name: str, data: Dict[str, Sequence], fids: Sequence[str],
              ts_ms: Optional[Sequence[int]] = None):
        """Produce Change messages for a batch of features."""
        ft = self._schemas[name]
        topic = self._topics[name]
        keys = list(data)
        n = len(fids)
        now = int(time.time() * 1000)
        dtg = ft.dtg_field
        for i in range(n):
            attrs: Dict[str, Any] = {}
            for k in keys:
                v = data[k][i]
                if isinstance(v, np.datetime64):
                    v = int(v.astype("datetime64[ms]").astype(np.int64))
                elif isinstance(v, np.generic):
                    v = v.item()
                elif isinstance(v, tuple):
                    v = list(v)
                attrs[k] = v
            if ts_ms is not None:
                ts = int(ts_ms[i])
            elif dtg is not None and dtg in attrs and attrs[dtg] is not None:
                ts = int(attrs[dtg])
            else:
                ts = now
            topic.send(GeoMessage.change(str(fids[i]), attrs, ts))

    def delete(self, name: str, fid: str):
        self._topics[name].send(GeoMessage.delete(fid, int(time.time() * 1000)))

    def clear(self, name: str):
        self._topics[name].send(GeoMessage.clear(int(time.time() * 1000)))

    # -- consumer (micro-batch) --------------------------------------------
    def _quarantine(self, name: str, part, error: BaseException,
                    phase: str) -> None:
        """Poison-message quarantine: count, record through the audit
        degradation trail, and move on; a bad message must never kill the
        consumer. The counters ride the process metrics registry, so
        ``/metrics`` shows quarantine volume beside the query counters:
        ``stream.poll.quarantined`` in all and per schema."""
        from geomesa_tpu_torch import metrics, resilience

        self.quarantined[name] = self.quarantined.get(name, 0) + 1
        metrics.inc(metrics.STREAM_POLL_QUARANTINED)
        metrics.inc(f"{metrics.STREAM_POLL_QUARANTINED}.{name}")
        resilience.record_skip(
            "stream.poll.decode", f"{name}/{part}", error, phase=phase
        )

    def poll(self, name: Optional[str] = None, max_messages: int = 100_000) -> int:
        """Consume pending messages into the live cache(s). Returns #consumed
        (quarantined poison messages are skipped, counted in
        :attr:`quarantined`, and NOT included in the returned count).

        Observability: each schema's apply phase
        runs under a ``stream.apply`` span + timer, and the ``stream.lag``
        gauge (plus a per-schema breakdown) tracks poll→apply latency —
        apply wall-clock minus the last applied message's event time, the
        consumer-lag signal /metrics exposes."""
        from geomesa_tpu_torch import metrics, tracing

        names = [name] if name else list(self._schemas)
        total = 0
        for nm in names:
            msgs, self._offsets[nm] = self._topics[nm].poll(
                self._offsets[nm], max_messages,
                on_error=lambda p, off, raw, e, nm=nm: self._quarantine(
                    nm, f"{p}@{off}", e, "decode"
                ),
            )
            cache = self._caches[nm]
            listeners = self._listeners[nm]
            if not msgs:
                # empty polls skip the span AND the timer: a tight idle
                # poll loop would otherwise flood stream.apply with ~0 s
                # samples and collapse its histogram quantiles exactly
                # when an operator investigates apply latency
                cache.expire()
                self._settle_standing(nm, cache)
                continue
            applied_ts: Optional[int] = None
            applied_msgs: List[Tuple[int, str, Any, int]] = []
            with tracing.span("stream.apply", schema=nm,
                              messages=len(msgs)) as sp, \
                    metrics.registry().timer(metrics.STREAM_APPLY).time():
                for m in msgs:
                    try:
                        if m.kind == CHANGE:
                            cache.validate(m.payload or {})
                            cache.put(m.fid, m.payload or {}, m.ts_ms)
                        elif m.kind == DELETE:
                            cache.remove(m.fid)
                        elif m.kind == CLEAR:
                            cache.clear()
                    except Exception as e:
                        # decoded but unappliable (bad payload types): same
                        # quarantine path as an undecodable message
                        self._quarantine(nm, m.fid or m.kind, e, "apply")
                        continue
                    applied_ts = m.ts_ms
                    if self._journal is not None:
                        applied_msgs.append(
                            (m.kind, m.fid, m.payload, m.ts_ms))
                    for fn in listeners:
                        try:
                            fn(m)
                        except Exception:
                            # a throwing listener is an observer bug, not a
                            # data fault: log it, keep the message (it
                            # applied) and the consumer alive
                            import logging

                            logging.getLogger(__name__).warning(
                                "feature listener failed on %s/%s",
                                nm, m.fid or m.kind, exc_info=True,
                            )
                    total += 1
                if applied_ts is not None:
                    lag_ms = max(int(time.time() * 1000) - applied_ts, 0)
                    sp.set(lag_ms=lag_ms)
                    metrics.registry().gauge(metrics.STREAM_LAG).set(lag_ms)
                    metrics.registry().gauge(
                        f"{metrics.STREAM_LAG}.{nm}"
                    ).set(lag_ms)
            if applied_msgs and self._journal is not None:
                # journaled WITH the post-batch source offsets: recovery
                # replays the batch into the cache, then resumes the topic
                # consumer past it — exactly-once for acked batches
                # (the stream-resume contract)
                self._journal.append({
                    "kind": "stream-batch", "schema": nm,
                    "offsets": list(self._offsets[nm]),
                    "msgs": [list(t) for t in applied_msgs],
                })
            if applied_ts is not None:
                # per-poll applied-batch counter:
                # with the epoch gauge below, the subscription-staleness
                # pair /metrics and /debug/queries expose
                metrics.inc(metrics.STREAM_POLL_BATCHES)
                metrics.inc(f"{metrics.STREAM_POLL_BATCHES}.{nm}")
            cache.expire()
            self._settle_standing(nm, cache)
        return total

    def _settle_standing(self, nm: str, cache: LiveFeatureCache) -> None:
        """Post-apply bookkeeping for one schema's poll round: export the
        window's mutation epoch as a gauge (``stream.epoch.<schema>`` —
        the staleness anchor standing results are versioned against) and
        fold any buffered cache events into the standing groups (ONE
        delta pass per applied batch)."""
        from geomesa_tpu_torch import metrics

        metrics.registry().gauge(f"{metrics.STREAM_EPOCH}.{nm}").set(
            cache.epoch
        )
        if self.standing is not None:
            self.standing.settle(nm)

    # -- local query runner (KafkaQueryRunner analog) ----------------------
    def _masked(self, name: str, ecql: "str | ir.Filter"):
        ft = self._schemas[name]
        cache = self._caches[name]
        batch = cache.batch()
        if batch.n == 0:
            return ft, cache, batch, np.zeros(0, dtype=bool)
        f = parse_ecql(ecql) if isinstance(ecql, str) else ecql
        cf = compile_filter(f, ft, cache.dicts)
        # validity: features with null geometry are invisible to queries
        # (GeoMesa's Kafka cache requires a geometry; this one masks)
        valid = np.ones(batch.n, dtype=bool)
        g = ft.geom_field
        if g is not None and g + "__x" in batch.columns:
            valid &= np.isfinite(batch.columns[g + "__x"])
        cand = cache.candidate_rows(f, batch)
        if cand is not None and len(cand) < batch.n:
            sub = ColumnBatch(
                {k: v[cand] for k, v in batch.columns.items()}, len(cand)
            )
            sub_mask = cf.exact_mask(sub.columns, len(cand))
            mask = np.zeros(batch.n, dtype=bool)
            mask[cand[sub_mask]] = True
        else:
            mask = cf.exact_mask(batch.columns, batch.n)
        return ft, cache, batch, mask & valid

    def query(self, name: str, ecql: "str | ir.Filter" = "INCLUDE") -> ColumnBatch:
        self.poll(name)
        _, _, batch, mask = self._masked(name, ecql)
        if batch.n == 0:
            return batch
        return batch.select(mask)

    def count(self, name: str, ecql: "str | ir.Filter" = "INCLUDE") -> int:
        self.poll(name)
        _, _, _, mask = self._masked(name, ecql)
        return int(mask.sum())

    def density(self, name: str, ecql: "str | ir.Filter" = "INCLUDE",
                bbox=(-180, -90, 180, 90), width: int = 256,
                height: int = 256) -> np.ndarray:
        """Density over the live window (DensityScan on the stream)."""
        self.poll(name)
        ft, _, batch, mask = self._masked(name, ecql)
        g = ft.geom_field
        if batch.n == 0:
            return np.zeros((height, width), np.float32)
        xs = batch.columns[g + "__x"]
        ys = batch.columns[g + "__y"]
        if self.prefer_device:
            # the window uploads per call, its points rounded to f32 as the
            # reference's device arrays are
            dev = self.device
            grid = kdensity.density_grid(
                torch.from_numpy(np.asarray(xs, np.float32)).to(dev),
                torch.from_numpy(np.asarray(ys, np.float32)).to(dev),
                torch.from_numpy(np.ascontiguousarray(mask)).to(dev),
                tuple(bbox), width, height,
            )
            return grid.cpu().numpy()
        return kdensity.density_grid_np(xs, ys, mask, tuple(bbox), width, height)

    def stats(self, name: str, stat_spec: str,
              ecql: "str | ir.Filter" = "INCLUDE"):
        from geomesa_tpu_torch.kernels.stats_scan import decode_enum_keys
        from geomesa_tpu_torch.stats import parse_stat

        self.poll(name)
        _, cache, batch, mask = self._masked(name, ecql)
        stat = parse_stat(stat_spec)
        if batch.n:
            sel = batch.select(mask)
            if sel.n:
                stat.observe(sel.columns)
                decode_enum_keys(stat, cache.dicts)
        return stat


def playback(ds: "StreamingDataset", name: str, data: Dict[str, Sequence],
             fids: Sequence[str], dtg_ms: Sequence[int], rate: float = 10.0,
             batch_ms: int = 1000, sleep: bool = False):
    """Replay a dtg-ordered dataset onto the stream (tools `playback`):
    batches of ``batch_ms`` event-time are produced at ``rate``x speed."""
    order = np.argsort(np.asarray(dtg_ms, np.int64), kind="stable")
    ts = np.asarray(dtg_ms, np.int64)[order]
    keys = list(data)
    start = 0
    while start < len(order):
        end = start
        t0 = ts[start]
        while end < len(order) and ts[end] - t0 < batch_ms:
            end += 1
        rows = order[start:end]
        ds.write(
            name,
            {k: [data[k][i] for i in rows] for k in keys},
            [fids[i] for i in rows],
            ts_ms=ts[start:end],
        )
        if sleep and rate > 0:
            time.sleep(batch_ms / 1000.0 / rate)
        start = end
