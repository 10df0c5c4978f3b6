"""Standing-query engine.

Copy of ``geomesa_tpu/subscribe/engine.py``, cut to ``GeoDataset`` windows.
A dataset attaches one engine on its first ``subscribe``. The engine keeps
the registered viewports as **standing groups** (same-spec subscribers fuse
into one group, ``serving/fuse.py::subscription_key``) and advances every
group as mutations apply:

* an **additive batch** (an insert) runs the shared evaluator
  (``delta.py``) once over the batch's rows and folds each group's partial
  into its result: ``subscribe.update.dispatches`` counts one pass per
  applied batch per schema, however many groups watch;
* a **non-additive mutation** (delete, age-off) re-scans only the groups
  whose viewport intersects the mutation's bounds.

A delta-applied result equals a re-scan at the same epoch bit for bit;
``geomesa.subscribe.verify`` asserts it after every update. A subscription
id embeds its fleet route key (``schema:z<lvl>:<prefix>:<uuid>``), and
:meth:`StandingQueryEngine.export_groups` / :meth:`import_groups` move
groups between datasets: a matching ``{count, spec}`` guard adopts the
results and update rings as they are, a mismatch re-scans and emits a
``resync`` update.

The reference's ``LiveWindow``, ``live_observer`` and ``settle`` serve
``StreamingDataset`` and come with the port's ``stream/`` (ROADMAP
Queue 1, host layers).
"""

from __future__ import annotations

import threading
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config, metrics
from geomesa_tpu_torch.subscribe import delta as dl
from geomesa_tpu_torch.subscribe.spec import StandingSpec


class UnknownSubscription(KeyError):
    """Typed miss: this dataset holds no such subscription."""

    MARKER = "[GM-SUB-UNKNOWN]"

    def __init__(self, sub_id: str):
        super().__init__(f"{self.MARKER} no subscription {sub_id!r}")


def route_key_of(sub_id: str) -> str:
    """The ring key embedded in a subscription id (the uuid tail cut)."""
    return sub_id.rsplit(":", 1)[0]


class StoreWindow:
    """A ``GeoDataset`` schema's whole store as a standing window."""

    def __init__(self, ds, name: str):
        self.ds = ds
        self.name = name

    @property
    def st(self):
        return self.ds._store(self.name)

    @property
    def ft(self):
        return self.st.ft

    @property
    def dicts(self):
        return self.st.dicts

    def columns(self) -> Tuple[Dict[str, np.ndarray], int]:
        st = self.st
        st.flush()
        if st._all is None:
            return {}, 0
        return st._all.columns, st._all.n

    def epoch(self) -> int:
        return int(self.st.version)

    def guard(self) -> Dict[str, Any]:
        st = self.st
        return {"count": int(st.count), "spec": st.ft.spec()}

    def validate(self, spec: StandingSpec) -> None:
        from geomesa_tpu_torch.index.partitioned import PartitionedFeatureStore

        if isinstance(self.st, PartitionedFeatureStore):
            # spilled partitions leave host memory: the re-scan contract
            # does not hold (the reference refuses them too)
            raise ValueError(
                "[GM-SUB] standing queries do not support partitioned "
                f"schemas yet ({self.name!r})"
            )
        g = self.ft.geom_field
        if g is None or not self.ft.attr(g).is_point:
            raise ValueError(
                f"[GM-SUB] standing queries need a point-geometry schema ({spec.schema!r})")
        if spec.aggregate == "stats":
            from geomesa_tpu_torch.cache.service import stats_exact_merge
            from geomesa_tpu_torch.stats import parse_stat

            if not stats_exact_merge(parse_stat(spec.stat_spec)):
                raise ValueError(
                    "[GM-SUB] stats subscriptions need exact-merge sketches "
                    f"(cache/service.EXACT_MERGE_KINDS); got {spec.stat_spec!r}"
                )


@dataclass
class StandingGroup:
    """One fused viewport: the result its subscribers share and the
    bounded ring of per-update records."""

    spec: StandingSpec
    cf: Any                      # compiled viewport mask
    result: Any
    version: int = 0
    epoch: int = 0
    subscribers: set = field(default_factory=set)
    updates: deque = field(default_factory=deque)

    def emit(self, kind: str, rows: int, epoch: int) -> None:
        self.version += 1
        self.epoch = epoch
        cap = config.SUBSCRIBE_UPDATES_RING.to_int() or 256
        self.updates.append({"version": self.version, "kind": kind, "rows": int(rows),
                             "epoch": int(epoch)})
        while len(self.updates) > cap:
            self.updates.popleft()
        metrics.inc(metrics.SUBSCRIBE_UPDATES)


class StandingQueryEngine:
    """Registered viewports and their incremental upkeep for one dataset."""

    def __init__(self, window_of: Callable[[str], Any]):
        self._window_of = window_of
        self._groups: Dict[str, Dict[tuple, StandingGroup]] = {}
        self._subs: Dict[str, Tuple[str, tuple]] = {}  # sub_id -> (schema, key)
        self._lock = threading.RLock()

    def active(self, schema: str) -> bool:
        """Does ``schema`` hold any group? (the ingest path's fast gate)"""
        return bool(self._groups.get(schema))

    # -- registration ------------------------------------------------------
    def register(self, spec: StandingSpec, sub_id: Optional[str] = None) -> str:
        if not config.SUBSCRIBE_ENABLED.to_bool():
            raise ValueError("[GM-SUB] standing queries are disabled (geomesa.subscribe.enabled)")
        with self._lock:
            win = self._window_of(spec.schema)
            win.validate(spec)
            key = spec.key()
            groups = self._groups.setdefault(spec.schema, {})
            grp = groups.get(key)
            if grp is None:
                cap = config.SUBSCRIBE_MAX_GROUPS.to_int() or 256
                if len(groups) >= cap:
                    raise ValueError(
                        f"[GM-SUB-LIMIT] schema {spec.schema!r} already holds {cap} "
                        "distinct standing groups")
                cf = dl.compile_viewport(spec, win.ft, win.dicts)
                cols, n = win.columns()
                result, rows = dl.eval_rows(spec, cf, win.ft, cols, n, win.dicts)
                grp = StandingGroup(spec=spec, cf=cf, result=result, epoch=win.epoch())
                grp.emit("snapshot", rows, win.epoch())
                groups[key] = grp
            else:
                # the new subscriber rides the existing result: no scan
                metrics.inc(metrics.SUBSCRIBE_FUSED)
            if sub_id is None:
                sub_id = self.make_sub_id(spec)
            grp.subscribers.add(sub_id)
            self._subs[sub_id] = (spec.schema, key)
            self._set_gauges()
            return sub_id

    def make_sub_id(self, spec: StandingSpec) -> str:
        """A routable subscription id for ``spec``, made before the journal
        record so a replay registers the same id."""
        return f"{spec.route_key(self._routing_level())}:{uuid.uuid4().hex[:12]}"

    def schema_of(self, sub_id: str) -> Optional[str]:
        with self._lock:
            got = self._subs.get(sub_id)
            return got[0] if got else None

    def subscriptions(self, schema: str) -> List[Dict[str, Any]]:
        """The schema's live subscriptions as ``[{"sub_id", "spec"}]`` sorted
        by id: the manifest entry ``save`` writes and ``load`` replays."""
        with self._lock:
            out = []
            for sid, (sch, key) in self._subs.items():
                grp = self._groups.get(sch, {}).get(key) if sch == schema else None
                if grp is not None:
                    out.append({"sub_id": sid, "spec": grp.spec.to_dict()})
            return sorted(out, key=lambda r: r["sub_id"])

    def unregister(self, sub_id: str) -> bool:
        with self._lock:
            got = self._subs.pop(sub_id, None)
            if got is None:
                return False
            schema, key = got
            grp = self._groups.get(schema, {}).get(key)
            if grp is not None:
                grp.subscribers.discard(sub_id)
                if not grp.subscribers:
                    del self._groups[schema][key]
                    if not self._groups[schema]:
                        del self._groups[schema]
            self._set_gauges()
            return True

    @staticmethod
    def _routing_level() -> int:
        lvl = config.FLEET_ROUTING_LEVEL.to_int()
        return 3 if lvl is None else max(1, min(int(lvl), 15))

    def _set_gauges(self) -> None:
        reg = metrics.registry()
        reg.gauge(metrics.SUBSCRIBE_GROUPS).set(sum(len(g) for g in self._groups.values()))
        reg.gauge(metrics.SUBSCRIBE_SUBSCRIBERS).set(len(self._subs))

    # -- reads -------------------------------------------------------------
    def poll(self, sub_id: str, cursor: int = 0) -> Dict[str, Any]:
        """The current result and every update record past ``cursor``; a
        poller seeing ``updates[0].version > cursor + 1`` lagged past the
        ring and re-anchors on the full result."""
        with self._lock:
            got = self._subs.get(sub_id)
            if got is None:
                raise UnknownSubscription(sub_id)
            schema, key = got
            grp = self._groups[schema][key]
            return {
                "sub_id": sub_id,
                "schema": schema,
                "aggregate": grp.spec.aggregate,
                "version": grp.version,
                "epoch": grp.epoch,
                "subscribers": len(grp.subscribers),
                "result": dl.encode_result(grp.spec, grp.result),
                "updates": [u for u in grp.updates if u["version"] > int(cursor)],
            }

    def snapshot(self) -> Dict[str, Any]:
        """The operator view (``/debug/queries``' ``subscriptions``)."""
        with self._lock:
            out = []
            for schema, groups in sorted(self._groups.items()):
                for grp in groups.values():
                    out.append({
                        "schema": schema,
                        "aggregate": grp.spec.aggregate,
                        "bbox": list(grp.spec.bbox),
                        "region": bool(grp.spec.region),
                        "subscribers": len(grp.subscribers),
                        "version": grp.version,
                        "epoch": grp.epoch,
                    })
            return {"groups": out, "subscribers": len(self._subs)}

    # -- mutation hooks (GeoDataset's edges; journal replay too) -----------
    def on_batch(self, schema: str, cols: Dict[str, np.ndarray], n: int) -> None:
        """An applied additive batch: one evaluation pass over its rows
        updates every group of the schema."""
        with self._lock:
            groups = self._groups.get(schema)
            if not groups or n == 0:
                return
            win = self._window_of(schema)
            epoch = win.epoch()
            metrics.inc(metrics.SUBSCRIBE_DISPATCHES)
            for grp in groups.values():
                d, rows = dl.eval_rows(grp.spec, grp.cf, win.ft, cols, n, win.dicts)
                if rows:
                    grp.result = dl.apply_delta(grp.spec, grp.result, d)
                    grp.emit("delta", rows, epoch)
                else:
                    grp.epoch = epoch
            self._verify_all(schema)

    def on_dirty(self, schema: str, bounds=None) -> None:
        """A non-additive mutation: re-scan only the groups whose viewport
        intersects ``bounds`` (None: all)."""
        with self._lock:
            groups = self._groups.get(schema)
            if not groups:
                return
            win = self._window_of(schema)
            epoch = win.epoch()
            cols_n = None
            for grp in groups.values():
                if not grp.spec.intersects(bounds):
                    grp.epoch = epoch
                    continue
                if cols_n is None:
                    cols_n = win.columns()
                self._rescan(win, grp, cols_n, "rescan", epoch)
            self._verify_all(schema)

    def _rescan(self, win, grp: StandingGroup, cols_n, kind: str, epoch: int) -> None:
        cols, n = cols_n
        grp.result, rows = dl.eval_rows(grp.spec, grp.cf, win.ft, cols, n, win.dicts)
        grp.emit(kind, rows, epoch)
        metrics.inc(metrics.SUBSCRIBE_RESCANS)

    def _verify_all(self, schema: str) -> None:
        """Under ``geomesa.subscribe.verify``: every group against a re-scan
        at this epoch, bit for bit."""
        if not config.SUBSCRIBE_VERIFY.to_bool():
            return
        groups = self._groups.get(schema)
        if not groups:
            return
        win = self._window_of(schema)
        cols, n = win.columns()
        for grp in groups.values():
            fresh, _ = dl.eval_rows(grp.spec, grp.cf, win.ft, cols, n, win.dicts)
            metrics.inc(metrics.SUBSCRIBE_VERIFY)
            if not dl.results_equal(grp.spec, grp.result, fresh):
                raise AssertionError(
                    f"[GM-SUB-VERIFY] standing {grp.spec.aggregate} over {schema!r} diverged "
                    f"from the epoch-{win.epoch()} re-scan (viewport {grp.spec.bbox})"
                )

    # -- migration between datasets ----------------------------------------
    def export_groups(self, schema: Optional[str] = None, keys: Optional[List[str]] = None,
                      remove: bool = False) -> Dict[str, Any]:
        """Every group (or those whose route key is in ``keys``) in wire
        form, with each schema's ``{count, spec}`` guard. ``remove`` drops
        the exported groups here."""
        with self._lock:
            want = None if keys is None else set(keys)
            out: List[Dict[str, Any]] = []
            guards: Dict[str, Any] = {}
            drop: List[Tuple[str, tuple]] = []
            lvl = self._routing_level()
            for nm, groups in self._groups.items():
                if schema is not None and nm != schema:
                    continue
                for key, grp in groups.items():
                    rk = grp.spec.route_key(lvl)
                    if want is not None and rk not in want:
                        continue
                    if nm not in guards:
                        guards[nm] = self._window_of(nm).guard()
                    out.append({
                        "spec": grp.spec.to_dict(),
                        "route_key": rk,
                        "subscribers": sorted(grp.subscribers),
                        "version": grp.version,
                        "epoch": grp.epoch,
                        "result": dl.encode_result(grp.spec, grp.result),
                        "updates": list(grp.updates),
                    })
                    metrics.inc(metrics.SUBSCRIBE_HANDOFF_EXPORTED)
                    if remove:
                        drop.append((nm, key))
            for nm, key in drop:
                for sid in self._groups[nm][key].subscribers:
                    self._subs.pop(sid, None)
                del self._groups[nm][key]
                if not self._groups[nm]:
                    del self._groups[nm]
            if drop:
                self._set_gauges()
            return {"groups": out, "guards": guards}

    def import_groups(self, payload: Dict[str, Any]) -> Dict[str, int]:
        """Adopt exported groups: a matching guard proves this window holds
        the rows the results were kept over, so results and rings transfer
        as they are; a mismatch keeps the subscribers, re-scans the local
        window and emits a ``resync`` update (the version sequence stays
        contiguous either way)."""
        with self._lock:
            adopted = resynced = 0
            guards = payload.get("guards") or {}
            for g in payload.get("groups") or []:
                spec = StandingSpec.from_dict(g["spec"])
                win = self._window_of(spec.schema)
                win.validate(spec)
                key = spec.key()
                groups = self._groups.setdefault(spec.schema, {})
                grp = groups.get(key)
                if grp is None:
                    cf = dl.compile_viewport(spec, win.ft, win.dicts)
                    grp = StandingGroup(spec=spec, cf=cf, result=dl.zero_result(spec))
                    groups[key] = grp
                grp.version = max(grp.version, int(g.get("version", 0)))
                guard = guards.get(spec.schema) or {}
                local = win.guard()
                if int(guard.get("count", -1)) == int(local["count"]) \
                        and guard.get("spec") == local["spec"]:
                    grp.result = dl.decode_result(spec, g["result"])
                    grp.epoch = win.epoch()
                    grp.updates = deque(g.get("updates") or [])
                    adopted += 1
                    metrics.inc(metrics.SUBSCRIBE_HANDOFF_IMPORTED)
                else:
                    self._rescan(win, grp, win.columns(), "resync", win.epoch())
                    resynced += 1
                    metrics.inc(metrics.SUBSCRIBE_HANDOFF_RESYNC)
                for sid in g.get("subscribers") or []:
                    grp.subscribers.add(sid)
                    self._subs[sid] = (spec.schema, key)
            self._set_gauges()
            return {"adopted": adopted, "resynced": resynced}

    # -- schema lifecycle --------------------------------------------------
    def drop_schema(self, schema: str) -> None:
        with self._lock:
            groups = self._groups.pop(schema, None)
            for grp in (groups or {}).values():
                for sid in grp.subscribers:
                    self._subs.pop(sid, None)
            self._set_gauges()

    def reattach(self, schema: str) -> None:
        """The schema's store was replaced (a reload): recompile every
        viewport against the new dictionaries and re-scan."""
        with self._lock:
            groups = self._groups.get(schema)
            if not groups:
                return
            win = self._window_of(schema)
            cols_n = win.columns()
            epoch = win.epoch()
            for grp in groups.values():
                grp.cf = dl.compile_viewport(grp.spec, win.ft, win.dicts)
                self._rescan(win, grp, cols_n, "rescan", epoch)
