"""PyTorch port vs the JAX package: the query audit log.

Both packages hold the same seeded rows in a flat and a time-partitioned
store (the JAX side with its Pallas kernels in interpret mode, compaction
forced and ``geomesa.mesh.devices`` 1). Every public call writes its
``QueryEvent`` (one per member of a query-axis batch, one per join), and
the events of the two packages are equal field by field except:

* times (``date``, ``plan_time_ms``, ``scan_time_ms`` and the hint
  ``device_coarse_ms``) and the values of ``trace_id``;
* in ``exec_path``: ``density_kernel`` (the reference's CPU run takes its
  einsum rung, the port scatters); the route of a ``kernel:<name>`` note
  (the reference's ``pallas``, the port's ``plain`` on CPU tensors: the
  key compares, and the registry's ``kernel`` and ``shape_bucket`` notes
  compare whole); and the notes the port's feature scan adds
  (``feature_scan`` with its ``B`` and ``band_rows``), which the
  reference's feature scan does not record;
* a partitioned call's ``exec_path`` compares on ``lake`` and
  ``lake_fallback`` only: the port's holds the last partition's notes and
  every partition's under ``partitions``, the reference's accumulates
  every partition's notes into one dict.

Under ``allow_partial()`` each skipped partition writes one
``DegradationEvent``, equal between the packages, and marks the trace
degraded. The JSONL file at ``geomesa.audit.path`` gets one line per
event.
"""

import json
from dataclasses import asdict

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import audit as jaudit
from geomesa_tpu import config as jconfig
from geomesa_tpu import resilience as jres
from geomesa_tpu import tracing as jtracing
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu_torch import GeoDataset, Query, audit, config, resilience, tracing
from geomesa_tpu_torch.filter.ecql import parse_iso_ms

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 4000
BOX = ("BBOX(geom, -110, 28, -75, 48) AND "
       "dtg DURING 2020-01-03T00:00:00Z/2020-01-20T00:00:00Z")
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
MEMBERS = ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)"]
#: a box small enough that the lake row groups prune
PBOX = ("BBOX(geom, -100, 30, -96, 34) AND "
        "dtg DURING 2020-01-03T00:00:00Z/2020-01-20T00:00:00Z")
TIMES = ("date", "plan_time_ms", "scan_time_ms")
FEATURE_NOTES = ("feature_scan", "B", "band_rows")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=N, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "name": [f"actor{i % 5}" for i in range(n)],
        "weight": rng.uniform(0, 10, n),
        "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-15"),
                            n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX, port): a flat schema ``t``, a partitioned ``pt`` spilled to
    lake files, and a point schema ``s`` to join against."""
    data = _data()
    fids = np.arange(N).astype(str)
    rng = np.random.default_rng(3)
    m = 300
    sdata = {"name": [f"s{i}" for i in range(m)], "weight": rng.uniform(0, 1, m),
             "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-15"),
                                 m).astype("datetime64[ms]"),
             "geom__x": rng.uniform(-120, -70, m), "geom__y": rng.uniform(25, 50, m)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        mp.setenv("GEOMESA_LAKE_ROWGROUP_ROWS", "256")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            out = []
            for ds, tag in ((JGeoDataset(n_shards=4), "j"),
                            (GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                                        compact_fraction=2.0), "p")):
                ds.create_schema("t", SPEC)
                ds.insert("t", data, fids=fids)
                ds.create_schema("pt", PSPEC)
                st = ds._store("pt")
                st.max_resident = 2
                st._spill_dir = str(tmp_path_factory.mktemp(f"{tag}spill"))
                ds.insert("pt", data, fids=fids)
                ds.create_schema("s", SPEC)
                ds.insert("s", sdata, fids=np.arange(m).astype(str))
                for name in ("t", "pt", "s"):
                    ds.flush(name)
                st.spill_all()
                out.append(ds)
            yield out
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


def _pkg(ds):
    if isinstance(ds, GeoDataset):
        return config, tracing, Query
    return jconfig, jtracing, JQuery


def events(ds, fn, trace=True):
    """``fn(ds, Query)``'s new audit events, and the trace."""
    cfg, tr, q = _pkg(ds)
    n0 = len(ds.audit.events)
    with cfg.TRACE_ENABLED.scoped("true" if trace else "false"):
        fn(ds, q)
    return list(ds.audit.events)[n0:], tr.last_trace()


def norm(ev, ref_path=None, partitioned=False):
    """An event as a dict without the fields that may differ (see the
    module docstring); ``ref_path``: the reference event's exec_path, for
    the feature-scan notes."""
    d = asdict(ev)
    for k in TIMES:
        d.pop(k)
    h = dict(d["hints"])
    h.pop("trace_id", None)
    h.pop("device_coarse_ms", None)
    path = h.pop("exec_path", None)
    if path is not None:
        path = {k: "<route>" if k.startswith("kernel:") else v
                for k, v in path.items() if k != "density_kernel"}
        if "feature_scan" in path:
            path = {k: v for k, v in path.items()
                    if k not in FEATURE_NOTES or k in (ref_path or {})}
        if partitioned:
            path = {k: v for k, v in path.items() if k in ("lake", "lake_fallback")}
        if path:
            h["exec_path"] = path
    d["hints"] = h
    return d


def assert_events_equal(jev, pev, partitioned=False):
    assert len(pev) == len(jev)
    for je, pe in zip(jev, pev):
        ref_path = je.hints.get("exec_path")
        assert norm(pe, ref_path, partitioned) == norm(je, None, partitioned)


OPS = {
    "count": lambda ds, Q: ds.count("t", BOX),
    "count_estimate": lambda ds, Q: ds.count("t", BOX, exact=False),
    "count_polygon": lambda ds, Q: ds.count("t", f"INTERSECTS(geom, {TRI})"),
    "count_dwithin": lambda ds, Q: ds.count(
        "t", "DWITHIN(geom, POINT(-90 40), 100, kilometers)"),
    "count_fid": lambda ds, Q: ds.count("t", "IN ('1','2','3')"),
    "count_region": lambda ds, Q: ds.count("t", BOX, region=TRI),
    "density": lambda ds, Q: ds.density("t", BOX, width=32, height=32),
    "density_weighted": lambda ds, Q: ds.density("t", BOX, width=32, height=32,
                                                 weight="weight"),
    "density_curve": lambda ds, Q: ds.density_curve("t", BOX, level=6),
    "stats": lambda ds, Q: ds.stats("t", "Count();MinMax(weight)", BOX),
    "unique": lambda ds, Q: ds.unique("t", "name", BOX),
    "query": lambda ds, Q: ds.query("t", Q(ecql=BOX, max_features=7)),
    "query_sampled": lambda ds, Q: ds.query("t", Q(ecql=BOX, sampling=3)),
    "query_sorted": lambda ds, Q: ds.query(
        "t", Q(ecql=BOX, sort_by=[("weight", True)], max_features=5)),
    "query_batches": lambda ds, Q: list(ds.query_batches("t", BOX)),
    "knn": lambda ds, Q: ds.knn("t", -90, 40, k=5),
    "count_batch": lambda ds, Q: ds.count_batch("t", MEMBERS),
    "density_batch": lambda ds, Q: ds.density_batch("t", MEMBERS, width=16, height=16),
    "stats_batch": lambda ds, Q: ds.stats_batch("t", "Count()", MEMBERS),
    "density_curve_batch": lambda ds, Q: ds.density_curve_batch(
        "t", BOX, level=6, bboxes=[(-110, 28, -90, 40), (-100, 30, -80, 45)]),
    "density_curve_filter_batch": lambda ds, Q: ds.density_curve_filter_batch(
        "t", MEMBERS, level=6),
    "join_spatial": lambda ds, Q: ds.join_spatial("t", "s", predicate="dwithin",
                                                  distance=0.5),
    "join_count": lambda ds, Q: ds.join_count("t", "s", predicate="bbox", dx=0.3, dy=0.3),
}

#: events each op writes
N_EVENTS = {"count_estimate": 0, "knn": 0, "count_batch": 2, "density_batch": 2,
            "stats_batch": 2, "density_curve_batch": 2, "density_curve_filter_batch": 2}


@pytest.mark.parametrize("op", sorted(OPS))
def test_query_events_equal_flat(pair, op):
    j, p = pair
    jev, _ = events(j, OPS[op])
    pev, tr = events(p, OPS[op])
    assert len(pev) == N_EVENTS.get(op, 1)
    assert_events_equal(jev, pev)
    for e in pev:
        assert e.hints["trace_id"] == tr.trace_id
        # a stream's event is written at its end, after the call returned,
        # outside the call's identity: the reference's user is "" there
        assert e.user == ("" if op == "query_batches" else "anonymous")
        assert e.store == "geomesa-tpu"
        assert e.type_name == "t"


PART_OPS = {
    "count": lambda ds, Q: ds.count("pt", PBOX),
    "density": lambda ds, Q: ds.density("pt", PBOX, width=32, height=32),
    "density_weighted": lambda ds, Q: ds.density("pt", PBOX, width=32, height=32,
                                                 weight="weight"),
    "density_curve": lambda ds, Q: ds.density_curve("pt", PBOX, level=6),
    "stats": lambda ds, Q: ds.stats("pt", "Count();MinMax(weight)", PBOX),
    "query": lambda ds, Q: ds.query("pt", PBOX),
    "count_batch": lambda ds, Q: ds.count_batch("pt", MEMBERS),
}


@pytest.mark.parametrize("op", sorted(PART_OPS))
def test_query_events_equal_partitioned(pair, op):
    """Spilled lake partitions: a pruned load's account rides the event,
    popped once (the second call reports its own)."""
    j, p = pair
    for _ in range(2):
        jev, _ = events(j, PART_OPS[op])
        pev, tr = events(p, PART_OPS[op])
        assert_events_equal(jev, pev, partitioned=True)
        if op in ("count", "density", "density_curve", "stats"):
            lake = pev[0].hints["exec_path"]["lake"]
            assert lake == jev[0].hints["exec_path"]["lake"]
            assert tr.cost["lake_bytes_read"] == pev[0].hints["lake"]["bytes_loaded"]
            assert tr.cost["lake_bytes_skipped"] == pev[0].hints["lake"]["bytes_skipped"]


def test_query_event_equal_pushdown_join(pair):
    """A count-only join streams its partitioned right side through lake
    windows; its event and the ``join_pushdown_bytes`` cost equal the
    reference's."""
    j, p = pair
    def call(ds, Q):
        return ds.join_count("s", "pt", predicate="dwithin", distance=0.5,
                             left_query="BBOX(geom, -110, 28, -90, 40)",
                             right_query="dtg DURING 2020-01-03T00:00:00Z/2020-01-12T00:00:00Z")

    jev, jt = events(j, call)
    pev, pt = events(p, call)
    assert_events_equal(jev, pev, partitioned=True)
    assert pev[0].hints["pushdown"]["bytes_loaded"] > 0
    for k in ("join_pushdown_bytes", "join_cells", "join_candidate_pairs"):
        assert pt.cost[k] == jt.cost[k]
    assert pt.cost["join_pushdown_bytes"] == pev[0].hints["pushdown"]["bytes_loaded"]


def test_lake_account_is_reported_once(pair):
    """The audit pops the plan's lake account: a cached plan's next call
    that reads nothing new reports no stale account."""
    _, p = pair
    events(p, PART_OPS["count"])
    plan = p._plan("pt", PBOX)
    assert "lake_acct" not in plan.__dict__ and "degraded" not in plan.__dict__


def test_batch_members_attribution(pair):
    j, p = pair
    members = [{"trace_id": "feedbeef", "user": "ann"}, {}]
    jev, _ = events(j, lambda ds, Q: ds.count_batch("t", MEMBERS, members=members))
    pev, _ = events(p, lambda ds, Q: ds.count_batch("t", MEMBERS, members=members))
    assert_events_equal(jev, pev)
    assert pev[0].hints["trace_id"] == "feedbeef" and pev[0].user == "ann"
    assert pev[0].hints["user"] == "ann" and "user" not in pev[1].hints
    assert pev[1].user == "anonymous" and pev[1].scanned == 0
    assert pev[1].plan_time_ms == pev[1].scan_time_ms == 0.0
    with pytest.raises(ValueError, match="members must align"):
        p.count_batch("t", MEMBERS, members=[{}])


def test_user_and_untraced_events(pair):
    j, p = pair
    for ds, cfg in ((j, jconfig), (p, config)):
        with cfg.USER.scoped("ops-team"):
            ds.count("t", BOX)
    assert p.audit.recent(1)[0].user == j.audit.recent(1)[0].user == "ops-team"
    jev, _ = events(j, OPS["count"], trace=False)
    pev, _ = events(p, OPS["count"], trace=False)
    assert "trace_id" not in pev[0].hints and "trace_id" not in jev[0].hints
    assert_events_equal(jev, pev)


def test_audit_disabled_writes_nothing(pair):
    _, p = pair
    with config.AUDIT_ENABLED.scoped("false"):
        pev, _ = events(p, OPS["count"])
    assert pev == []


def test_jsonl_file_one_line_per_event(pair, tmp_path):
    """Every event kind goes through one appender; the JSON equals the
    reference's for the same call."""
    lines = []
    for ds, cfg, aud in ((pair[0], jconfig, jaudit), (pair[1], config, audit)):
        path = tmp_path / f"{type(ds).__module__.split('.')[0]}.jsonl"
        with cfg.AUDIT_PATH.scoped(str(path)):
            ds.count("t", BOX)
            ds.density("t", BOX, width=8, height=8)
            ds.count_batch("t", MEMBERS)
        aud._appender.reset()
        lines.append([json.loads(ln) for ln in path.read_text().splitlines()])
    jl, pl = lines
    assert len(pl) == len(jl) == 4
    for a, b in zip(jl, pl):
        assert sorted(a) == sorted(b)
        assert sorted(a["hints"]) == sorted(b["hints"])
        assert (a["op"] if "op" in a else a["hints"]["op"]) == b["hints"]["op"]
        assert (a["hits"], a["scanned"], a["table_rows"], a["filter"]) == (
            b["hits"], b["scanned"], b["table_rows"], b["filter"])


def test_appender_follows_a_rotated_file(pair, tmp_path):
    _, p = pair
    path = tmp_path / "audit.jsonl"
    with config.AUDIT_PATH.scoped(str(path)):
        p.count("t", BOX)
        path.rename(tmp_path / "audit.jsonl.1")
        p.count("t", BOX)
    audit._appender.reset()
    assert len(path.read_text().splitlines()) == 1
    assert len((tmp_path / "audit.jsonl.1").read_text().splitlines()) == 1


def _faulted(ds, mod, cfg, fn, bins):
    with cfg.FAULT_INJECTION.scoped("true"):
        with mod.inject_faults(seed=2) as inj:
            for b in bins:
                inj.fail("exec.partition.scan", times=None,
                         where=lambda ctx, b=b: ctx.get("bin") == b)
            with mod.allow_partial() as coll:
                fn(ds)
            return coll.skipped


def _deg(ev):
    d = asdict(ev)
    d.pop("date")
    return d


@pytest.mark.parametrize("op", ["count", "density", "stats", "query"])
def test_degradation_events_equal(pair, op):
    """One partition fails at ``exec.partition.scan`` under
    ``allow_partial()``: each package writes one ``DegradationEvent``
    naming it, the trace is degraded, and the query event's ``degraded``
    account equals the reference's."""
    j, p = pair
    bins = p._executor("pt").prune(p._plan("pt", BOX))
    dead = [bins[1]]
    fn = {"count": lambda ds: ds.count("pt", BOX),
          "density": lambda ds: ds.density("pt", BOX, width=16, height=16),
          "stats": lambda ds: ds.stats("pt", "Count()", BOX),
          "query": lambda ds: ds.query("pt", BOX)}[op]
    out = []
    for ds, mod, cfg, aud, tr in ((j, jres, jconfig, jaudit, jtracing),
                                  (p, resilience, config, audit, tracing)):
        d0 = len(aud.degradations.events)
        q0 = len(ds.audit.events)
        with cfg.TRACE_ENABLED.scoped("true"):
            skipped = _faulted(ds, mod, cfg, fn, dead)
        out.append((skipped, list(aud.degradations.events)[d0:],
                    list(ds.audit.events)[q0:], tr.last_trace()))
    (js, jd, jq, jt), (ps, pd, pq, pt) = out
    assert [(s.source, s.part, s.phase) for s in ps] == [
        (s.source, s.part, s.phase) for s in js] == [
        ("exec.partition.scan", f"bin:{dead[0]}", op if op != "query" else "features")]
    assert [_deg(e) for e in pd] == [_deg(e) for e in jd]
    assert len(pd) == 1 and pd[0].part == f"bin:{dead[0]}"
    assert pt.degraded and jt.degraded
    assert_events_equal(jq, pq, partitioned=True)
    assert pq[0].hints["degraded"][0]["part"] == f"bin:{dead[0]}"


def test_degradation_log_respects_the_audit_gate(pair):
    _, p = pair
    d0 = len(audit.degradations.events)
    with config.AUDIT_ENABLED.scoped("false"):
        _faulted(p, resilience, config, lambda ds: ds.count("pt", BOX),
                 [p._executor("pt").prune(p._plan("pt", BOX))[0]])
    assert len(audit.degradations.events) == d0
    assert resilience.skipped()  # the process trail still records it


def test_no_encoding_without_a_file(pair, tmp_path, monkeypatch):
    """An event is JSON-encoded only when ``geomesa.audit.path`` names a
    file: the in-memory ring costs no encoding."""
    _, p = pair
    calls = []
    real = audit.QueryEvent.to_json
    monkeypatch.setattr(audit.QueryEvent, "to_json",
                        lambda self: calls.append(1) or real(self))
    p.count("t", BOX)
    assert calls == [] and p.audit.recent(1)[0].hits > 0
    with config.AUDIT_PATH.scoped(str(tmp_path / "a.jsonl")):
        p.count("t", BOX)
    audit._appender.reset()
    assert calls == [1]
    assert json.loads((tmp_path / "a.jsonl").read_text())["hits"] == p.audit.recent(1)[0].hits
