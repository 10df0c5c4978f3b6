"""PyTorch port vs the JAX package: span tracing and the cost ledger.

The same seeded rows sit in a flat and a time-partitioned store of each
package (the JAX side runs its Pallas kernels in interpret mode, with
compaction forced and ``geomesa.mesh.devices`` 1, so both take the same
scan paths). Each call runs traced in both packages, and the finished
traces must agree:

* the preorder list of (depth, span name, attribute keys) is equal for
  count, density, density_curve, stats, query, query_batches, knn, the
  query-axis batches, a cached partial-cover call, partitioned calls and
  the joins, the kernel registry's ``kernel.recompile`` events included
  (each package's process-wide join registry starts empty for the
  module). Times and the values of ``site`` / ``device`` are not compared;
* the cost ledger is equal exactly, ``recompiles`` included, except the
  ``device_ms.<id>`` times, which compare by key. ``bytes_staged`` is
  compared on cold calls of fresh stores: later calls stage what is not
  yet resident, and the port keeps device columns per column where the
  reference keeps them per column set.

The partitioned span trees compare with the prefetch pipeline off, where
the order of siblings is fixed; with it on, the worker's ``scan.stage``
spans interleave with the query thread's, so those trees compare as
multisets. The rest holds the port's tracing to the reference's own
contract (``tests/test_tracing.py``): the no-op path, the span budget, the
slow-query log, the streamed root of ``query_batches``, the finished-trace
ring, and ``torch.profiler`` ranges under ``geomesa.trace.jax.profiler``.
"""

import gc
import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import audit as jaudit
from geomesa_tpu import config as jconfig
from geomesa_tpu import tracing as jtracing
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu_torch import GeoDataset, Query, audit, config, metrics, tracing
from geomesa_tpu_torch.filter.ecql import parse_iso_ms

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 4000
BOX = ("BBOX(geom, -110, 28, -75, 48) AND "
       "dtg DURING 2020-01-03T00:00:00Z/2020-01-20T00:00:00Z")
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
MEMBERS = ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)"]
POLYS = ["POLYGON((-100 30, -90 30, -90 40, -100 40, -100 30))",
         "POLYGON((-85 35, -75 35, -80 45, -85 35))"]
#: cost keys that hold times: compared by key only
TIME_COST = ("device_ms.",)


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


def _fill(ds, spec, spill=None):
    ds.create_schema("t", spec)
    if spill is not None:
        st = ds._store("t")
        st.max_resident = 2
        st._spill_dir = spill
    ds.insert("t", _data(), fids=np.arange(N).astype(str))
    ds.flush("t")
    rng = np.random.default_rng(3)
    m = 300
    ds.create_schema("s", SPEC)
    ds.insert("s", {"name": [f"s{i}" for i in range(m)], "weight": rng.uniform(0, 1, m),
                    "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-15"),
                                        m).astype("datetime64[ms]"),
                    "geom__x": rng.uniform(-120, -70, m),
                    "geom__y": rng.uniform(25, 50, m)},
              fids=np.arange(m).astype(str))
    ds.flush("s")
    ds.create_schema("poly", "name:String,*geom:Polygon")
    ds.insert("poly", {"name": ["a", "b"], "geom": POLYS}, fids=["a", "b"])
    ds.flush("poly")


@pytest.fixture(scope="module", autouse=True)
def fresh_join_registries():
    """Each package's process-wide join registry starts empty, so earlier
    modules' joins leave no entries behind on one side only."""
    from geomesa_tpu.planning import join_exec as jjoin_exec
    from geomesa_tpu_torch.planning import join_exec

    jjoin_exec._REGISTRY = None
    join_exec._REGISTRY = None
    yield


@pytest.fixture(scope="module")
def knobs():
    """The JAX package's knobs that put both packages on the same scan
    paths, for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        mp.setenv("GEOMESA_LAKE_ROWGROUP_ROWS", "512")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            yield
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


def _pair(spec, tmp=None):
    out = []
    for ds, tag in ((JGeoDataset(n_shards=4), "j"),
                    (GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                                compact_fraction=2.0), "p")):
        _fill(ds, spec, None if tmp is None else str(tmp / tag))
        out.append(ds)
    return out


@pytest.fixture(scope="module")
def flat(knobs):
    return _pair(SPEC)


@pytest.fixture(scope="module")
def part(knobs, tmp_path_factory):
    return _pair(PSPEC, tmp_path_factory.mktemp("spill"))


def _pkg(ds):
    """(config, tracing, Query) of the dataset's package."""
    if isinstance(ds, GeoDataset):
        return config, tracing, Query
    return jconfig, jtracing, JQuery


def traced(ds, fn, **knobs):
    """Run ``fn(ds, Query)`` with tracing on (and ``knobs``, by config
    attribute name); the finished trace."""
    cfg, tr, q = _pkg(ds)
    scopes = [cfg.TRACE_ENABLED.scoped("true")]
    scopes += [getattr(cfg, k).scoped(v) for k, v in knobs.items()]
    for s in scopes:
        s.__enter__()
    try:
        fn(ds, q)
    finally:
        for s in reversed(scopes):
            s.__exit__(None, None, None)
    return tr.last_trace()


def preorder(trace):
    """(depth, name, attribute keys) of every span and event, preorder."""
    out = []

    def walk(s, d):
        out.append((d, s.name, tuple(sorted(s.attrs))))
        for c in s.children:
            walk(c, d + 1)

    walk(trace.root, 0)
    return out


def ledger(trace):
    """The cost ledger, times as ``"<time>"``."""
    return {k: "<time>" if k.startswith(TIME_COST) else v
            for k, v in trace.cost.items()}


OPS = {
    "count": lambda ds, Q: ds.count("t", BOX),
    "count_polygon": lambda ds, Q: ds.count("t", f"INTERSECTS(geom, {TRI})"),
    "count_dwithin": lambda ds, Q: ds.count(
        "t", "DWITHIN(geom, POINT(-90 40), 100, kilometers)"),
    "count_fid": lambda ds, Q: ds.count("t", "IN ('1','2','3')"),
    "count_attr": lambda ds, Q: ds.count("t", "name = 'actor1'"),
    "density": lambda ds, Q: ds.density("t", BOX, width=32, height=32),
    "density_weighted": lambda ds, Q: ds.density("t", BOX, width=32, height=32,
                                                 weight="weight"),
    "density_curve": lambda ds, Q: ds.density_curve("t", BOX, level=6),
    "stats": lambda ds, Q: ds.stats("t", "Count();MinMax(weight)", BOX),
    "stats_frequency": lambda ds, Q: ds.stats("t", "Frequency(name,64)", BOX),
    "query": lambda ds, Q: ds.query("t", BOX),
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
}

JOINS = {
    "join_spatial_dwithin": lambda ds: ds.join_spatial("t", "s", predicate="dwithin",
                                                       distance=0.5),
    "join_count_meters": lambda ds: ds.join_count("t", "s", predicate="dwithin_meters",
                                                  distance=20000.0),
    "join_count_bbox": lambda ds: ds.join_count("t", "s", predicate="bbox", dx=0.3, dy=0.3),
    "join_spatial_pip": lambda ds: ds.join_spatial("t", "poly", predicate="pip"),
    "explain_join": lambda ds: ds.explain_join("t", "s", predicate="dwithin", distance=0.5,
                                               analyze=True),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_span_tree_and_ledger_flat(flat, op):
    j, p = flat
    tj = traced(j, OPS[op])
    tp = traced(p, OPS[op])
    assert preorder(tp) == preorder(tj)
    assert ledger(tp) == ledger(tj)
    assert tp.root.attrs == tj.root.attrs
    assert not tp.error and not tp.degraded


@pytest.mark.parametrize("op", sorted(JOINS))
def test_span_tree_and_ledger_joins(flat, op):
    j, p = flat
    tj = traced(j, lambda ds, Q: JOINS[op](ds))
    tp = traced(p, lambda ds, Q: JOINS[op](ds))
    assert preorder(tp) == preorder(tj)
    assert ledger(tp) == ledger(tj)
    names = [n for _, n, _ in preorder(tp)]
    assert "scan.join.sides" in names
    assert any(n in names for n in ("scan.join.pairs", "scan.join.brute", "scan.join.poly"))


@pytest.mark.parametrize("op", ["count", "density", "density_curve", "stats", "query",
                                "query_batches", "query_sorted", "knn", "count_batch",
                                "density_curve_batch"])
def test_span_tree_and_ledger_partitioned(part, op):
    """With the prefetch pipeline off the siblings' order is fixed."""
    j, p = part
    tj = traced(j, OPS[op], PIPELINE_PREFETCH="false")
    tp = traced(p, OPS[op], PIPELINE_PREFETCH="false")
    assert preorder(tp) == preorder(tj)
    assert ledger(tp) == ledger(tj)
    names = [n for _, n, _ in preorder(tp)]
    # a strict feature stream runs its partitions outside scan.partition
    assert ("scan.partition" in names) == (op not in ("query", "query_batches"))
    assert "scan.stage" not in names
    cost = tp.cost
    assert cost["partitions_scanned"] + cost["partitions_pruned"] == len(
        p._store("t").partition_bins())


def _gate_stage_on_first_scan(monkeypatch):
    """Make each package's prefetch worker stage a partition after the
    first only once the query thread has scanned one.

    The worker stages partition k+1 from ``plan.needed_cols``, which the
    query thread sets when it scans partition k (the port's
    ``PartitionedExecutor._stage`` and the reference's read it alike). The
    worker loads partition 2 while the query thread scans partition 1, so
    under load it may read ``needed_cols`` before the scan sets it and
    stage nothing for partition 2: a cold count's ``bytes_staged`` then
    depends on timing in both packages. The gate waits (at most 30 s) for
    the value before every stage but the first, which fixes what is
    staged; it changes neither package's staging."""
    from geomesa_tpu.planning.partitioned_exec import (
        PartitionedExecutor as JPartitionedExecutor,
    )
    from geomesa_tpu_torch.planning.partitioned_exec import PartitionedExecutor

    for cls in (JPartitionedExecutor, PartitionedExecutor):
        orig = cls._stage
        calls = {}

        def gated(self, child, plan, _orig=orig, _calls=calls):
            n = _calls[id(plan)] = _calls.get(id(plan), 0) + 1
            if n > 1:
                deadline = time.monotonic() + 30.0
                while not plan.__dict__.get("needed_cols") and time.monotonic() < deadline:
                    time.sleep(0.001)
            return _orig(self, child, plan)

        monkeypatch.setattr(cls, "_stage", gated)


def test_partitioned_prefetch_stage_spans_and_bytes_staged(knobs, tmp_path, monkeypatch):
    """Prefetch on: the worker's ``scan.stage`` spans land in the query's
    tree (the worker adopts the query thread's span); the trees are equal
    as multisets, and a cold count on fresh stores stages the same bytes
    once the worker's stages after the first wait for the first scan (see
    :func:`_gate_stage_on_first_scan` for the race this removes)."""
    _gate_stage_on_first_scan(monkeypatch)
    j, p = _pair(PSPEC, tmp_path)
    tj = traced(j, OPS["count"], PIPELINE_PREFETCH="true")
    tp = traced(p, OPS["count"], PIPELINE_PREFETCH="true")
    assert sorted(preorder(tp)) == sorted(preorder(tj))
    assert ledger(tp) == ledger(tj)
    assert tp.cost["bytes_staged"] > 0
    stages = [s for s in tp.root.children if s.name == "scan.stage"]
    parts = [s for s in tp.root.children if s.name == "scan.partition"]
    assert len(stages) == len(parts) == int(tp.cost["partitions_scanned"])
    assert sorted(s.attrs["part"] for s in stages) == sorted(s.attrs["part"] for s in parts)


@pytest.mark.parametrize("op", ["count", "density", "stats"])
def test_span_tree_cached_partial_call(flat, op):
    """The aggregate cache's spans and ``cache_hits``: a cold decomposed
    call, a pan that reuses cells, and a whole-result hit (two cells an
    axis: the JAX side compiles every new cell shape)."""
    j, p = flat
    calls = {
        "count": lambda box: lambda ds, Q: ds.count("t", box),
        "density": lambda box: lambda ds, Q: ds.density("t", box, width=16, height=16,
                                                        bbox=(-120, 25, -70, 50)),
        "stats": lambda box: lambda ds, Q: ds.stats("t", "Count();MinMax(weight)", box),
    }[op]
    q1 = "BBOX(geom, -112.5, 22.5, -67.5, 45.0) AND name = 'actor1'"
    q2 = "BBOX(geom, -106.0, 22.5, -67.5, 45.0) AND name = 'actor1'"
    from geomesa_tpu.cache import AggregateCache as JAggregateCache
    from geomesa_tpu_torch.cache import AggregateCache

    j.cache, p.cache = JAggregateCache(), AggregateCache()
    try:
        for i, q in enumerate((q1, q2, q1)):
            tj = traced(j, calls(q), CACHE_ENABLED="true", CACHE_CELLS_PER_AXIS="2")
            tp = traced(p, calls(q), CACHE_ENABLED="true", CACHE_CELLS_PER_AXIS="2")
            assert preorder(tp) == preorder(tj), q
            assert ledger(tp) == ledger(tj), q
            names = [n for _, n, _ in preorder(tp)]
            assert ("cache.cells" in names) == (i < 2) and ("cache.merge" in names) == (i < 2)
            if i == 1:
                assert ledger(tp).get("cache_hits", 0) >= 1  # the pan reused cells
        assert ledger(tp)["cache_hits"] == 1.0
        assert [n for _, n, _ in preorder(tp)] == [op, "plan", "cache.lookup"]
    finally:
        j.cache, p.cache = JAggregateCache(), AggregateCache()


def test_explain_analyze_ledger_partitioned(part):
    """``explain(analyze=True)`` traced: the count under the explain root
    fills the same ledger."""
    j, p = part
    tj = traced(j, lambda ds, Q: ds.explain("t", BOX, analyze=True),
                PIPELINE_PREFETCH="false")
    tp = traced(p, lambda ds, Q: ds.explain("t", BOX, analyze=True),
                PIPELINE_PREFETCH="false")
    assert preorder(tp) == preorder(tj)
    assert ledger(tp) == ledger(tj)


def test_audit_event_carries_the_trace_id(flat):
    j, p = flat
    tp = traced(p, OPS["count"])
    ev = p.audit.recent(1)[0]
    assert ev.hints["trace_id"] == tp.trace_id
    assert tracing.finished_trace(tp.trace_id)["tree"]["name"] == "count"
    assert tracing.finished_trace("nope") is None


def test_per_stage_histograms(flat):
    _, p = flat
    before = metrics.registry().histogram("trace.scan.kernel").count
    traced(p, OPS["density"])
    reg = metrics.registry()
    assert reg.histogram("trace.scan.kernel").count == before + 1
    assert reg.histogram("trace.density").count >= 1


# -- the off path ---------------------------------------------------------------------
def test_disabled_span_is_shared_noop_singleton():
    assert not tracing.enabled()
    assert tracing.span("plan") is tracing.NOOP
    assert tracing.span("scan.kernel") is tracing.NOOP
    assert tracing.start("query") is tracing.NOOP
    assert tracing.current_trace_id() is None
    assert tracing.current_cost() == {}
    tracing.add_cost("bytes_staged", 1.0)  # no trace: nothing to add to
    tracing.mark_degraded()
    tracing.event("x")
    with tracing.span("x") as s:
        assert s.set(part=1) is s


def test_disabled_span_path_allocates_nothing():
    tracing.span("warmup")
    gc.collect()
    tracemalloc.start()
    for _ in range(1000):
        tracing.span("hot")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 2048, f"no-op span path allocated {peak} bytes over 1000 calls"


def test_disabled_span_takes_no_lock_and_reads_no_clock(monkeypatch):
    """With no trace, ``span()`` reads the ContextVar and returns: it
    neither builds a Trace (whose lock it would take) nor reads the
    clock."""
    calls = []
    monkeypatch.setattr(tracing.time, "perf_counter",
                        lambda: calls.append(1) or 0.0)
    monkeypatch.setattr(tracing, "Trace", lambda *a, **k: calls.append(2))
    monkeypatch.setattr(tracing.threading, "Lock", lambda: calls.append(3))
    for _ in range(100):
        with tracing.span("hot"):
            pass
    assert calls == []


def test_untraced_calls_answer_alike_and_leave_no_trace(flat):
    _, p = flat
    tracing._last[0] = None
    n = p.count("t", BOX)
    assert tracing.last_trace() is None
    with config.TRACE_ENABLED.scoped("true"):
        assert p.count("t", BOX) == n
    assert tracing.last_trace().root.name == "count"


# -- the reference's contract ------------------------------------------------------
def test_span_budget_bounds_tree():
    with config.TRACE_ENABLED.scoped("true"), config.TRACE_MAX_SPANS.scoped("4"):
        with tracing.start("query") as root:
            for i in range(16):
                with tracing.span(f"s{i}"):
                    pass
        tr = root.trace
    assert tr.n_spans <= 4
    assert tr.dropped > 0
    assert tracing.finished_trace(tr.trace_id)["dropped_spans"] == tr.dropped


def test_nested_public_call_joins_the_outer_trace(flat):
    """``unique`` runs ``stats``: one trace, the op's root once."""
    _, p = flat
    with config.TRACE_ENABLED.scoped("true"):
        with tracing.start("outer") as root:
            p.count("t", BOX)
            p.unique("t", "name", BOX)
    names = [n for d, n, _ in preorder(root.trace) if d == 1]
    assert names == ["count", "stats"]


def test_slow_query_writes_span_tree_jsonl(flat, tmp_path):
    _, p = flat
    path = tmp_path / "audit.jsonl"
    with config.TRACE_ENABLED.scoped("true"), config.AUDIT_PATH.scoped(str(path)), \
            config.TRACE_SLOW_MS.scoped("0"):
        n = p.count("t", BOX)
    audit._appender.reset()
    assert n > 0
    tid = tracing.last_trace().trace_id
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    slow = [ln for ln in lines if ln.get("kind") == "slow_trace"]
    assert len(slow) == 1
    rec = slow[0]
    assert rec["trace_id"] == tid and rec["threshold_ms"] == 0.0
    assert rec["tree"]["name"] == "count"
    assert [c["name"] for c in rec["tree"]["children"]][0] == "plan"
    # the query event rides the same file first: the audit fires inside
    # the root span
    ev_idx = max(i for i, ln in enumerate(lines)
                 if ln.get("hints", {}).get("trace_id") == tid)
    assert ev_idx < lines.index(rec)
    assert tracing.slow_traces(1)[0]["trace_id"] == tid


def test_slow_log_record_matches_reference_shape(flat, tmp_path):
    """The slow record's keys and tree layout equal the reference's."""
    recs = []
    for ds, cfg, tr, aud in ((flat[0], jconfig, jtracing, jaudit),
                             (flat[1], config, tracing, audit)):
        path = tmp_path / f"{type(ds).__module__.split('.')[0]}.jsonl"
        with cfg.TRACE_ENABLED.scoped("true"), cfg.AUDIT_PATH.scoped(str(path)), \
                cfg.TRACE_SLOW_MS.scoped("0"):
            ds.count("t", BOX)
        aud._appender.reset()
        recs.append([json.loads(ln) for ln in path.read_text().splitlines()
                     if '"slow_trace"' in ln][-1])

    def shape(tree):
        return (tree["name"], sorted(tree.get("attrs", {})),
                [shape(c) for c in tree.get("children", ())])

    assert sorted(recs[0]) == sorted(recs[1])
    assert shape(recs[1]["tree"]) == shape(recs[0]["tree"])


def test_late_child_stretches_finished_root_for_slow_check():
    import time as _t

    tracing.clear_slow_traces()
    with config.TRACE_ENABLED.scoped("true"), config.TRACE_SLOW_MS.scoped("5"):
        root = tracing.start("outer")
        with root:
            child = tracing.span("query_batches")
            child.t0 = _t.perf_counter()
        assert not tracing.slow_traces()
        _t.sleep(0.02)
        child.finish()
        assert tracing.slow_traces(), "a late child must trip the check again"


def test_query_batches_root_closes_at_stream_end(flat):
    _, p = flat
    with config.TRACE_ENABLED.scoped("true"):
        it = p.query_batches("t", BOX)
        # the eager plan ran under the stream's root, which stepped aside
        assert tracing.current_span() is None
        got = sum(b.n for b in it)
        tr = tracing.last_trace()
        assert tracing.current_span() is None
        with tracing.start("consumer") as outer:
            it2 = p.query_batches("t", BOX)
            assert tracing.current_span() is outer
            with tracing.span("inner") as inner:
                assert sum(b.n for b in it2) == got
                # the stream restored the consumer's span
                assert tracing.current_span() is inner
    assert got > 0
    assert tr.root.name == "query_batches" and tr.finished
    names = [n for _, n, _ in preorder(tr)]
    assert names[:2] == ["query_batches", "plan"] and "scan.sync" in names
    assert p.audit.recent(2)[0].hits == got
    assert p.audit.recent(2)[0].hints["trace_id"] == tr.trace_id
    # nested: a child of the consumer's trace
    assert [n for d, n, _ in preorder(outer.trace) if d == 1] == [
        "query_batches", "inner"]


def test_query_batches_root_finishes_when_planning_raises(flat):
    _, p = flat
    with config.TRACE_ENABLED.scoped("true"):
        with pytest.raises(KeyError):
            p.query_batches("t", "nosuch = 1")
    tr = tracing.last_trace()
    assert tr.root.name == "query_batches" and tr.finished
    assert tracing.current_span() is None


def test_error_escaping_the_root_is_recorded(flat):
    _, p = flat
    with config.TRACE_ENABLED.scoped("true"):
        with pytest.raises(KeyError):
            p.count("t", "nosuch = 1")
    assert tracing.last_trace().error == "KeyError"


def test_render_and_retained_ring():
    with config.TRACE_ENABLED.scoped("true"), config.TRACE_RETAIN.scoped("2"):
        ids = []
        for _ in range(3):
            with tracing.start("op", schema="t") as root:
                with tracing.span("plan"):
                    pass
            ids.append(root.trace.trace_id)
    assert tracing.finished_trace(ids[0]) is None
    assert [r["trace_id"] for r in tracing.finished_traces(ids[2])] == [ids[2]]
    text = tracing.render(tracing.last_trace())
    lines = text.splitlines()
    assert lines[0].startswith("op: ") and lines[0].endswith(" ms [schema=t]")
    assert lines[1].startswith("  plan: ")
    assert tracing.render(tracing.last_trace().root.to_dict()) == text
    tracing.clear_retained()
    assert tracing.finished_trace(ids[2]) is None


def test_worker_adopts_the_query_span():
    """``snapshot`` / ``adopt`` carry the span to another thread; the
    trace's lock orders concurrent appends."""
    with config.TRACE_ENABLED.scoped("true"):
        with tracing.start("op") as root:
            snap = tracing.snapshot()

            def work(i):
                tracing.adopt(snap)
                for _ in range(50):
                    with tracing.span(f"w{i}"):
                        tracing.add_cost("n", 1.0)

            ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
    assert len(root.children) == 200
    assert root.trace.cost == {"n": 200.0}


def test_profiler_ranges_under_the_profiler_knob(flat):
    """``geomesa.trace.jax.profiler`` opens one ``record_function`` range
    per span, named ``geomesa:<span>``."""
    _, p = flat
    with config.TRACE_ENABLED.scoped("true"), config.TRACE_JAX_PROFILER.scoped("true"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            p.count("t", BOX)
    names = {e.name for e in prof.events()}
    assert {"geomesa:count", "geomesa:plan", "geomesa:scan.kernel",
            "geomesa:scan.sync"} <= names
    with config.TRACE_ENABLED.scoped("true"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            p.count("t", BOX)
    assert not any(e.name.startswith("geomesa:") for e in prof.events())


@pytest.mark.parametrize("path", ["tracing.py", "audit.py", "planning/interceptors.py"])
def test_observability_modules_import_no_jax(path):
    """The import rule of the port's sources (``tests/test_torch_slice.py``
    collects every module) holds for this slice's modules."""
    import ast
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "geomesa_tpu_torch" / path
    for node in ast.walk(ast.parse(src.read_text())):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                else [])
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "geomesa_tpu"), (path, mod)


def test_chip_smoke_span_constants_hold_on_the_cpu():
    """``chip_smoke.py``'s slice-14 phase holds each warm traced main-path
    call's preorder span names to ``S14_SPANS``; the same calls on a small
    compacted store give the same lists here."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ds = GeoDataset(n_shards=8, device="cpu", compact_min_rows=1)
    ds.create_schema("gdelt", "weight:Float,dtg:Date,*geom:Point")
    ds.insert("gdelt", cs.make_data(100_000, 7))
    ds.flush("gdelt")
    q_bbox = f"{cs.BOX} AND {cs.DURING}"
    q_poly = f"INTERSECTS(geom, {cs.polygon_wkt()}) AND {cs.DURING}"
    grid = dict(bbox=cs.QUERY_BBOX, width=64, height=64)
    calls = {
        "count_bbox": lambda: ds.count("gdelt", q_bbox),
        "density": lambda: ds.density("gdelt", q_bbox, **grid),
        "density_weighted": lambda: ds.density("gdelt", q_bbox, weight="weight", **grid),
        "count_polygon": lambda: ds.count("gdelt", q_poly),
    }
    assert sorted(calls) == sorted(cs.S14_SPANS)
    for key, fn in calls.items():
        fn()
        with config.TRACE_ENABLED.scoped("true"):
            fn()
        assert cs.span_names(tracing.last_trace()) == cs.S14_SPANS[key], key
        path = ds._plan("gdelt", q_poly if key == "count_polygon" else q_bbox).exec_path
        assert path["scan"] == "device-compact"
