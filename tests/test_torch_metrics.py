"""The metric names of the ported paths against the JAX package's: the
per-call deltas of ``journal.*``, ``join.*``, ``lake.*``,
``pipeline.prefetch``, ``compact.desc.shared`` and the ``query.scan`` /
``query.density`` / ``query.plan`` timers in each package's process
registry, for a journaled insert and its checkpoint and replay, a pairwise
and a polygon join, a pushdown join count, lake-pushdown scans over a
spilled time-partitioned store, a long window through the prefetch
pipeline, and ``density`` / ``query`` calls; then the ``/metrics`` text
listing every new series. Counters compare by value, histograms and timers
by their count. The prefetch worker is gated on the first scan (as in
``tests/test_torch_trace.py``), which fixes what it stages in both
packages."""

import contextlib
import time

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu_torch import GeoDataset, obs
from geomesa_tpu_torch import config as pconfig
from geomesa_tpu_torch import metrics as pmetrics
from geomesa_tpu_torch.filter.ecql import parse_iso_ms

#: the families this slice names in the port
PREFIXES = ("journal.", "join.", "lake.", "pipeline.prefetch", "compact.desc.shared",
            "query.scan", "query.density", "query.plan")
SPEC = "weight:Float,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 3_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def both(**knobs):
    with contextlib.ExitStack() as stack:
        for name, v in knobs.items():
            stack.enter_context(getattr(jconfig, name).scoped(v))
            stack.enter_context(getattr(pconfig, name).scoped(v))
        yield


def _counts(reg):
    """name -> counter value, or histogram / timer count, for this slice's
    families."""
    out = {}
    for name, v in reg.report().items():
        if not name.startswith(PREFIXES):
            continue
        if isinstance(v, dict):
            out[name] = v["count"]
        elif name != pmetrics.JOURNAL_LAG:
            out[name] = v
    return out


def _delta(reg, fn):
    before = _counts(reg)
    fn()
    after = _counts(reg)
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def deltas(jfn, pfn):
    """(port deltas, JAX deltas) of the two calls."""
    return _delta(pmetrics.registry(), pfn), _delta(jmetrics.registry(), jfn)


def _data(n=N, seed=21):
    """Rows around six hotspots over four weeks: a box around one prunes
    most row groups."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-115, -75, 6), rng.uniform(28, 47, 6)
    k = rng.integers(0, 6, n)
    return {
        "weight": rng.uniform(0, 10, n).astype(np.float32),
        "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-01-29"),
                            n).astype("datetime64[ms]"),
        "geom__x": np.clip(cx[k] + rng.normal(0, 0.3, n), -120, -70),
        "geom__y": np.clip(cy[k] + rng.normal(0, 0.3, n), 25, 50),
    }


def _hot_box(pad=0.5):
    d = _data()
    hx, hy = d["geom__x"][0], d["geom__y"][0]
    return f"BBOX(geom, {hx - pad}, {hy - pad}, {hx + pad}, {hy + pad})"


def _gate_stage_on_first_scan(monkeypatch):
    """Each package's prefetch worker stages a partition after the first
    only once the query thread has scanned one (it reads the scan's
    ``needed_cols``), so what it stages does not depend on timing."""
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


@pytest.fixture(scope="module")
def lake(tmp_path_factory):
    """(JAX, port) time-partitioned stores, every partition spilled as a
    lake snapshot of 128-row groups; one resident partition at a time."""
    out = []
    with pytest.MonkeyPatch.context() as mp, both(LAKE_ROWGROUP_ROWS=128), \
            jconfig.MESH_DEVICES.scoped(1):
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        for cls, kw in ((JGeoDataset, {}), (GeoDataset, {"device": "cpu"})):
            ds = cls(n_shards=2, **kw)
            ds.create_schema("t", PSPEC)
            st = ds._store("t")
            st.max_resident = 1
            st._spill_dir = str(tmp_path_factory.mktemp("spill"))
            ds.insert("t", _data(), fids=np.arange(N).astype(str))
            ds.flush("t")
            st.spill_all()
            out.append(ds)
        yield tuple(out)


def _flat_data():
    """Schemas ``a`` and ``b``, ``b`` the rows of ``a`` moved a little
    (every row has join partners nearby)."""
    a = _data()
    return {"a": a, "b": dict(a, geom__x=a["geom__x"] + 0.02, geom__y=a["geom__y"] - 0.01)}


@pytest.fixture(scope="module")
def flat():
    """(JAX on its host runner, port) with the flat schemas ``a`` and ``b``:
    the joins count alike on either JAX path, and the host runner compiles
    nothing."""
    out = []
    for cls, kw in ((JGeoDataset, {"prefer_device": False}), (GeoDataset, {"device": "cpu"})):
        ds = cls(n_shards=2, **kw)
        for name, data in _flat_data().items():
            ds.create_schema(name, SPEC)
            ds.insert(name, data, fids=np.arange(N).astype(str))
            ds.flush(name)
        out.append(ds)
    return tuple(out)


def _without(d, *keys):
    return {k: v for k, v in d.items() if k not in keys}


# -- the journal ------------------------------------------------------------------------
def test_journal_metrics(tmp_path):
    """Two journaled inserts, a checkpoint and a replay on load."""
    data = _data(200, seed=5)
    ds = {}
    for tag, cls, kw in (("j", JGeoDataset, {}), ("p", GeoDataset, {"device": "cpu"})):
        d = cls(n_shards=2, **kw)
        root = str(tmp_path / tag)
        d.attach_journal(root)
        d.create_schema("t", SPEC)
        ds[tag] = (d, root)
    (j, jroot), (p, proot) = ds["j"], ds["p"]

    def inserts(d):
        def fn():
            for lo in (0, 100):
                d.insert("t", {k: v[lo:lo + 100] for k, v in data.items()},
                         fids=np.arange(lo, lo + 100).astype(str))
        return fn

    got, want = deltas(inserts(j), inserts(p))
    assert got == want
    assert got["journal.appends"] == 2 and got["journal.group.size"] == 2
    assert got["journal.fsync_ms"] == 2
    # records past the checkpoint replay on load
    got, want = deltas(lambda: j.save(jroot), lambda: p.save(proot))
    assert got == want and got.get("journal.truncated_bytes", 0) > 0
    for d in (j, p):
        d.insert("t", {k: v[:7] for k, v in data.items()},
                 fids=np.arange(1000, 1007).astype(str))
    got, want = deltas(lambda: JGeoDataset.load(jroot),
                       lambda: GeoDataset.load(proot, device="cpu"))
    assert got == want and got["journal.replayed"] == 1


# -- joins ----------------------------------------------------------------------------
@pytest.mark.parametrize("predicate,kw", [
    ("dwithin", {"distance": 0.05}),
    ("bbox", {"dx": 0.05, "dy": 0.05}),
], ids=["dwithin", "bbox"])
def test_join_metrics(flat, predicate, kw):
    j, p = flat
    got, want = deltas(lambda: j.join_spatial("a", "b", predicate=predicate, **kw),
                       lambda: p.join_spatial("a", "b", predicate=predicate, **kw))
    assert got == want
    assert got["join.queries"] == 1 and got["join.pairs"] > 0
    assert got["join.candidate.pairs"] >= got["join.pairs"]


def test_pushdown_join_count_metrics(flat, lake):
    """A count-only dwithin join of a flat left side against the spilled,
    partitioned right side: the window-pushdown side scans."""
    (jf, pf), (jl, pl) = flat, lake
    for ds, other in ((jf, jl), (pf, pl)):
        ds._stores["r"] = other._store("t")
    try:
        q = _hot_box(1.0)
        got, want = deltas(
            lambda: jf.join_count("a", "r", predicate="dwithin", distance=0.05, left_query=q),
            lambda: pf.join_count("a", "r", predicate="dwithin", distance=0.05, left_query=q))
    finally:
        for ds in (jf, pf):
            ds._stores.pop("r", None)
    # the side scans' whole-partition loads: the port reads only the
    # columns and tables a scan needs, the reference also the other index
    # tables' keys; and the prefetch stages ride the side scans' plans
    assert _without(got, "lake.bytes.read", "pipeline.prefetch") == \
        _without(want, "lake.bytes.read", "pipeline.prefetch")
    assert 0 < got["lake.bytes.read"] <= want["lake.bytes.read"]
    assert got["join.queries"] == 1 and got.get("join.pushdown.bytes", 0) > 0


# -- the lake tier and the prefetch pipeline ----------------------------------------------
@pytest.mark.parametrize("op", ["count", "density"])
def test_lake_pushdown_scan_metrics(lake, op, monkeypatch):
    _gate_stage_on_first_scan(monkeypatch)
    j, p = lake
    q = f"{_hot_box()} AND dtg DURING 2020-01-02T00:00:00Z/2020-01-20T00:00:00Z"

    def call(ds):
        if op == "count":
            return lambda: ds.count("t", q)
        return lambda: ds.density("t", q, bbox=(-120, 25, -70, 50), width=64, height=32)

    with jconfig.MESH_DEVICES.scoped(1):
        got, want = deltas(call(j), call(p))
    assert got == want
    assert got["lake.pushdown.scans"] > 0 and got["lake.rowgroups.pruned"] > 0
    assert got["lake.bytes.read"] > 0 and got["lake.bytes.skipped"] > 0
    if op == "density":
        assert got["query.density"] == 1


def test_long_window_prefetch_metrics(lake, monkeypatch):
    """A weighted density loads whole partitions through the prefetch
    pipeline: one stage for every partition after the first."""
    _gate_stage_on_first_scan(monkeypatch)
    j, p = lake
    q = "dtg DURING 2020-01-01T00:00:00Z/2020-01-29T00:00:00Z"
    with jconfig.MESH_DEVICES.scoped(1), both(PIPELINE_PREFETCH="true"):
        got, want = deltas(
            lambda: j.density("t", q, bbox=(-120, 25, -70, 50), width=64, height=32,
                              weight="weight"),
            lambda: p.density("t", q, bbox=(-120, 25, -70, 50), width=64, height=32,
                              weight="weight"))
    # whole-partition loads: the port reads only the columns and tables the
    # scan needs, the reference also the other index tables' keys
    assert _without(got, "lake.bytes.read") == _without(want, "lake.bytes.read")
    assert 0 < got["lake.bytes.read"] <= want["lake.bytes.read"]
    assert got["pipeline.prefetch"] == len(p._store("t").partition_bins()) - 1


# -- the executor and the query timers ------------------------------------------------------
def test_density_and_query_timers_and_shared_descriptors(flat):
    """On the JAX device path (the host runner compacts nothing)."""
    _, p = flat
    j = JGeoDataset(n_shards=2)
    j.create_schema("a", SPEC)
    j.insert("a", _flat_data()["a"], fids=np.arange(N).astype(str))
    j.flush("a")
    q1 = "BBOX(geom, -110, 30, -80, 45) AND dtg DURING 2020-01-03T00:00:00Z/2020-01-20T00:00:00Z"
    q2 = q1 + " AND weight >= 0"
    with both(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=1e9):
        got, want = deltas(
            lambda: j.density("a", q1, bbox=(-110, 30, -80, 45), width=64, height=32),
            lambda: p.density("a", q1, bbox=(-110, 30, -80, 45), width=64, height=32))
        assert got == want == {"query.density": 1, "query.plan": 1}
        got, want = deltas(lambda: j.count("a", q2), lambda: p.count("a", q2))
        assert got == want == {"compact.desc.shared": 1, "query.plan": 1}
        got, want = deltas(lambda: j.query("a", q2), lambda: p.query("a", q2))
        assert got == want == {"query.scan": 1}
        got, want = deltas(
            lambda: j.density_curve("a", q1, level=6, bbox=(-110, 30, -80, 45)),
            lambda: p.density_curve("a", q1, level=6, bbox=(-110, 30, -80, 45)))
        assert got == want and got["query.density"] == 1


def test_metrics_text_lists_the_new_series(flat, lake):
    """After the calls above, ``/metrics`` lists each new family in the
    port, under the JAX package's exposition names."""
    j, p = flat
    p.count("a", "INCLUDE")
    status, _, body = obs.handle("/metrics", p)
    assert status == 200
    text = body.decode() if isinstance(body, bytes) else body
    names = {ln.split(" ")[0].split("{")[0] for ln in text.splitlines()
             if ln and not ln.startswith("#")}
    jtext = jmetrics.registry().prometheus()
    jnames = {ln.split(" ")[0].split("{")[0] for ln in jtext.splitlines()
              if ln and not ln.startswith("#")}
    for fam in ("geomesa_journal_appends", "geomesa_join_queries", "geomesa_join_pairs",
                "geomesa_lake_bytes_read", "geomesa_lake_rowgroups_pruned",
                "geomesa_lake_pushdown_scans", "geomesa_pipeline_prefetch",
                "geomesa_compact_desc_shared", "geomesa_query_scan_count",
                "geomesa_query_density_count", "geomesa_journal_fsync_ms_count"):
        assert fam in names, fam
        assert fam in jnames, fam
