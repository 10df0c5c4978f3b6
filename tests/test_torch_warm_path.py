"""PyTorch port vs the JAX package: the kernel registry's accounting.

The scenarios of ``tests/test_warm_path.py`` run through both packages on
the same seeded rows (the JAX side with its Pallas kernels in interpret
mode and ``geomesa.mesh.devices`` 1; each scenario on the padded layout
and with compaction forced). After every step the two packages agree on:

* the registry's builds per site (``traces()``; the port builds a scan
  callable where the reference traces a kernel), evictions per site
  (``evicts()``) and eviction-caused builds (``evicted_recompiles()``);
* the deltas of every ``kernel.*`` counter (``kernel.recompiles`` and its
  per-site twins, ``kernel.bucket_hit``, ``kernel.evict[.<site>]``,
  ``kernel.recompiles.evicted``, ``kernel.recompile.alerts``) and the
  ``kernel.recompile.alert`` gauge;
* the ``kernel`` and ``shape_bucket`` notes of ``exec_path`` (the keys of
  ``kernel:<name>`` notes; their routes differ by package);
* the answers.

The scenarios: the bucket ladder, the LRU evicting one entry at a time,
one shape building once, a mutation that builds nothing, dictionary growth
that builds again, distinct kNN queries in one bucket sharing one entry,
partitions sharing entries across children, the aggregate cache's cell
callables surviving an epoch bump, per-site counters and the alert trip,
and an LRU small enough to evict through the public API. A registry hit
builds nothing: the builds are counted with a wrapper.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.kernels import registry as jkreg
from geomesa_tpu_torch import GeoDataset, Query, config, metrics
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import registry as kreg
from geomesa_tpu_torch.planning import executor as pexecutor

SPEC = "name:String,weight:Float,dtg:Date,*geom:Point"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-25T00:00:00Z"
N = 6000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def knobs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.MESH_DEVICES.set(1)
        try:
            yield
        finally:
            jconfig.MESH_DEVICES.set(None)


@pytest.fixture(params=["padded", "compact"])
def layout(request):
    """Each scenario on the padded layout and with compaction forced."""
    if request.param == "compact":
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
    try:
        yield request.param
    finally:
        jconfig.COMPACT_MIN_ROWS.set(None)
        jconfig.COMPACT_FRACTION.set(None)


def _data(n, seed=11, names=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    return {
        "name": list(rng.choice(np.array(list(names), object), n)),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }


def _pair(layout, n=N, partitioned=False, spill=None, seed=11):
    spec = SPEC + (";geomesa.partition='time'" if partitioned else "")
    kw = {"compact_min_rows": 1, "compact_fraction": 2.0} if layout == "compact" else {}
    out = []
    for ds, tag in ((JGeoDataset(n_shards=4), "j"),
                    (GeoDataset(n_shards=4, device="cpu", **kw), "p")):
        ds.create_schema("t", spec)
        if spill is not None:
            st = ds._store("t")
            st.max_resident = 2
            st._spill_dir = str(spill / tag)
        ds.insert("t", _data(n, seed), fids=np.arange(n).astype(str))
        ds.flush("t")
        out.append(ds)
    return out


def _q(x0, y0, x1, y1):
    return f"BBOX(geom, {x0}, {y0}, {x1}, {y1}) AND {DURING}"


def _pkg(ds):
    if isinstance(ds, GeoDataset):
        return config, metrics, kreg
    return jconfig, jmetrics, jkreg


def _kernel_counters(met):
    rep = met.registry().report()
    return {k: v for k, v in rep.items()
            if k.startswith("kernel.") and not isinstance(v, dict)}


def _state(ds):
    """The registry's accounting of ``ds``'s schema ``t``."""
    reg = ds._executor(ds._store("t")).kernel_registry() \
        if isinstance(ds, JGeoDataset) else ds._executor("t").kernel_registry()
    return {"traces": reg.traces(), "evicts": reg.evicts(),
            "evicted_recompiles": reg.evicted_recompiles(), "entries": len(reg)}


def _notes(ds):
    """The registry's exec_path notes of the last audited call."""
    ev = ds.audit.recent(1)
    path = (ev[0].hints.get("exec_path") or {}) if ev else {}
    out = {k: v for k, v in path.items() if k in ("kernel", "shape_bucket")}
    out.update({k: "<route>" for k in path if k.startswith("kernel:")})
    return out


def step(pair, fn):
    """Run ``fn(ds, config)`` on both datasets; assert equal answers,
    registry accounting, ``kernel.*`` counter deltas and notes; return the
    port's (answer, state, deltas)."""
    seen = []
    for ds in pair:
        cfg, met, _ = _pkg(ds)
        before = _kernel_counters(met)
        got = fn(ds, cfg)
        after = _kernel_counters(met)
        deltas = {k: v - before.get(k, 0) for k, v in after.items()
                  if k != "kernel.recompile.alert" and v - before.get(k, 0)}
        deltas["alert"] = after.get("kernel.recompile.alert", 0.0)
        seen.append((got, _state(ds), deltas, _notes(ds)))
    (jgot, jstate, jdeltas, jnotes), (pgot, pstate, pdeltas, pnotes) = seen
    if isinstance(pgot, np.ndarray):
        np.testing.assert_array_equal(pgot, np.asarray(jgot))
    else:
        assert pgot == jgot
    assert pstate == jstate
    assert pdeltas == jdeltas
    assert pnotes == jnotes
    return pgot, pstate, pdeltas


@pytest.fixture(autouse=True)
def fresh_alert():
    kreg.reset_alert()
    jkreg.reset_alert()
    yield
    kreg.reset_alert()
    jkreg.reset_alert()


# -- registry unit behavior ---------------------------------------------------------
@pytest.mark.parametrize("bucketing,floor", [("true", "8"), ("true", "32"), ("false", "8"),
                                             ("true", "0")])
def test_bucket_count_ladder(bucketing, floor):
    for pkg in (config, jconfig):
        pkg.COMPACT_BUCKETING.set(bucketing)
        pkg.COMPACT_BUCKET_FLOOR.set(floor)
    try:
        for k in (0, 1, 2, 5, 8, 9, 16, 17, 33, 100, 1000):
            assert kreg.bucket_count(k) == jkreg.bucket_count(k)
        if bucketing == "true" and floor == "8":
            assert [kreg.bucket_count(k) for k in (0, 1, 2, 5, 8)] == [8] * 5
            assert (kreg.bucket_count(9), kreg.bucket_count(17)) == (16, 32)
    finally:
        for pkg in (config, jconfig):
            pkg.COMPACT_BUCKETING.set(None)
            pkg.COMPACT_BUCKET_FLOOR.set(None)


def test_kernel_registry_lru_evicts_one_at_a_time():
    out = []
    for mod, met in ((kreg, metrics), (jkreg, jmetrics)):
        ev0 = _kernel_counters(met)
        reg = mod.KernelRegistry(capacity=2)
        reg.put(("site_a", 1), "k1")
        reg.put(("site_a", 2), "k2")
        assert reg.get(("site_a", 1)) == "k1"  # 1 is now MRU
        reg.put(("site_b", 3), "k3")           # evicts LRU = key 2 only
        assert len(reg) == 2
        assert reg.get(("site_a", 2)) is None
        reg.put(("site_a", 2), "k2")           # an eviction-caused build
        reg.put((("tagged", 7), 1), "k4")      # site of a tagged key
        after = _kernel_counters(met)
        out.append((reg.traces(), reg.evicts(), reg.evicted_recompiles(), len(reg),
                    {k: v - ev0.get(k, 0) for k, v in after.items()
                     if k != "kernel.recompile.alert" and v - ev0.get(k, 0)}))
    assert out[0] == out[1]
    traces, evicts, evicted, n, _ = out[0]
    assert traces == {"site_a": 3, "site_b": 1, "tagged": 1} and n == 2
    assert evicts == {"site_a": 2, "site_b": 1} and evicted == 1


def test_persistent_compile_cache_knob(tmp_path):
    """The knob reads alike; the port has no compile cache behind it."""
    assert kreg.enable_persistent_cache() is None
    with config.COMPILE_CACHE_DIR.scoped(str(tmp_path)):
        assert kreg.enable_persistent_cache() == str(tmp_path)


# -- builds through the public API ----------------------------------------------------
def test_same_shape_query_compiles_once(layout):
    pair = _pair(layout)
    q = _q(-100, 30, -80, 45)
    c1, s1, d1 = step(pair, lambda ds, cfg: ds.count("t", q))
    assert d1.get("kernel.recompiles", 0) >= 1
    c2, s2, d2 = step(pair, lambda ds, cfg: ds.count("t", q))
    assert c2 == c1 > 0 and s2 == s1
    assert "kernel.recompiles" not in d2 and d2["kernel.bucket_hit"] >= 1


def test_registry_hit_builds_nothing(layout, monkeypatch):
    """A hit reuses the entry's callable: no ``_ScanFn`` is built, and the
    entry object is the one the miss put."""
    (p,) = _pair(layout)[1:]
    built = []
    orig = pexecutor._ScanFn.__init__

    def counting(self, *a, **k):
        built.append(1)
        orig(self, *a, **k)

    monkeypatch.setattr(pexecutor._ScanFn, "__init__", counting)
    q = _q(-100, 30, -80, 45)
    bbox = (-100.0, 30.0, -80.0, 45.0)
    p.count("t", q)
    p.density("t", q, bbox=bbox, width=32, height=32)
    reg = p._executor("t").kernel_registry()
    n_built, entries = len(built), dict(reg._entries)
    assert n_built == len(entries) >= 2
    for _ in range(3):
        p.count("t", q)
        p.density("t", q, bbox=bbox, width=32, height=32)
    assert len(built) == n_built
    assert all(reg._entries[k] is v for k, v in entries.items())


def test_mutation_does_not_recompile(layout):
    pair = _pair(layout)
    q = _q(-100, 30, -80, 45)
    step(pair, lambda ds, cfg: ds.count("t", q))

    def insert(ds, cfg):
        ds.insert("t", _data(1500, seed=12), fids=(np.arange(1500) + 1_000_000).astype(str))
        ds.flush("t")

    step(pair, insert)
    c, _, d = step(pair, lambda ds, cfg: ds.count("t", q))
    assert c > 0 and "kernel.recompiles" not in d


def test_dictionary_growth_does_recompile_string_predicates(layout):
    pair = _pair(layout)
    q = f"name IN ('a', 'zed') AND {DURING}"
    c1, _, _ = step(pair, lambda ds, cfg: ds.count("t", q))

    def grow(ds, cfg):
        ds.insert("t", _data(1000, seed=13, names=("zed",)),
                  fids=(np.arange(1000) + 2_000_000).astype(str))
        ds.flush("t")

    step(pair, grow)
    c2, _, d = step(pair, lambda ds, cfg: ds.count("t", q))
    assert c2 > c1 and d.get("kernel.recompiles", 0) >= 1


def test_distinct_same_bucket_queries_share_one_kernel(layout):
    """kNN passes its origin and boxes as call operands under one token;
    bucketing folds the differing window counts into one shape."""
    origins = [(-100.0, 35.0), (-92.5, 40.0), (-85.0, 30.5)]
    with config.COMPACT_BUCKET_FLOOR.scoped("32"), jconfig.COMPACT_BUCKET_FLOOR.scoped("32"):
        pair = _pair(layout)

        def knn(x, y):
            return lambda ds, cfg: sorted(ds.knn("t", x, y, k=5).fids)

        step(pair, knn(*origins[0]))
        for x, y in origins[1:]:
            _, _, d = step(pair, knn(x, y))
            assert "kernel.recompiles" not in d
    # without bucketing the same sequence builds per window-count shape
    with config.COMPACT_BUCKETING.scoped("false"), jconfig.COMPACT_BUCKETING.scoped("false"):
        pair = _pair(layout)
        step(pair, knn(*origins[0]))
        builds = 0
        for x, y in origins[1:]:
            _, _, d = step(pair, knn(x, y))
            builds += d.get("kernel.recompiles", 0)
        assert builds > 0


def test_warm_path_repeats_and_mutation_build_nothing(layout):
    """Three distinct same-bucket queries: one build per (site, query);
    repeats, and repeats after a mutation, build nothing."""
    queries = [_q(-100, 30, -80, 45), _q(-103, 31, -82, 44), _q(-97, 29, -78, 46)]
    bbox = (-100.0, 30.0, -80.0, 45.0)
    with config.COMPACT_BUCKET_FLOOR.scoped("64"), jconfig.COMPACT_BUCKET_FLOOR.scoped("64"):
        pair = _pair(layout, partitioned=True)

        def run(ds, cfg):
            return ([ds.count("t", q) for q in queries],
                    [np.asarray(ds.density("t", q, bbox=bbox, width=32, height=32)).tolist()
                     for q in queries])

        first, s1, _ = step(pair, run)
        again, s2, d2 = step(pair, run)
        assert again == first and s2 == s1 and "kernel.recompiles" not in d2

        def insert(ds, cfg):
            ds.insert("t", _data(2000, seed=21), fids=(np.arange(2000) + 500_000).astype(str))
            ds.flush("t")

        step(pair, insert)
        _, _, d3 = step(pair, run)
        assert "kernel.recompiles" not in d3


def test_pipeline_partitions_share_kernels_across_children(layout, tmp_path):
    with config.COMPACT_BUCKET_FLOOR.scoped("64"), jconfig.COMPACT_BUCKET_FLOOR.scoped("64"):
        pair = _pair(layout, partitioned=True, spill=tmp_path)
        q = _q(-100, 30, -80, 45)
        c, state, _ = step(pair, lambda ds, cfg: ds.count("t", q))
    assert c > 0
    # every child ran the count through one callable
    assert sum(state["traces"].values()) == 1


def test_cache_cell_kernels_survive_epoch_bump(layout):
    from geomesa_tpu.cache import AggregateCache as JAggregateCache
    from geomesa_tpu_torch.cache import AggregateCache

    pair = _pair(layout)
    pair[0].cache, pair[1].cache = JAggregateCache(), AggregateCache()
    q = "BBOX(geom, -112.5, 22.5, -67.5, 45.0) AND name = 'a'"

    def count(ds, cfg):
        with cfg.CACHE_ENABLED.scoped("true"), cfg.CACHE_CELLS_PER_AXIS.scoped("2"):
            return ds.count("t", q)

    c1, _, d1 = step(pair, count)
    assert d1.get("kernel.recompiles", 0) >= 1

    def insert(ds, cfg):
        ds.insert("t", _data(1000, seed=31), fids=(np.arange(1000) + 700_000).astype(str))
        ds.flush("t")

    step(pair, insert)
    c2, _, d2 = step(pair, count)
    assert c2 >= c1
    if layout == "padded":
        # compacted keys carry the chunk count, which the insert grew: both
        # packages build those cells again
        assert "kernel.recompiles" not in d2


def test_per_site_recompile_counters_and_alert_trip(layout):
    pair = _pair(layout, n=3000)
    q = _q(-100, 30, -80, 45)

    def count0(ds, cfg):
        with cfg.KERNEL_ALERT_THRESHOLD.scoped("0"):
            return ds.count("t", q)

    _, _, d = step(pair, count0)
    assert d["alert"] >= 1 and d["kernel.recompile.alerts"] >= 1
    sites = [k.split(".", 2)[2] for k in d
             if k.startswith("kernel.recompiles.") and k != "kernel.recompiles.evicted"]
    assert sites
    site = sites[0]
    assert kreg.query_recompiles().get(site, 0) >= 1
    text = metrics.registry().prometheus()
    assert f"geomesa_kernel_recompiles_{site} " in text
    assert "geomesa_kernel_recompile_alert " in text
    # a warm repeat builds nothing and the latch holds
    _, _, d = step(pair, count0)
    assert "kernel.recompiles" not in d and d["alert"] >= 1
    kreg.reset_alert()
    jkreg.reset_alert()
    assert metrics.registry().gauge(metrics.KERNEL_RECOMPILE_ALERT).value == 0


def test_small_registry_evicts_through_the_api(layout):
    """``geomesa.kernel.cache.size`` 2 over four distinct queries: the LRU
    evicts one entry at a time and counts the rebuilds of evicted keys."""
    pair = _pair(layout, n=3000)
    queries = [_q(-100, 30, -80, 45), _q(-110, 28, -90, 40), _q(-95, 35, -75, 48),
               _q(-105, 26, -85, 44)]

    def run(ds, cfg):
        with cfg.KERNEL_CACHE_SIZE.scoped("2"):
            return [ds.count("t", q) for q in queries]

    step(pair, run)
    _, state, d = step(pair, run)
    assert state["entries"] == 2 and sum(state["evicts"].values()) >= 2
    assert state["evicted_recompiles"] >= 1 and d["kernel.recompiles.evicted"] >= 1


def test_explain_warm_path_lines_equal(layout):
    pair = _pair(layout, n=3000)
    q = _q(-100, 30, -80, 45)
    for ds in pair:
        ds.count("t", q)
    texts = []
    for ds in pair:
        out = ds.explain("t", q)
        lines = out.splitlines()
        i = j = lines.index("Warm path") + 1
        while j < len(lines) and lines[j].startswith("  "):
            j += 1
        texts.append(lines[i:j])
    assert texts[0] == texts[1]
    assert any(ln.strip().startswith("kernel registry: ") for ln in texts[1])
    assert any(ln.strip().startswith("recompile alert: clear") for ln in texts[1])


# -- a registry entry holds no data of the call that built it ---------------------------
def _closure_data(fn):
    """Type names of the tensors and arrays reachable from ``fn``'s closure
    cells (through nested functions, tuples, lists and dicts): a cached
    callable that holds one would serve a later call that shares its key
    with the first call's data."""
    found, stack, seen = [], [fn], set()
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, (torch.Tensor, np.ndarray)):
            found.append(type(o).__name__)
        elif isinstance(o, pexecutor._ScanFn):
            stack.append(o.agg)
        elif isinstance(o, pexecutor._BatchFn):
            stack.append(o.member_agg)
        elif isinstance(o, (tuple, list)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif callable(o) and getattr(o, "__closure__", None):
            stack.extend(c.cell_contents for c in o.__closure__)
    return found


BOXES_A = ["POLYGON((-100 30, -90 30, -90 35, -100 35, -100 30))",
           "POLYGON((-90 30, -80 30, -80 35, -90 35, -90 30))"]
#: BOXES_A moved north by its height: the same x1 and poly_id, so the
#: same ("pip_join", sig) registry key, and different edges
BOXES_B = ["POLYGON((-100 35, -90 35, -90 40, -100 40, -100 35))",
           "POLYGON((-90 35, -80 35, -80 40, -90 40, -90 35))"]


def test_spatial_join_key_sharing_polygon_sets_use_their_own_edges():
    """Two polygon sets that differ only in y share the reference's
    ``("pip_join", sig)`` key (its sig hashes x1 and poly_id). The second
    join hits the first's entry and still assigns against its own edges:
    it equals the same join on a fresh dataset of each package."""
    (p,) = _pair("padded")[1:]
    q = _q(-110, 26, -75, 48)
    reg = p._executor("t").kernel_registry()
    a_assign, a_counts = p.spatial_join("t", BOXES_A, q)
    traces = reg.traces()
    b_assign, b_counts = p.spatial_join("t", BOXES_B, q)
    assert reg.traces() == traces  # the second join hit the first's entry
    fresh_j, fresh_p = _pair("padded")
    for fresh in (fresh_p, fresh_j):
        fb_assign, fb_counts = fresh.spatial_join("t", BOXES_B, q)
        np.testing.assert_array_equal(b_assign, np.asarray(fb_assign))
        np.testing.assert_array_equal(b_counts, np.asarray(fb_counts))
    assert b_counts.sum() > 0 and not np.array_equal(a_assign, b_assign)


def test_registry_entries_hold_no_call_data(layout):
    """After counts, densities, a sorted top-k, kNN, a curve, a query-axis
    batch and two spatial joins, no registry entry (the store's or the
    joins') reaches a tensor or an array through its closures: every data
    operand is passed per call."""
    (p,) = _pair(layout)[1:]
    q = _q(-100, 30, -80, 45)
    bbox = (-100.0, 30.0, -80.0, 45.0)
    p.count("t", q)
    p.density("t", q, bbox=bbox, width=32, height=32)
    p.density("t", q, bbox=bbox, width=32, height=32, weight="weight")
    p.query("t", Query(q, sort_by=[("weight", False)], max_features=5))
    p.knn("t", -90.0, 37.0, 5, q)
    p.density_curve("t", q, level=6)
    p.count_batch("t", [q, _q(-110, 28, -90, 40)])
    p.spatial_join("t", BOXES_A, _q(-110, 26, -75, 48))
    p.spatial_join("t", BOXES_B, _q(-110, 26, -75, 48))
    entries = dict(p._executor("t").kernel_registry()._entries)
    assert len(entries) >= 5
    from geomesa_tpu_torch.planning import join_exec
    entries.update(join_exec.join_registry()._entries)
    held = {str(k[0]): _closure_data(v) for k, v in entries.items() if _closure_data(v)}
    assert held == {}
