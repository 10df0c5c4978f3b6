"""The port's configuration knobs against the JAX package's: each knob's
name and default, its resolution order (thread-local override, then the
environment, then the default), ``scoped()`` nesting, and that the module
reading it reads it at call time."""

import threading

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch import config
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: port knob -> the JAX package's SystemProperty of the same rule
KNOBS = {
    "SCAN_RANGES_TARGET": "SCAN_RANGES_TARGET",
    "LOOSE_BBOX": "LOOSE_BBOX",
    "SPILL_DIR": "SPILL_DIR",
    "MAX_RESIDENT_PARTITIONS": "MAX_RESIDENT_PARTITIONS",
    "SHARD_LEN_BUCKET": "SHARD_LEN_BUCKET",
    "COMPACT_COVER": "COMPACT_COVER",
    "PIPELINE_PREFETCH": "PIPELINE_PREFETCH",
    "DENSITY_PALLAS_MAX_DUP": "DENSITY_PALLAS_MAX_DUP",
    "TOPK_MAX": "TOPK_MAX",
    "JOIN_TILE": "JOIN_TILE",
    "JOIN_MAX_LEVEL": "JOIN_MAX_LEVEL",
    "JOIN_BATCH_ROWS": "JOIN_BATCH_ROWS",
    "JOIN_ADAPTIVE": "JOIN_ADAPTIVE",
    "JOIN_ADAPTIVE_BRUTE_PAIRS": "JOIN_ADAPTIVE_BRUTE_PAIRS",
    "JOIN_ADAPTIVE_SKEW_RATIO": "JOIN_ADAPTIVE_SKEW_RATIO",
    "LAKE_ENABLED": "LAKE_ENABLED",
    "LAKE_ROWGROUP_ROWS": "LAKE_ROWGROUP_ROWS",
    "LAKE_PUSHDOWN": "LAKE_PUSHDOWN",
    "LAKE_PRUNE_MARGIN": "LAKE_PRUNE_MARGIN",
    "JOIN_PUSHDOWN": "JOIN_PUSHDOWN",
    "JOIN_PUSHDOWN_CELLS": "JOIN_PUSHDOWN_CELLS",
    "JOIN_PUSHDOWN_RESIDENCY_MB": "JOIN_PUSHDOWN_RESIDENCY_MB",
    "JOURNAL_ENABLED": "JOURNAL_ENABLED",
    "JOURNAL_GROUP_MS": "JOURNAL_GROUP_MS",
    "JOURNAL_SEGMENT_BYTES": "JOURNAL_SEGMENT_BYTES",
    "FAULT_INJECTION": "FAULT_INJECTION",
    "QUERY_TIMEOUT": "QUERY_TIMEOUT",
    "SCAN_PARTIAL": "SCAN_PARTIAL",
    "RETRY_ATTEMPTS": "RETRY_ATTEMPTS",
    "RETRY_BASE_MS": "RETRY_BASE_MS",
    "RETRY_MAX_MS": "RETRY_MAX_MS",
    "RETRY_JITTER": "RETRY_JITTER",
    "CACHE_ENABLED": "CACHE_ENABLED",
    "CACHE_BUDGET_BYTES": "CACHE_BUDGET_BYTES",
    "CACHE_CELLS_PER_AXIS": "CACHE_CELLS_PER_AXIS",
    "CACHE_MAX_LEVEL": "CACHE_MAX_LEVEL",
    "CACHE_MAX_CELLS": "CACHE_MAX_CELLS",
    "CACHE_HIERARCHY": "CACHE_HIERARCHY",
    "CACHE_HIERARCHY_DEPTH": "CACHE_HIERARCHY_DEPTH",
    "CACHE_POLYGON": "CACHE_POLYGON",
    "HEAT_CELLS_MAX": "HEAT_CELLS_MAX",
    "HEAT_TOP": "HEAT_TOP",
    "BLOCK_FULL_TABLE_SCANS": "BLOCK_FULL_TABLE_SCANS",
    "TEMPORAL_GUARD_MAX_DAYS": "TEMPORAL_GUARD_MAX_DAYS",
    "AUDIT_PATH": "AUDIT_PATH",
    "AUDIT_ENABLED": "AUDIT_ENABLED",
    "TRACE_ENABLED": "TRACE_ENABLED",
    "TRACE_SLOW_MS": "TRACE_SLOW_MS",
    "TRACE_MAX_SPANS": "TRACE_MAX_SPANS",
    "TRACE_JAX_PROFILER": "TRACE_JAX_PROFILER",
    "TRACE_RETAIN": "TRACE_RETAIN",
    "USER": "USER",
    "COMPACT_BUCKETING": "COMPACT_BUCKETING",
    "COMPACT_BUCKET_FLOOR": "COMPACT_BUCKET_FLOOR",
    "KERNEL_CACHE_SIZE": "KERNEL_CACHE_SIZE",
    "KERNEL_ALERT_THRESHOLD": "KERNEL_ALERT_THRESHOLD",
    "COMPILE_CACHE_DIR": "COMPILE_CACHE_DIR",
    "BREAKER_THRESHOLD": "BREAKER_THRESHOLD",
    "BREAKER_RESET_MS": "BREAKER_RESET_MS",
    "MESH_CORDON": "MESH_CORDON",
    "DEVICE_BREAKER_THRESHOLD": "DEVICE_BREAKER_THRESHOLD",
    "DEVICE_BREAKER_RESET_MS": "DEVICE_BREAKER_RESET_MS",
    "TRACE_OTLP_ENDPOINT": "TRACE_OTLP_ENDPOINT",
    "TRACE_EXPORT_PATH": "TRACE_EXPORT_PATH",
    "TRACE_SAMPLE_RATE": "TRACE_SAMPLE_RATE",
    "TRACE_SAMPLE_SEED": "TRACE_SAMPLE_SEED",
    "TRACE_EXPORT_QUEUE": "TRACE_EXPORT_QUEUE",
    "TRACE_EXPORT_BATCH": "TRACE_EXPORT_BATCH",
    "DEVICE_BUSY_WINDOW": "DEVICE_BUSY_WINDOW",
    "SLO_WINDOW_FAST_S": "SLO_WINDOW_FAST_S",
    "SLO_WINDOW_SLOW_S": "SLO_WINDOW_SLOW_S",
    "SLO_BURN_THRESHOLD": "SLO_BURN_THRESHOLD",
    "TOPK_TIE_SLACK": "TOPK_TIE_SLACK",
    "SAMPLE_HASH_BUCKETS": "SAMPLE_HASH_BUCKETS",
    "DEFAULT_SHARDS": "DEFAULT_SHARDS",
    "STRATEGY_DECIDER": "STRATEGY_DECIDER",
    "COMPACT_ENABLED": "COMPACT_ENABLED",
    "COMPACT_MIN_ROWS": "COMPACT_MIN_ROWS",
    "COMPACT_FRACTION": "COMPACT_FRACTION",
    "COMPACT_B": "COMPACT_B",
    "COMPACT_SHARD_BUCKET": "COMPACT_SHARD_BUCKET",
    "DENSITY_PALLAS": "DENSITY_PALLAS",
    "DENSITY_MXU": "DENSITY_MXU",
    "MXU_TILE_X": "MXU_TILE_X",
    "MXU_TILE_Y": "MXU_TILE_Y",
    # slice 17: the serving scheduler and standing queries
    "SERVING_QUEUE_DEPTH": "SERVING_QUEUE_DEPTH",
    "SERVING_FUSION": "SERVING_FUSION",
    "SERVING_FUSION_MAX": "SERVING_FUSION_MAX",
    "SERVING_FUSION_DISTINCT": "SERVING_FUSION_DISTINCT",
    "SERVING_PLACEMENT": "SERVING_PLACEMENT",
    "SERVING_PLACEMENT_GRACE_MS": "SERVING_PLACEMENT_GRACE_MS",
    "SERVING_FAIR_SHARE": "SERVING_FAIR_SHARE",
    "SERVING_SHED_ESTIMATE": "SERVING_SHED_ESTIMATE",
    "SERVING_EXECUTORS": "SERVING_EXECUTORS",
    "SUBSCRIBE_ENABLED": "SUBSCRIBE_ENABLED",
    "SUBSCRIBE_VERIFY": "SUBSCRIBE_VERIFY",
    "SUBSCRIBE_MAX_GROUPS": "SUBSCRIBE_MAX_GROUPS",
    "SUBSCRIBE_UPDATES_RING": "SUBSCRIBE_UPDATES_RING",
    "SUBSCRIBE_PYRAMID_LEVELS": "SUBSCRIBE_PYRAMID_LEVELS",
    "FLEET_ROUTING_LEVEL": "FLEET_ROUTING_LEVEL",
}


def test_registry_is_the_knobs():
    assert sorted(p.name for p in config.registry().values()) == sorted(
        getattr(config, k).name for k in KNOBS)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_name_and_default_equal_the_reference(knob):
    p, j = getattr(config, knob), getattr(jconfig, KNOBS[knob])
    assert p.name == j.name
    assert p.default == j.default
    assert p.env_name == j.env_name


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_override_then_env_then_default(knob, monkeypatch):
    p = getattr(config, knob)
    monkeypatch.delenv(p.env_name, raising=False)
    assert p.get() == p.default
    monkeypatch.setenv(p.env_name, "17")
    assert p.get() == "17" and p.to_int() == 17
    with p.scoped("23"):
        assert p.get() == "23"
        with p.scoped(5):  # scopes nest
            assert p.to_int() == 5
        assert p.get() == "23"
        seen = []
        t = threading.Thread(target=lambda: seen.append(p.get()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == ["17"]  # overrides are per thread
    assert p.get() == "17"
    p.set(9)
    try:
        assert p.to_float() == 9.0
    finally:
        p.set(None)
    monkeypatch.delenv(p.env_name)
    assert p.get() == p.default


def test_typed_accessors():
    p = config.LOOSE_BBOX
    for v, want in (("true", True), ("1", True), ("On", True), ("false", False), ("0", False)):
        with p.scoped(v):
            assert p.to_bool() is want
    assert config.SPILL_DIR.to_int() is None


def test_slo_targets_equal_the_reference(monkeypatch):
    """``geomesa.slo.<op>.p99.ms`` overrides over ``GEOMESA_SLO_<OP>_P99_MS``
    env targets, unparseable values ignored, in both packages."""
    monkeypatch.setenv("GEOMESA_SLO_COUNT_P99_MS", "50")
    monkeypatch.setenv("GEOMESA_SLO_QUERY_P99_MS", "x")
    got = []
    for cfg in (config, jconfig):
        prop = cfg.SystemProperty("geomesa.slo.density.p99.ms")
        with prop.scoped("12.5"):
            got.append(cfg.slo_targets())
        cfg._REGISTRY.pop(prop.name)
    assert got[0] == got[1] == {"count": 50.0, "density": 12.5}


def test_snapshot_and_adopt_overrides():
    with config.TOPK_MAX.scoped(3):
        snap = config.snapshot_overrides()
    seen = []

    def worker():
        config.adopt_overrides(snap)
        seen.append(config.TOPK_MAX.to_int())

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [3]
    assert config.TOPK_MAX.to_int() == 100000


# -- each module reads its knob when it runs ------------------------------------------
PSPEC = "name:String,weight:Float,dtg:Date,*geom:Point;geomesa.partition='time'"
SPEC = "name:String,weight:Float,dtg:Date,*geom:Point"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-25T00:00:00Z"
BOX = "BBOX(geom, -100, 30, -80, 45)"


def _data(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    return {"name": list(rng.choice(np.array(["a", "b", "c"], object), n)),
            "weight": rng.uniform(0, 1, n).astype(np.float32),
            "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
            "geom__x": rng.uniform(-120, -70, n), "geom__y": rng.uniform(25, 50, n)}


def _ds(spec=SPEC, n=4000):
    ds = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    ds.create_schema("t", spec)
    ds.insert("t", _data(n))
    ds.flush("t")
    return ds


def test_partition_knobs_read_when_the_store_is_made(tmp_path):
    with config.SPILL_DIR.scoped(str(tmp_path)), config.MAX_RESIDENT_PARTITIONS.scoped(2), \
            config.SHARD_LEN_BUCKET.scoped(4096):
        ds = _ds(PSPEC)
    st = ds._store("t")
    assert st.max_resident == 2 and len(st.partitions) <= 2
    assert st.spill_dir == str(tmp_path) and st.spilled
    assert all(t.shard_len_multiple == 4096 for c in st.partitions.values()
               for t in c.tables.values())
    assert all(c.tables["z3"].shard_len % 4096 == 0 for c in st.partitions.values())
    default = _ds(PSPEC)._store("t")
    assert default.max_resident == 4 and default._shard_bucket == 65536


def test_prefetch_read_at_each_call(tmp_path):
    with config.SPILL_DIR.scoped(str(tmp_path)), config.MAX_RESIDENT_PARTITIONS.scoped(1):
        ds = _ds(PSPEC)
    ex = ds._executor("t")
    assert ex.prefetch is True
    with config.PIPELINE_PREFETCH.scoped(False):
        assert ex.prefetch is False
        off = ds.count("t", DURING)
    assert ds.count("t", DURING) == off
    ex.prefetch = True  # an explicit setting wins over the knob
    with config.PIPELINE_PREFETCH.scoped(False):
        assert ex.prefetch is True
    ex.prefetch = None
    assert ex.prefetch is True


def test_ranges_target_read_at_plan_time():
    ds = _ds()
    st = ds._store("t")
    z2 = st.tables["z2"].keyspace
    f = parse_ecql(BOX)
    assert len(z2.plan(st.ft, f).ranges) > 8
    with config.SCAN_RANGES_TARGET.scoped(8):
        assert len(z2.plan(st.ft, f).ranges) <= 8
        small = ds.count("t", BOX)
    assert ds.count("t", BOX) == small


def test_compact_cover_read_at_scan_time():
    ds = _ds()
    ex = ds._executor("t")
    q = f"{BOX} AND {DURING}"
    with config.COMPACT_COVER.scoped(1000):  # not finer than the planner's cover
        plan = ds._plan("t", q)
        setup = ex._scan_setup(plan)
        assert ex._fine_windows(plan, setup) == (None, None)
        n_coarse = ds.count("t", q)
    plan = ds._plan("t", q)
    plan.__dict__.pop("_exec_cache", None)
    setup = ex._scan_setup(plan)
    fs, fe = ex._fine_windows(plan, setup)
    assert fs is not None and fs.shape[1] >= setup["starts"].shape[1]
    assert ds.count("t", q) == n_coarse


def test_max_dup_read_at_density_time():
    ds = _ds(n=40_000)
    q = f"{BOX} AND {DURING}"
    bbox = (-100.0, 30.0, -80.0, 45.0)
    grouped = ds.density("t", q, bbox=bbox, width=64, height=64)
    assert ds._plan("t", q).exec_path["density_kernel"] == "grouped"
    with config.DENSITY_PALLAS_MAX_DUP.scoped(0.0):
        # the grouped rung declines: the einsum pairs take it, as in the
        # reference
        einsum = ds.density("t", q, bbox=bbox, width=64, height=64)
        assert ds._plan("t", q).exec_path["density_kernel"] == "mxu-einsum"
    assert np.array_equal(grouped, einsum)


def test_topk_max_read_at_query_time():
    ds = _ds()
    q = Query(BOX, sort_by=[("weight", True)], max_features=10)
    top = ds.query("t", q).fids
    assert ds._plan("t", q).exec_path["sort"] == "device-topk(k=10)"
    with config.TOPK_MAX.scoped(0):
        assert ds.query("t", q).fids == top
        assert "sort" not in ds._plan("t", q).exec_path


def test_loose_bbox_read_at_compile_time():
    from geomesa_tpu_torch.schema.feature_type import FeatureType

    ft = FeatureType.from_spec("t", "dtg:Date,*geom:Polygon")
    f = parse_ecql("BBOX(geom, 0, 0, 1, 1)")
    assert compile_filter(f, ft).refine is not None
    with config.LOOSE_BBOX.scoped(True):
        assert compile_filter(f, ft).refine is None
    assert compile_filter(f, ft).refine is not None


def test_join_knobs_read_at_join_time():
    from geomesa_tpu_torch.planning import join_exec as je

    rng = np.random.default_rng(3)
    ax, ay = rng.normal(0, 0.5, 600), rng.normal(0, 0.5, 600)
    bx, by = rng.normal(0, 0.5, 100), rng.normal(0, 0.5, 100)
    run = lambda: je.run_join(ax, ay, bx, by, "dwithin", distance=0.05,  # noqa: E731
                              device="cpu", level=4)
    pairs, total, st = run()
    assert st.adaptive and total > 0
    with config.JOIN_TILE.scoped("16"):
        p16, t16, st16 = run()
    assert np.array_equal(p16, pairs) and st16.tiles > st.tiles
    with config.JOIN_ADAPTIVE.scoped("false"):
        assert not run()[2].adaptive
    with config.JOIN_ADAPTIVE_SKEW_RATIO.scoped("2"), config.JOIN_TILE.scoped("8"):
        assert "split.l" in run()[2].strategy_cells
    with config.JOIN_ADAPTIVE_BRUTE_PAIRS.scoped(str(10 ** 9)):
        assert list(run()[2].strategy_cells) == ["brute"]
    with config.JOIN_MAX_LEVEL.scoped("2"):
        assert je.run_join(ax, ay, bx, by, "dwithin", distance=0.05, device="cpu")[2].level == 2
    ds = GeoDataset(n_shards=2, device="cpu")
    for name in ("a", "b"):
        ds.create_schema(name, "*geom:Point")
    ds.insert("a", {"geom": list(zip(ax, ay))})
    ds.insert("b", {"geom": list(zip(bx, by))})
    res = ds.join_spatial("a", "b", predicate="dwithin", distance=0.05)
    with config.JOIN_BATCH_ROWS.scoped("7"):
        assert max(b.n for b in res.batches()) == 7
    assert max(b.n for b in res.batches()) == res.count


def test_lake_knobs_read_at_spill_and_scan_time(tmp_path):
    import os

    from geomesa_tpu_torch.lake.snapshot import SNAPSHOT_FILE, PartitionSnapshot

    with config.SPILL_DIR.scoped(str(tmp_path)), config.MAX_RESIDENT_PARTITIONS.scoped(1):
        ds = _ds(PSPEC)
    st = ds._store("t")
    b = next(iter(st.partitions))
    with config.LAKE_ENABLED.scoped(False):
        st.spill_all()
    assert os.path.exists(os.path.join(st.spilled[b], "data.npz"))
    st.child(b)._all.n  # reload; dirty it so the next spill rewrites it
    st._dirty.add(b)
    with config.LAKE_ROWGROUP_ROWS.scoped(256):
        st.spill_all()
    snap = PartitionSnapshot(st.spilled[b])
    assert os.path.exists(os.path.join(st.spilled[b], SNAPSHOT_FILE))
    assert len(snap.groups) == -(-snap.n // 256)
    for bb in list(st.spilled):
        st.child(bb)
        st._dirty.add(bb)
    with config.LAKE_ROWGROUP_ROWS.scoped(256):
        st.spill_all()
    q = "BBOX(geom, -100, 30, -99, 31)"
    n = ds.count("t", q)
    assert "lake" in ds._plan("t", q).exec_path
    with config.LAKE_PUSHDOWN.scoped(False):
        st.spill_all()
        assert ds.count("t", q) == n and "lake" not in ds._plan("t", q).exec_path
    box = [(-100.0, 30.0, -99.0, 31.0)]
    with config.LAKE_PRUNE_MARGIN.scoped(100.0):
        assert snap.prune(box, None) == list(range(len(snap.groups)))
    assert len(snap.prune(box, None)) < len(snap.groups)


def test_join_pushdown_knobs_read_at_join_time(tmp_path):
    with config.SPILL_DIR.scoped(str(tmp_path)), config.MAX_RESIDENT_PARTITIONS.scoped(1), \
            config.LAKE_ROWGROUP_ROWS.scoped(256):
        ds = _ds(PSPEC)
        ds._store("t").spill_all()
    rng = np.random.default_rng(9)
    ds.create_schema("l", "*geom:Point")
    ds.insert("l", {"geom__x": rng.uniform(-110, -80, 40), "geom__y": rng.uniform(30, 45, 40)})

    def run():
        return ds._join_run("l", "t", "dwithin", 0.3, None, None, "INCLUDE", "INCLUDE",
                            None, want_pairs=False)

    res = run()
    assert res.stats.pushdown["chunks"] == 1
    with config.JOIN_PUSHDOWN_CELLS.scoped(8):
        few = run()
        assert few.count == res.count and few.stats.pushdown["chunks"] > 1
        assert few.stats.pushdown["residency_hits"] > 0
        with config.JOIN_PUSHDOWN_RESIDENCY_MB.scoped(0):
            assert run().stats.pushdown["residency_hits"] == 0
    with config.JOIN_PUSHDOWN.scoped(False):
        off = run()
    assert off.count == res.count and off.stats.pushdown == {}


def test_trace_knobs_read_at_call_time():
    from geomesa_tpu_torch import tracing

    assert tracing.span("x") is tracing.NOOP
    with config.TRACE_ENABLED.scoped("true"), config.TRACE_MAX_SPANS.scoped("2"):
        with tracing.start("op") as root:
            for _ in range(3):
                with tracing.span("s"):
                    pass
    assert root.trace.max_spans == 2 and root.trace.dropped == 2
