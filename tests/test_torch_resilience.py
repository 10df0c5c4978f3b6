"""PyTorch port vs the JAX package: retry policies, deadlines, fault
injection and the spill edges (the port's ``resilience.py`` and
``index/partitioned.py``).

The policy units hold the port to the JAX package draw for draw: a seed
gives the same backoff schedule, the same retries with the same injected
sleeps, and a seeded injector with ``p < 1`` fires on the same hits. The
deadline tests set ``geomesa.query.timeout`` to ``0ms`` and expect
``QueryTimeoutError`` at the same entry points of both packages, on a
partitioned store and on a flat multi-shard store, also under
``allow_partial()``. The spill tests mirror ``tests/test_chaos.py``'s
single-device part on both packages: transient ``OSError``s at
``index.spill.load`` and ``index.spill.store`` are retried and lose
nothing, and a corrupt snapshot (an injected failure, or a byte flipped
in its lake file) quarantines its bin until it is cleared. Answers are
exact integers (counts), so no tolerance applies.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import resilience as jres
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch import config, metrics, resilience
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.lake.snapshot import SNAPSHOT_FILE, PartitionSnapshot
from geomesa_tpu_torch.resilience import (
    Deadline, InjectedFault, QueryTimeoutError, RetryPolicy, allow_partial, check_deadline,
    deadline_scope, fault_point, inject_faults,
)

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 6000
ECQL = "BBOX(geom, -110, 28, -75, 48)"
SMALL = "BBOX(geom, -100, 30, -99, 31)"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"


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


def _both(*props):
    """Scope ``(name, value)`` knob settings on both packages."""
    stack = contextlib.ExitStack()
    for name, v in props:
        stack.enter_context(getattr(config, name).scoped(v))
        stack.enter_context(getattr(jconfig, name).scoped(v))
    return stack


# -- retry policies -------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [None, 0, 3, 123, 2 ** 31 - 1])
@pytest.mark.parametrize("attempts, base, cap, jitter", [
    (1, 50, 5000, 0.2), (3, 50, 5000, 0.2), (5, 10, 60, 0.5), (8, 1, 40, 0.0), (6, 7.5, 90, 0.9),
])
def test_delays_equal_the_reference(seed, attempts, base, cap, jitter):
    kw = dict(attempts=attempts, base_ms=base, max_ms=cap, jitter=jitter, seed=seed)
    if seed is None:
        # unseeded jitter draws from fresh entropy: only the shape is fixed
        got = RetryPolicy(**kw).delays_ms()
        assert len(got) == max(attempts - 1, 0)
        for i, d in enumerate(got):
            hi = min(base * 2 ** i, cap)
            assert hi * (1 - jitter) <= d <= hi
        return
    p, j = RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert p.delays_ms() == j.delays_ms()
    assert p.delays_ms() == j.delays_ms()  # the next schedule too


def _flaky(fail_first, exc=OSError):
    calls = []

    def fn():
        calls.append(1)
        if fail_first is None or len(calls) <= fail_first:
            raise exc("transient")
        return len(calls)

    return fn, calls


@pytest.mark.parametrize("case", ["succeeds_third", "exhausted", "fatal", "deadline", "zero"])
def test_call_with_injected_sleeps_equals_the_reference(case):
    out = []
    for mod in (resilience, jres):
        slept = []
        pol = mod.RetryPolicy(attempts=0 if case == "zero" else 4, base_ms=5, max_ms=12,
                              jitter=0.5, seed=9, sleep=slept.append)
        fn, calls = _flaky({"succeeds_third": 2}.get(case),
                           ValueError if case == "fatal" else OSError)
        kw = {}
        if case == "fatal":
            kw["retryable"] = lambda e: isinstance(e, OSError)
        got = None
        try:
            if case == "deadline":
                with mod.deadline_scope(0.0) as d:
                    got = pol.call(fn, deadline=d, **kw)
            else:
                got = pol.call(fn, **kw)
        except Exception as e:
            got = type(e).__name__
        out.append((got, len(calls), slept))
    assert out[0] == out[1]
    got, n, slept = out[0]
    want = {"succeeds_third": (3, 3, 2), "exhausted": ("OSError", 4, 3),
            "fatal": ("ValueError", 1, 0), "deadline": ("OSError", 1, 0),
            "zero": ("OSError", 1, 0)}[case]
    assert (got, n, len(slept)) == want


def test_call_passes_on_retry_and_stops_at_non_exceptions():
    seen = []
    pol = RetryPolicy(attempts=3, base_ms=0, jitter=0.0, sleep=lambda s: None)
    fn, calls = _flaky(2)
    assert pol.call(fn, on_retry=lambda i, e: seen.append((i, type(e).__name__))) == 3
    assert seen == [(1, "OSError"), (2, "OSError")]

    def interrupt():
        calls.append(1)
        raise KeyboardInterrupt

    calls.clear()
    with pytest.raises(KeyboardInterrupt):
        pol.call(interrupt)
    assert len(calls) == 1


@pytest.mark.parametrize("settings", [
    {}, {"RETRY_ATTEMPTS": 1}, {"RETRY_ATTEMPTS": 0, "RETRY_BASE_MS": 0},
    {"RETRY_ATTEMPTS": 6, "RETRY_BASE_MS": 3, "RETRY_MAX_MS": 20, "RETRY_JITTER": 0.4},
])
def test_from_config_equals_the_reference(settings, monkeypatch):
    for prop in (config.RETRY_ATTEMPTS, config.RETRY_BASE_MS, config.RETRY_MAX_MS,
                 config.RETRY_JITTER):
        monkeypatch.delenv(prop.env_name, raising=False)
    with _both(*settings.items()):
        p, j = RetryPolicy.from_config(seed=11), jres.RetryPolicy.from_config(seed=11)
    for f in ("attempts", "base_ms", "max_ms", "jitter", "seed"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.delays_ms() == j.delays_ms()


@pytest.mark.parametrize("exc", [
    OSError("x"), TimeoutError(), ConnectionResetError(), InterruptedError(),
    FileNotFoundError(), IsADirectoryError(), NotADirectoryError(), PermissionError(),
    ValueError(), RuntimeError(), KeyError(),
])
def test_transient_os_error_equals_the_reference(exc):
    assert resilience.transient_os_error(exc) == jres.transient_os_error(exc)


# -- deadlines -------------------------------------------------------------------------------
def test_deadline_scope_and_nesting():
    with deadline_scope(None):
        check_deadline()  # unlimited: a no-op
        with deadline_scope(0.0):
            with pytest.raises(QueryTimeoutError, match="geomesa.query.timeout"):
                check_deadline()
        check_deadline()  # the inner scope popped
    assert resilience.current_deadline() is resilience.UNLIMITED
    assert Deadline.after(None).remaining_s() is None
    assert Deadline.after(100.0).remaining_s() > 99.0
    assert not Deadline.after(100.0).expired and Deadline(0.0).expired


def test_adopt_deadline_crosses_threads():
    errs = []
    with deadline_scope(0.0):
        d = resilience.current_deadline()

        def worker():
            check_deadline()  # nothing scoped on this thread
            with resilience.adopt_deadline(d):
                try:
                    check_deadline()
                except QueryTimeoutError as e:
                    errs.append(e)

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert len(errs) == 1


@pytest.mark.parametrize("text", ["0ms", "100 ms", "10s", "1.5 s", "5 minutes", "2h", "1 day",
                                  "250", "7 sec"])
def test_duration_parsing_equals_the_reference(text):
    with _both(("QUERY_TIMEOUT", text)):
        assert config.QUERY_TIMEOUT.to_duration_ms() == jconfig.QUERY_TIMEOUT.to_duration_ms()
        assert GeoDataset._timeout_s() == JGeoDataset._timeout_s()


@pytest.mark.parametrize("text", ["ms", "5 fortnights"])
def test_bad_durations_raise(text):
    with config.QUERY_TIMEOUT.scoped(text), pytest.raises(ValueError):
        config.QUERY_TIMEOUT.to_duration_ms()


# -- fault injection -------------------------------------------------------------------------
def test_fault_point_is_a_no_op_when_uninstalled():
    assert resilience._injector is None
    fault_point("anything.at.all", extra=1)


def test_inject_faults_requires_the_knob():
    with pytest.raises(RuntimeError, match="geomesa.fault.injection"):
        with inject_faults():
            pass


def test_injector_deterministic_and_bounded():
    with config.FAULT_INJECTION.scoped("true"):
        with inject_faults(seed=3) as inj:
            rule = inj.fail("edge.*", times=2)
            for _ in range(2):
                with pytest.raises(InjectedFault):
                    fault_point("edge.read")
            fault_point("edge.read")  # the rule is spent
            fault_point("other.site")
            assert rule.hits == 2 and inj.seed == 3
            assert [s for s, _ in inj.fired] == ["edge.read", "edge.read"]


@pytest.mark.parametrize("seed", [0, 9, 41])
@pytest.mark.parametrize("p, times", [(0.5, None), (0.2, None), (0.7, 5)])
def test_probabilistic_rules_fire_on_the_reference_hits(seed, p, times):
    def run(mod, cfg):
        fired = []
        with cfg.FAULT_INJECTION.scoped("true"):
            with mod.inject_faults(seed=seed) as inj:
                inj.fail("p.*", times=times, p=p)
                inj.fail("q.*", times=None, p=0.5)
                for i in range(40):
                    site = "p.x" if i % 3 else "q.y"
                    try:
                        mod.fault_point(site, i=i)
                        fired.append(0)
                    except mod.InjectedFault:
                        fired.append(1)
        return fired

    got, want = run(resilience, config), run(jres, jconfig)
    assert got == want and 0 < sum(got) < 40


def test_where_and_delay_rules():
    with config.FAULT_INJECTION.scoped("true"):
        with inject_faults(seed=1) as inj:
            rule = inj.fail("s.*", OSError("slow"), times=None, delay_s=0.05,
                            where=lambda c: c.get("bin") == 2)
            fault_point("s.x", bin=1)
            t0 = time.monotonic()
            with pytest.raises(OSError, match="slow"):
                fault_point("s.x", bin=2)
            assert time.monotonic() - t0 >= 0.05 and rule.hits == 1


def test_partial_scopes_collect_and_nest():
    assert not resilience.partial_allowed()
    with allow_partial() as outer:
        assert resilience.partial_allowed()
        with allow_partial() as inner:
            rec = resilience.record_skip("exec.partition.scan", "bin:1", ValueError("x"), "count")
        resilience.record_skip("join", "tiles[0:3]", ValueError("y"))
    assert inner.skipped == [rec] and inner.degraded
    assert [s.part for s in outer.skipped] == ["tiles[0:3]"]
    assert not resilience.partial_allowed()
    with config.SCAN_PARTIAL.scoped("true"):
        assert resilience.partial_allowed()
    trail = [s.part for s in resilience.skipped()]
    assert trail[-2:] == ["bin:1", "tiles[0:3]"]


# -- the stores --------------------------------------------------------------------------------
def _partitioned(ds, tmp, data):
    ds.create_schema("t", PSPEC)
    st = ds._store("t")
    st.max_resident = 2
    st._spill_dir = str(tmp)
    ds.insert("t", data, fids=np.arange(len(data["weight"])).astype(str))
    ds.flush("t")
    return st


@pytest.fixture(scope="module")
def pds(tmp_path_factory):
    """(JAX, port) partitioned stores of N rows in about seven weekly
    partitions, two resident: the reference's chaos fixture at
    ``tests/test_resilience.py:605-620``, in 512-row lake row groups so a
    small box prunes."""
    data = _data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        mp.setenv("GEOMESA_LAKE_ROWGROUP_ROWS", "512")
        jconfig.MESH_DEVICES.set(1)
        try:
            j = JGeoDataset(n_shards=4)
            _partitioned(j, tmp_path_factory.mktemp("jspill"), data)
            p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
            _partitioned(p, tmp_path_factory.mktemp("pspill"), data)
            yield j, p, data
        finally:
            jconfig.MESH_DEVICES.set(None)


@pytest.fixture(scope="module")
def flat():
    """(JAX, port) flat eight-shard stores of 4,000 rows."""
    data = _data(4000)
    out = []
    for ds in (JGeoDataset(n_shards=8),
               GeoDataset(n_shards=8, device="cpu", compact_min_rows=1, compact_fraction=2.0)):
        ds.create_schema("t", SPEC)
        ds.insert("t", data, fids=np.arange(4000).astype(str))
        ds.flush("t")
        out.append(ds)
    return out


def _fast_retries():
    return _both(("RETRY_BASE_MS", 0), ("RETRY_JITTER", 0))


#: entry point -> call
CALLS = {
    "count": lambda ds: ds.count("t"),
    "count_box": lambda ds: ds.count("t", ECQL),
    "query": lambda ds: ds.query("t", "BBOX(geom, -100, 30, -80, 45)"),
    "query_name": lambda ds: ds.query("t", "name = 'actor1'"),
    "query_batches": lambda ds: list(ds.query_batches("t", ECQL)),
    "sorted_query": lambda ds: ds.query("t", (Query if isinstance(ds, GeoDataset) else JQuery)(
        ECQL, sort_by=[("weight", True)], max_features=10)),
    "density": lambda ds: ds.density("t", bbox=(-180, -90, 180, 90), width=32, height=32),
    "density_weighted": lambda ds: ds.density("t", bbox=(-180, -90, 180, 90), width=32,
                                              height=32, weight="weight"),
    "density_curve": lambda ds: ds.density_curve("t", ECQL, level=6),
    "density_curve_batch": lambda ds: ds.density_curve_batch(
        "t", ECQL, level=6, bboxes=[(-110, 28, -90, 40), (-90, 30, -75, 48)]),
    "density_curve_filter_batch": lambda ds: ds.density_curve_filter_batch(
        "t", ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)"], level=6),
    "stats": lambda ds: ds.stats("t", "MinMax(weight)"),
    "unique": lambda ds: ds.unique("t", "name"),
    "count_batch": lambda ds: ds.count_batch(
        "t", ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)"]),
    "density_batch": lambda ds: ds.density_batch(
        "t", ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)"],
        width=16, height=16),
    "stats_batch": lambda ds: ds.stats_batch(
        "t", "Count()", ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)"]),
    "knn": lambda ds: ds.knn("t", -90.0, 40.0, 5),
}


def _outcome(ds, call):
    try:
        out = CALLS[call](ds)
    except QueryTimeoutError:
        return "QueryTimeoutError"
    except jres.QueryTimeoutError:
        return "QueryTimeoutError"
    return "None" if out is None else "answered"


@pytest.mark.parametrize("partial", [False, True], ids=["strict", "partial"])
@pytest.mark.parametrize("store", ["partitioned", "flat"])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_zero_timeout_raises_where_the_reference_raises(pds, flat, store, call, partial,
                                                        monkeypatch):
    j, p = (pds[0], pds[1]) if store == "partitioned" else flat
    monkeypatch.setenv("GEOMESA_QUERY_TIMEOUT", "0ms")
    outs = []
    for ds, mod in ((p, resilience), (j, jres)):
        if partial:
            with mod.allow_partial() as coll:
                outs.append(_outcome(ds, call))
            assert not coll.skipped  # a deadline is never degraded
        else:
            outs.append(_outcome(ds, call))
    assert outs[0] == outs[1]
    # every scan entry point raises, but kNN (no deadline scope in either
    # package) and a flat store's device feature scans (no deadline site)
    unbounded = call == "knn" or (store == "flat" and call.startswith("query"))
    assert outs[0] == ("answered" if unbounded else "QueryTimeoutError")
    monkeypatch.delenv("GEOMESA_QUERY_TIMEOUT")
    assert p.count("t") == j.count("t")


def test_delay_rule_stops_a_scan_between_partitions(pds):
    """A 0.3 s delay on the first partition's scan, under a 100 ms timeout:
    its fault is degraded, and the deadline raises before the next
    partition in both packages."""
    j, p, _ = pds
    got = []
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        with cfg.FAULT_INJECTION.scoped("true"), cfg.QUERY_TIMEOUT.scoped("100 ms"):
            with mod.inject_faults(seed=1) as inj:
                rule = inj.fail("exec.partition.scan", times=None, delay_s=0.3,
                                where=lambda c: c.get("op") == "count")
                with mod.allow_partial() as partial:
                    t0 = time.monotonic()
                    with pytest.raises(mod.QueryTimeoutError):
                        ds.count("t", ECQL)
                    wall = time.monotonic() - t0
        got.append((rule.hits, [s.part for s in partial.skipped]))
        assert 0.3 <= wall < 5.0
    assert got[0] == got[1] and got[0][0] == 1 and len(got[0][1]) == 1


# -- spill edges (tests/test_chaos.py:251-306, one device) ----------------------------------
def test_spill_load_transient_oserror_retries_in_place(pds):
    j, p, _ = pds
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        st = ds._store("t")
        st.spill_all()
        ref = ds.count("t", ECQL)
        st.spill_all()
        with cfg.FAULT_INJECTION.scoped("true"), _fast_retries(), \
                mod.inject_faults(seed=3) as inj:
            inj.fail("index.spill.load", OSError("nfs blip"), times=2)
            assert ds.count("t", ECQL) == ref  # retried, not degraded
            assert len(inj.fired) == 2
        assert st.spill_quarantine() == {}


def test_spill_load_corruption_quarantines_and_clears(pds):
    out = []
    j, p, _ = pds
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        st = ds._store("t")
        st.spill_all()
        total = ds.count("t", "INCLUDE")
        st.spill_all()
        with cfg.FAULT_INJECTION.scoped("true"), _fast_retries(), \
                mod.inject_faults(seed=4) as inj:
            rule = inj.fail("index.spill.load", ValueError("bad npz"), times=1)
            with mod.allow_partial() as partial:
                got = ds.count("t", "INCLUDE")
            assert rule.hits == 1
        (skip,) = partial.skipped
        assert skip.source == "index.spill.load" and skip.phase == "load"
        dead = int(skip.part.split(":")[1])
        assert got == total - st.part_counts[dead]
        assert list(st.spill_quarantine()) == [dead]
        with mod.allow_partial() as again:
            assert ds.count("t", "INCLUDE") == got  # fails fast: no parse
        assert [s.part for s in again.skipped] == [skip.part]
        with pytest.raises(ValueError, match="quarantined"):
            ds.count("t", "INCLUDE")  # strict mode raises
        assert st.clear_spill_quarantine() == [dead]
        assert st.clear_spill_quarantine() == []
        assert ds.count("t", "INCLUDE") == total
        out.append((dead, got))
    assert out[0] == out[1]


@pytest.fixture()
def fresh(tmp_path):
    """(JAX, port) partitioned stores of 3,000 rows for one test that
    mutates them."""
    data = _data(3000, seed=8)
    jconfig.MESH_DEVICES.set(1)
    try:
        j = JGeoDataset(n_shards=2)
        _partitioned(j, tmp_path / "j", data)
        p = GeoDataset(n_shards=2, device="cpu")
        _partitioned(p, tmp_path / "p", data)
        yield j, p
    finally:
        jconfig.MESH_DEVICES.set(None)


def test_spill_store_retries_never_lose_the_partition(fresh):
    """Two transient ``OSError``s at ``index.spill.store`` are retried: the
    spill lands and the rows read back. With retries off, a failing spill
    raises and the partition stays resident."""
    j, p = fresh
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        st = ds._store("t")
        ref = ds.count("t", "INCLUDE")
        ds.insert("t", _data(64, seed=99), fids=[f"x{i}" for i in range(64)])
        with cfg.FAULT_INJECTION.scoped("true"), _fast_retries(), \
                mod.inject_faults(seed=5) as inj:
            rule = inj.fail("index.spill.store", OSError("disk blip"), times=2)
            ds.flush("t")
            st.spill_all()
            assert rule.hits == 2
        assert not st.partitions and ds.count("t", "INCLUDE") == ref + 64
        ds.insert("t", _data(32, seed=98), fids=[f"y{i}" for i in range(32)])
        with cfg.FAULT_INJECTION.scoped("true"), cfg.RETRY_ATTEMPTS.scoped("1"), \
                mod.inject_faults(seed=6) as inj:
            rule = inj.fail("index.spill.store", OSError("disk full"), times=None)
            with pytest.raises(OSError, match="disk full"):
                ds.flush("t")
                st.spill_all()
            assert rule.hits >= 1
        assert st.partitions  # still resident: nothing was lost
        assert ds.count("t", "INCLUDE") == ref + 96
    assert p.count("t", "INCLUDE") == j.count("t", "INCLUDE")


def _flip(d: str, where: str) -> tuple:
    """Flip one byte of the lake file under ``d``: of its footer, or of the
    first row group's ``c/geom__x`` blob. Returns (path, offset, byte)."""
    path = os.path.join(d, SNAPSHOT_FILE)
    snap = PartitionSnapshot(d)
    if where == "footer":
        off = os.path.getsize(path) - 16 - 20
    else:
        off = snap.file.blobs[snap.groups[0]["cols"]["c/geom__x"]["b"]][0] + 3
    snap.file.close()
    with open(path, "r+b") as fh:
        fh.seek(off)
        old = fh.read(1)
        fh.seek(off)
        fh.write(bytes([old[0] ^ 0x5A]))
    return path, off, old


def _restore(path, off, old):
    with open(path, "r+b") as fh:
        fh.seek(off)
        fh.write(old)


@pytest.mark.parametrize("where", ["footer", "blob"])
def test_corrupt_lake_blob_quarantines_until_cleared(pds, where):
    """One flipped byte in a spilled partition's lake file: a degraded
    pushdown count skips that bin in both packages, the bin is quarantined,
    a repeated count reads nothing of it, and after the byte is restored
    ``clear_spill_quarantine`` re-admits it with the healthy answers."""
    j, p, _ = pds
    out = []
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        st = ds._store("t")
        st.spill_all()
        healthy = (ds.count("t", ECQL), ds.count("t", SMALL))
        st.spill_all()
        b = sorted(st.spilled)[2]
        flipped = _flip(st.spilled[b], where)
        before = metrics.registry().counter(metrics.SPILL_QUARANTINED).value \
            if mod is resilience else None
        with mod.allow_partial() as partial:
            got = ds.count("t", SMALL if where == "blob" else ECQL)
        parts = [s.part for s in partial.skipped]
        assert parts == [f"bin:{b}"] and list(st.spill_quarantine()) == [b]
        if before is not None:
            assert metrics.registry().counter(metrics.SPILL_QUARANTINED).value == before + 1
        reads = []
        with cfg.FAULT_INJECTION.scoped("true"), mod.inject_faults() as inj:
            inj.fail("lake.read", times=None,
                     where=lambda c: reads.append(c["path"]) and False)
            with mod.allow_partial() as again:
                assert ds.count("t", SMALL if where == "blob" else ECQL) == got
        assert [s.part for s in again.skipped] == parts
        assert not any(r == flipped[0] for r in reads)  # no read of the bin
        _restore(*flipped)
        assert st.clear_spill_quarantine(b) == [b]
        assert (ds.count("t", ECQL), ds.count("t", SMALL)) == healthy
        out.append((parts, got, [s.source for s in partial.skipped]))
    assert out[0][:2] == out[1][:2]
    if where == "footer":
        assert out[0][2] == out[1][2] == ["index.spill.load"]


def test_lake_write_fault_point_fails_the_spill_and_keeps_the_rows(fresh):
    j, p = fresh
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        st = ds._store("t")
        ref = ds.count("t", "INCLUDE")
        ds.insert("t", _data(16, seed=97), fids=[f"z{i}" for i in range(16)])
        with cfg.FAULT_INJECTION.scoped("true"), cfg.RETRY_ATTEMPTS.scoped("1"), \
                mod.inject_faults(seed=7) as inj:
            rule = inj.fail("lake.write", times=1)
            with pytest.raises(mod.InjectedFault):
                ds.flush("t")
                st.spill_all()
            assert rule.hits == 1
        assert ds.count("t", "INCLUDE") == ref + 16
        st.spill_all()  # the fault spent: the spill lands
        assert not st.partitions and ds.count("t", "INCLUDE") == ref + 16
    assert p.count("t", "INCLUDE") == j.count("t", "INCLUDE")
