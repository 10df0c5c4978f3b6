"""PyTorch port vs the JAX package: the degradation contract.

Both packages hold the same partitioned store (6,000 rows in about seven
weekly partitions, two resident; ``tests/test_resilience.py:605-620``'s
fixture). The same seeded rule at ``exec.partition.scan`` fails one
partition (or, with ``p < 1``, several). Strict mode raises
``InjectedFault`` and the store stays healthy. Under ``allow_partial()``
both packages skip the same bins, and every answer equals the JAX
package's and the exact answer over the surviving rows: a flat port store
of those rows alone answers the same call. Counts, unweighted grids and
curves, stats and feature rows are equal bit for bit; weighted grids
within rtol 1e-4 (float atomics, and another addition order). Features
drop a failed partition whole.

A ``lake.read`` fault degrades a pruned pushdown count, a join with one
failed tile range or polygon slice lists the same ``skipped`` labels as the
JAX join with the same surviving pairs, and with the aggregate cache on a
degraded answer is never stored. The JAX side runs its Pallas kernels in
interpret mode with compaction forced, the port its kernels' plain
versions.
"""

import contextlib

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import resilience as jres
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu.planning import join_exec as jje
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch import config, resilience
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.planning import join_exec as pje

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 6000
BOX = "BBOX(geom, -110, 28, -75, 48)"
SMALL = "BBOX(geom, -100, 30, -98, 32)"
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
WORLD = (-180.0, -90.0, 180.0, 90.0)
MEMBERS = ["BBOX(geom, -110, 28, -90, 40)", "BBOX(geom, -100, 30, -80, 45)",
           "BBOX(geom, -85, 35, -72, 49)"]


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
    """(JAX, port, data, bin of each row)."""
    data = _data()
    fids = np.arange(N).astype(str)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        mp.setenv("GEOMESA_LAKE_ROWGROUP_ROWS", "512")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            out = []
            for ds, tag in ((JGeoDataset(n_shards=4), "j"),
                            (GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                                        compact_fraction=2.0), "p")):
                ds.create_schema("t", PSPEC)
                st = ds._store("t")
                st.max_resident = 2
                st._spill_dir = str(tmp_path_factory.mktemp(f"{tag}spill"))
                ds.insert("t", data, fids=fids)
                ds.flush("t")
                out.append(ds)
            j, p = out
            bins, _ = p._store("t").binned.to_bin_and_offset(data["dtg"].astype(np.int64))
            yield j, p, data, np.asarray(bins, np.int64)
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


_SURVIVORS = {}


def survivors(pair, dead) -> GeoDataset:
    """A flat port store of the rows outside the ``dead`` bins: the exact
    answer over the surviving partitions."""
    key = tuple(sorted(dead))
    if key not in _SURVIVORS:
        _, _, data, bins = pair
        keep = ~np.isin(bins, list(key))
        ds = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
        ds.create_schema("t", SPEC)
        ds.insert("t", {k: (np.asarray(v, object) if k == "name" else v)[keep]
                        for k, v in data.items()},
                  fids=np.arange(N).astype(str)[keep])
        ds.flush("t")
        _SURVIVORS[key] = ds
    return _SURVIVORS[key]


def _q(ds, *a, **kw):
    return (Query if isinstance(ds, GeoDataset) else JQuery)(*a, **kw)


def _grid(g):
    return np.asarray(g[0] if isinstance(g, tuple) else g, np.float64)


#: op -> (call, kind of answer)
OPS = {
    "count": (lambda ds: ds.count("t"), "int"),
    "count_box": (lambda ds: ds.count("t", BOX), "int"),
    "count_small": (lambda ds: ds.count("t", SMALL), "int"),
    "count_polygon": (lambda ds: ds.count("t", f"INTERSECTS(geom, {TRI})"), "int"),
    "density": (lambda ds: ds.density("t", bbox=WORLD, width=64, height=32), "grid"),
    "density_box": (lambda ds: ds.density("t", BOX, bbox=(-110, 28, -75, 48), width=48,
                                          height=40), "grid"),
    "density_weighted": (lambda ds: ds.density("t", BOX, bbox=(-110, 28, -75, 48), width=48,
                                               height=40, weight="weight"), "wgrid"),
    "stats": (lambda ds: ds.stats("t", "Count();MinMax(weight);Histogram(weight,10,0,10)",
                                  BOX), "stats"),
    "curve": (lambda ds: ds.density_curve("t", BOX, level=6, bbox=(-110, 28, -75, 48)),
              "grid"),
    "curve_batch": (lambda ds: ds.density_curve_batch(
        "t", BOX, level=6, bboxes=[(-110, 28, -90, 40), (-90, 30, -75, 48)]), "grids"),
    "curve_filter_batch": (lambda ds: ds.density_curve_filter_batch(
        "t", MEMBERS, level=6, bboxes=[(-110, 28, -90, 40)] * 3), "grids"),
    "count_batch": (lambda ds: ds.count_batch("t", MEMBERS), "ints"),
    "density_batch": (lambda ds: ds.density_batch("t", MEMBERS, bboxes=[(-110, 28, -75, 48)] * 3,
                                                  width=24, height=24), "grids"),
    "stats_batch": (lambda ds: [s.value() for s in ds.stats_batch(
        "t", "Count();MinMax(weight)", MEMBERS)], "values"),
    "query": (lambda ds: ds.query("t", BOX), "features"),
    "query_batches": (lambda ds: sorted(
        str(f) for b in ds.query_batches("t", BOX) for f in b.columns["__fid__"]), "values"),
    "sorted_query": (lambda ds: ds.query("t", _q(ds, BOX, sort_by=[("weight", True)],
                                                 max_features=25)), "features"),
    "knn": (lambda ds: ds.knn("t", -90.0, 40.0, 12), "features"),
}


def _assert_same(kind, got, want, as_sets=False):
    """``as_sets``: feature rows compare as sets (another store's order)."""
    if kind == "features" and as_sets:
        assert sorted(got.fids) == sorted(want.fids)
        return
    if kind in ("int", "ints", "values"):
        assert got == want
    elif kind == "grid":
        assert np.array_equal(_grid(got), _grid(want))
    elif kind == "wgrid":
        np.testing.assert_allclose(_grid(got), _grid(want), rtol=1e-4)
    elif kind == "grids":
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(_grid(g), _grid(w))
    elif kind == "stats":
        assert [s.value() for s in got.stats] == [s.value() for s in want.stats]
    elif kind == "features":
        assert list(got.fids) == list(want.fids)
        gd, wd = got.to_dict(), want.to_dict()
        assert list(gd) == list(wd)
        for k in wd:
            assert list(gd[k]) == list(wd[k]), k


def _faulted(ds, mod, cfg, fn, partial=True, seed=2, **rule):
    with cfg.FAULT_INJECTION.scoped("true"):
        with mod.inject_faults(seed=seed) as inj:
            inj.fail("exec.partition.scan", **rule)
            if not partial:
                return fn(ds), None
            with mod.allow_partial() as coll:
                return fn(ds), coll.skipped


def _plan_of(ds, query):
    """The dataset's cached plan of ``query`` (the JAX package's ``_plan``
    returns (store, query, plan))."""
    got = ds._plan("t", query)
    return got[2] if isinstance(got, tuple) else got


def _dead_bins(skipped):
    return sorted(int(s.part.split(":")[1]) for s in skipped)


@pytest.mark.parametrize("op", sorted(OPS))
def test_strict_mode_raises_and_the_store_stays_healthy(pair, op):
    j, p, _, _ = pair
    fn, kind = OPS[op]
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        with pytest.raises(mod.InjectedFault):
            _faulted(ds, mod, cfg, fn, partial=False, times=1)
    _assert_same(kind, fn(p), fn(j))
    assert p.count("t") == j.count("t") == N


@pytest.mark.parametrize("target", [0, 3], ids=["first_bin", "middle_bin"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_partial_answers_equal_the_reference_and_the_survivors(pair, op, target):
    """One failed partition: the same bin skipped in both packages, and each
    answer exact over the surviving partitions."""
    j, p, _, bins = pair
    fn, kind = OPS[op]
    dead = sorted(set(bins.tolist()))[target]
    rule = dict(times=None, where=lambda c: c.get("bin") == dead)
    got, pskip = _faulted(p, resilience, config, fn, **rule)
    want, jskip = _faulted(j, jres, jconfig, fn, **rule)
    assert [(s.source, s.part, s.phase) for s in pskip] == \
        [(s.source, s.part, s.phase) for s in jskip]
    assert _dead_bins(pskip) in ([dead], [])  # [] where the op prunes the bin away
    _assert_same(kind, got, want)
    _assert_same(kind, got, fn(survivors(pair, _dead_bins(pskip))), as_sets=True)


@pytest.mark.parametrize("seed", [1, 5, 12])
def test_seeded_probabilistic_rule_skips_the_same_bins(pair, seed):
    j, p, data, bins = pair
    outs = []
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        outs.append(_faulted(ds, mod, cfg, lambda ds: ds.count("t", BOX), seed=seed,
                             times=None, p=0.4))
    (got, pskip), (want, jskip) = outs
    dead = _dead_bins(pskip)
    assert dead == _dead_bins(jskip) and got == want
    x, y = data["geom__x"], data["geom__y"]
    inbox = (x >= -110) & (x <= -75) & (y >= 28) & (y <= 48)
    assert got == int((inbox & ~np.isin(bins, dead)).sum())


def test_scan_partial_knob_degrades_without_a_scope(pair):
    """``geomesa.scan.partial=true`` degrades as ``allow_partial()`` does;
    the skip lands in the call's audit event (the plan's account, which the
    audit takes) and the process trail, as in the JAX package."""
    j, p, _, bins = pair
    dead = sorted(set(bins.tolist()))[4]
    outs = []
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        with cfg.SCAN_PARTIAL.scoped("true"):
            got, _ = _faulted(ds, mod, cfg, lambda ds: ds.count("t", BOX), partial=False,
                              times=None, where=lambda c: c.get("bin") == dead)
        outs.append(got)
    assert outs[0] == outs[1] == survivors(pair, [dead]).count("t", BOX)
    for ds in (p, j):
        assert [r["part"] for r in ds.audit.recent(1)[0].hints["degraded"]] == [f"bin:{dead}"]
        assert "degraded" not in _plan_of(ds, BOX).__dict__
    assert resilience.skipped()[-1].part == f"bin:{dead}"


def test_features_drop_a_failed_partition_whole(pair):
    j, p, data, bins = pair
    dead = sorted(set(bins.tolist()))[2]
    rule = dict(times=1, where=lambda c: c.get("bin") == dead)
    got, pskip = _faulted(p, resilience, config, lambda ds: ds.query("t"), **rule)
    want, _ = _faulted(j, jres, jconfig, lambda ds: ds.query("t"), **rule)
    assert _dead_bins(pskip) == [dead]
    assert sorted(got.fids) == sorted(np.arange(N)[bins != dead].astype(str))
    assert list(got.fids) == list(want.fids)


def test_plan_degraded_is_per_call(pair):
    """The plan records this call's skips and the call's audit event takes
    them, as the JAX package's does; a cached plan's next healthy call
    reports none."""
    j, p, _, bins = pair
    dead = sorted(set(bins.tolist()))[1]
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        _faulted(ds, mod, cfg, lambda ds: ds.count("t", BOX), times=None,
                 where=lambda c: c.get("bin") == dead)
        plan = _plan_of(ds, BOX)
        assert [r["part"] for r in ds.audit.recent(1)[0].hints["degraded"]] == [f"bin:{dead}"]
        assert "degraded" not in plan.__dict__
        ds.count("t", BOX)
        assert "degraded" not in ds.audit.recent(1)[0].hints
        assert "degraded" not in plan.__dict__


def test_lake_read_fault_degrades_a_pruned_pushdown_count(pair, tmp_path):
    """Every ``lake.read`` of one spilled partition fails with an
    ``OSError``: the retries run out, nothing is quarantined, and the pruned
    pushdown count skips that bin in both packages."""
    j, p, data, bins = pair
    out = []
    for ds, mod, cfg in ((p, resilience, config), (j, jres, jconfig)):
        st = ds._store("t")
        st.spill_all()
        dead = sorted(st.spilled)[3]
        path = st.spilled[dead]
        with cfg.FAULT_INJECTION.scoped("true"), cfg.RETRY_BASE_MS.scoped(0), \
                mod.inject_faults(seed=8) as inj:
            rule = inj.fail("lake.read", OSError("remote blip"), times=None,
                            where=lambda c: c["path"].startswith(path))
            with mod.allow_partial() as partial:
                got = ds.count("t", SMALL)
            assert rule.hits == 3  # three tries, each failed
        assert st.spill_quarantine() == {}
        if ds is p:
            assert "rowgroups" in _plan_of(ds, SMALL).exec_path["lake"]
        out.append((got, [(s.source, s.part, s.phase) for s in partial.skipped]))
        assert ds.count("t", SMALL) > got
    assert out[0] == out[1] and out[0][1][0][:2] == ("index.spill.load", f"bin:{dead}")
    x, y = data["geom__x"], data["geom__y"]
    inbox = (x >= -100) & (x <= -98) & (y >= 30) & (y <= 32)
    assert out[0][0] == int((inbox & (bins != dead)).sum())


# -- the aggregate cache ---------------------------------------------------------------------
#: op -> call whose answer the cache stores
CACHED = {
    "count": lambda ds: ds.count("t", BOX),
    "density": lambda ds: ds.density("t", BOX, bbox=(-110, 28, -75, 48), width=32,
                                     height=32),
    "curve": lambda ds: ds.density_curve("t", BOX, level=5, bbox=(-110, 28, -75, 48)),
    "stats": lambda ds: ds.stats("t", "Count()", BOX),
}


def _value(op, v):
    if op == "stats":
        return [s.value() for s in getattr(v, "stats", [v])]
    return v if op == "count" else _grid(v).tolist()


CACHE_COUNTERS = ("cache.hit", "cache.miss", "cache.put")


def _counting(metrics_mod, fn):
    """(fn's answer, the cache counters' deltas over the call)."""
    reg = metrics_mod.registry()
    before = [reg.counter(c).value for c in CACHE_COUNTERS]
    out = fn()
    return out, {c: reg.counter(c).value - b for c, b in zip(CACHE_COUNTERS, before)}


@pytest.mark.parametrize("op", sorted(CACHED))
def test_a_degraded_answer_is_never_cached(pair, op):
    """With the cache on, a degraded call stores nothing; the next
    fault-free call misses and returns the full answer, and a repeat of it
    is a whole hit. The cache counters move alike in both packages."""
    from geomesa_tpu import metrics as jmetrics
    from geomesa_tpu_torch import metrics as pmetrics

    j, p, _, bins = pair
    dead = sorted(set(bins.tolist()))[2]
    fn = CACHED[op]
    trails = []
    for ds, mod, cfg, met in ((p, resilience, config, pmetrics),
                              (j, jres, jconfig, jmetrics)):
        full = _value(op, fn(ds))
        with cfg.CACHE_ENABLED.scoped("true"), cfg.CACHE_CELLS_PER_AXIS.scoped(2):
            ds.cache.store.invalidate()
            (degraded, skipped), d0 = _counting(met, lambda: _faulted(
                ds, mod, cfg, fn, times=None, where=lambda c: c.get("bin") == dead))
            v1, d1 = _counting(met, lambda: fn(ds))
            v2, d2 = _counting(met, lambda: fn(ds))
            ds.cache.store.invalidate()
        assert skipped and _value(op, degraded) != full
        assert d0["cache.put"] == 0  # nothing degraded is stored
        assert _value(op, v1) == full and d1["cache.hit"] == 0 and d1["cache.miss"] >= 1
        assert _value(op, v2) == full and d2["cache.hit"] >= 1 and d2["cache.miss"] == 0
        trails.append((d0, d1, d2))
    assert trails[0] == trails[1]


# -- joins ------------------------------------------------------------------------------------
def _clustered(rng, n, centres, spread):
    cx, cy = centres
    k = rng.integers(0, len(cx), n)
    return (np.clip(cx[k] + rng.normal(0, spread, n), -179, 179),
            np.clip(cy[k] + rng.normal(0, spread, n), -89, 89))


@pytest.fixture(scope="module")
def join_pair():
    """(JAX, port) with point schemas a and b (clustered so the adaptive
    join routes cells to several strategies) and polygon schema c."""
    rng = np.random.default_rng(5)
    centres = (rng.uniform(-60, 60, 10), rng.uniform(-30, 30, 10))
    ax, ay = _clustered(rng, 1500, centres, 0.5)
    bx, by = _clustered(rng, 1200, centres, 0.5)
    sx, sy = rng.uniform(-60, 60, 60), rng.uniform(-30, 30, 60)  # sparse cells
    polys = [f"POLYGON(({x - 3} {y - 2}, {x + 3} {y - 2}, {x} {y + 3}, {x - 3} {y - 2}))"
             for x, y in zip(centres[0][:5], centres[1][:5])]
    out = []
    jconfig.MESH_DEVICES.set(1)
    try:
        for ds in (JGeoDataset(n_shards=4), GeoDataset(n_shards=4, device="cpu")):
            ds.create_schema("a", "name:String,*geom:Point")
            ds.create_schema("b", "tag:String,*geom:Point")
            ds.create_schema("c", "kind:String,*geom:Polygon")
            xs, ys = np.concatenate([ax, sx]), np.concatenate([ay, sy])
            ds.insert("a", {"name": ["n"] * len(xs), "geom": list(zip(xs, ys))},
                      fids=[f"a{i}" for i in range(len(xs))])
            xs, ys = np.concatenate([bx, sx + 0.01]), np.concatenate([by, sy])
            ds.insert("b", {"tag": ["t"] * len(xs), "geom": list(zip(xs, ys))},
                      fids=[f"b{i}" for i in range(len(xs))])
            ds.insert("c", {"kind": [f"k{i}" for i in range(len(polys))],
                            "geom": np.array(polys, object)})
            ds.flush()
            out.append(ds)
        yield out
    finally:
        jconfig.MESH_DEVICES.set(None)


@contextlib.contextmanager
def _failing(module, attr, pick):
    """Make ``module.attr`` raise where ``pick(args, kwargs)`` says so;
    yields the argument tuples it failed on."""
    real = getattr(module, attr)
    failed = []

    def wrapper(*a, **kw):
        if pick(a, kw):
            failed.append((a, kw))
            raise RuntimeError(f"{attr} failed")
        return real(*a, **kw)

    setattr(module, attr, wrapper)
    try:
        yield failed
    finally:
        setattr(module, attr, real)


def _section(a, kw):
    return kw.get("sec", a[1] if len(a) > 1 else None)


@pytest.mark.parametrize("case", ["brute", "pairwise", "polygon"])
@pytest.mark.parametrize("want_pairs", [True, False], ids=["pairs", "count"])
def test_a_failed_join_range_degrades_like_the_reference(join_pair, case, want_pairs):
    j, p = join_pair
    kw = {"predicate": "dwithin", "distance": 0.3}
    if case == "polygon":
        kw = {"predicate": "pip"}
    right = "c" if case == "polygon" else "b"
    fulls = [ds.join("a", right, **kw) for ds in (p, j)]
    res = []
    for ds, mod, je in ((p, resilience, pje), (j, jres, jje)):
        def cm(je=je):
            if case == "brute":
                return _failing(je, "_run_brute_slice", lambda a, k: a[1] == 0)
            if case == "pairwise":
                return _failing(je, "_run_slice",
                                lambda a, k: _section(a, k).strategy == "pairwise")
            return _failing(je, "_run_poly_slice", lambda a, k: True)

        with cm() as failed, mod.allow_partial() as partial:
            if want_pairs:
                r = ds.join_spatial("a", right, **kw)
            else:
                r = ds.join_count("a", right, **kw)
        assert failed
        with pytest.raises(RuntimeError, match="failed"), cm():
            ds.join_spatial("a", right, **kw)  # strict mode raises
        res.append((r, [s.part for s in partial.skipped], failed))
    (got, pparts, pfailed), (want, jparts, _) = res
    assert pparts == jparts and len(pparts) == 1
    if not want_pairs:
        assert got == want < fulls[0].count
        return
    assert got.degraded and want.degraded
    assert got.stats.skipped == want.stats.skipped == pparts
    assert np.array_equal(got.pairs, want.pairs) and got.count == want.count == len(got.pairs)
    full = {tuple(r) for r in fulls[0].pairs}
    assert np.array_equal(fulls[0].pairs, fulls[1].pairs)
    left = {tuple(r) for r in got.pairs}
    assert left < full
    if case == "brute":
        # the survivors: every pair but the failed brute range's candidates
        plan = pfailed[0][0][0]
        lo, hi = pfailed[0][0][1], pfailed[0][0][2]
        lost = set(zip(plan.brute_l[lo:hi].tolist(), plan.brute_r[lo:hi].tolist()))
        assert left == {pr for pr in full if pr not in lost}
    text = p.explain_join("a", right, analyze=True, **kw)
    assert "degraded" not in text


def test_degraded_explain_and_pushdown_labels(join_pair, tmp_path):
    j, p = join_pair
    outs = []
    for ds, mod, je in ((p, resilience, pje), (j, jres, jje)):
        with _failing(je, "_run_brute_slice", lambda a, k: True), mod.allow_partial():
            text = ds.explain_join("a", "b", predicate="dwithin", distance=0.3, analyze=True)
        outs.append([line.strip() for line in text.splitlines()
                     if "degraded" in line or "matched" in line])
    assert outs[0] == outs[1] and any("brute[" in line for line in outs[0])
