"""The call-time knobs of the ported paths against the JAX package's: under
the same scoped value of each knob both packages plan and answer alike.

Compaction (``geomesa.compact.enabled`` / ``.min.rows`` / ``.fraction`` /
``.b`` / ``.shard.bucket``), shards (``geomesa.index.shards`` and the
schema's ``geomesa.z.splits``), the decider (``geomesa.strategy.decider``),
the device top-k's ``geomesa.topk.tie-slack``, per-key sampling's
``geomesa.sample.hash-buckets``, and the density ladder
(``geomesa.density.pallas`` / ``.mxu``, ``geomesa.mxu.tile.x`` / ``.y``):
each case compares the ``exec_path`` notes (the layout and ``B``, the index
chosen, the sort route, the sampling mode, ``density_kernel``), the answers
(counts and unweighted grids bit for bit, weighted grids within the
reference's rtol 1e-4) and the ``compact.desc.shared`` counter deltas. The
einsum rung's grid is also held against the JAX ``density_grid_pairs`` on
the same compact rows and pair arrays. The JAX side runs its Pallas kernels
in interpret mode, as its own tests do. A stateful cache of the reference
that the knob does not key (its plan cache, the descriptor share) is kept
out of the comparison by giving such cases data or windows of their own."""

import contextlib

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.kernels import density_mxu as jmxu
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch import config as pconfig
from geomesa_tpu_torch import metrics as pmetrics
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import density_mxu as pmxu

N = 6_000
SPEC = "weight:Float,code:Integer,level:Integer,dtg:Date,*geom:Point"
BOX = "BBOX(geom, -100, 30, -80, 45)"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
ECQL = f"{BOX} AND {DURING}"
GRID = dict(bbox=(-100.0, 30.0, -80.0, 45.0), width=128, height=96)


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
    """Scope each knob (a config attribute name) to a value in both
    packages."""
    with contextlib.ExitStack() as stack:
        for name, v in knobs.items():
            stack.enter_context(getattr(jconfig, name).scoped(v))
            stack.enter_context(getattr(pconfig, name).scoped(v))
        yield


#: the scope that makes a small table compact whatever its windows admit
COMPACT = dict(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=1e9)


def make_data(n=N, seed=17):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    return {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "code": rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32),
        # four values: wide tie groups for the top-k
        "level": rng.integers(0, 4, n).astype(np.int32),
    }


def make_pair(spec=SPEC, n=N, seed=17, **ctor):
    data = make_data(n, seed)
    j = JGeoDataset(**ctor)
    p = GeoDataset(device="cpu", **ctor)
    for ds in (j, p):
        ds.create_schema("t", spec)
        ds.insert("t", data, fids=np.arange(n).astype(str))
        ds.flush("t")
    return j, p


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        yield make_pair(n_shards=4)


def run_both(j, p, q, fn):
    """(port answer, JAX answer, port exec_path, JAX exec_path) of one call."""
    jplan = j._plan("t", q)[2]
    want = fn(j)
    got = fn(p)
    return got, want, dict(p._plan("t", q).exec_path), dict(jplan.exec_path)


def shared_deltas(fn):
    """``compact.desc.shared`` deltas of ``fn()`` in (port, JAX)."""
    c = (pmetrics.registry().counter(pmetrics.COMPACT_DESC_SHARED),
         jmetrics.registry().counter(jmetrics.COMPACT_DESC_SHARED))
    before = [x.value for x in c]
    fn()
    return tuple(x.value - b for x, b in zip(c, before))


# -- compaction -----------------------------------------------------------------------
#: (knob scope, query, want scan layout, want B) -- every box its own, so the
#: reference's descriptor share (keyed without the fraction) never serves a
#: descriptor built under another scope
COMPACT_CASES = {
    "default_b": (dict(COMPACT), f"BBOX(geom, -100, 30, -80, 45) AND {DURING}",
                  "device-compact", None),
    "b_clamped_low": (dict(COMPACT, COMPACT_B=300), f"BBOX(geom, -101, 30, -80, 45) AND {DURING}",
                      "device-compact", 256),
    "b_clamped_high": (dict(COMPACT, COMPACT_B=100_000),
                       f"BBOX(geom, -102, 30, -80, 45) AND {DURING}", "device-compact", 4096),
    "b_on_the_ladder": (dict(COMPACT, COMPACT_B=512), f"BBOX(geom, -103, 30, -80, 45) AND {DURING}",
                        "device-compact", 512),
    # these three never reach the share: one box serves them
    "disabled": (dict(COMPACT, COMPACT_ENABLED="false"),
                 f"BBOX(geom, -104, 30, -80, 45) AND {DURING}", "device-padded", None),
    "under_min_rows": (dict(COMPACT_MIN_ROWS=N + 1, COMPACT_FRACTION=1e9),
                       f"BBOX(geom, -104, 30, -80, 45) AND {DURING}", "device-padded", None),
    "default_min_rows": ({}, f"BBOX(geom, -104, 30, -80, 45) AND {DURING}", "device-padded", None),
    "fraction_refuses": (dict(COMPACT_MIN_ROWS=1, COMPACT_FRACTION=0.01),
                         f"BBOX(geom, -107, 30, -80, 45) AND {DURING}", "device-padded", None),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compaction_knobs(pair, case):
    j, p = pair
    scope, q, scan, B = COMPACT_CASES[case]
    with both(**scope):
        got, want, pp, jp = run_both(j, p, q, lambda ds: ds.count("t", q))
        assert got == want
        assert pp["scan"] == jp["scan"] == scan
        assert pp.get("B") == jp.get("B")
        if B is not None:
            assert pp["B"] == B


def test_compact_descriptor_share_counts_alike(pair):
    """Two query texts that resolve the same windows: the second plan's
    descriptor comes from the store's share in both packages."""
    j, p = pair
    q1 = f"BBOX(geom, -95, 32, -85, 41) AND {DURING}"
    q2 = f"{q1} AND weight >= 0"
    with both(**COMPACT):
        assert shared_deltas(lambda: [ds.count("t", q1) for ds in (j, p)]) == (0, 0)
        d = shared_deltas(lambda: [ds.count("t", q2) for ds in (j, p)])
        assert d == (1, 1)
        assert p.count("t", q2) == j.count("t", q2)


def test_shard_bucket_and_index_shards():
    """``geomesa.compact.shard.bucket`` sets the padded shard length and
    ``geomesa.index.shards`` the shard count of a store made with none:
    equal layouts, windows and answers."""
    with both(COMPACT_SHARD_BUCKET=1024, DEFAULT_SHARDS=3, **COMPACT):
        j, p = make_pair(n=3_000, seed=5)
        jt, pt = j._store("t").tables["z3"], p._store("t").tables["z3"]
        assert pt.n_shards == jt.n_shards == 3
        assert pt.shard_len == jt.shard_len == 1024
        q = ECQL
        got, want, pp, jp = run_both(j, p, q, lambda ds: ds.count("t", q))
        assert got == want and pp["scan"] == jp["scan"] and pp.get("B") == jp.get("B")
    with both(COMPACT_BUCKETING="false"):
        assert pt.shard_len == jt.shard_len == 1000


@pytest.mark.parametrize("spec,want", [
    (SPEC, None),
    (SPEC + ";geomesa.z.splits='5'", 5),
], ids=["knob", "z_splits"])
@pytest.mark.parametrize("shards", [None, "2"], ids=["default", "scoped"])
def test_dataset_default_shard_count(spec, want, shards):
    """``GeoDataset()`` with no ``n_shards``: the schema's
    ``geomesa.z.splits``, else ``geomesa.index.shards`` (4 by default), as
    the reference resolves it; an explicit ``n_shards`` wins."""
    scope = {} if shards is None else {"DEFAULT_SHARDS": shards}
    with both(**scope):
        j, p = JGeoDataset(), GeoDataset(device="cpu")
        j.create_schema("t", spec)
        p.create_schema("t", spec)
        n = p._store("t").n_shards
        assert n == j._store("t").n_shards
        assert n == (want or int(shards or 4))
        e = GeoDataset(n_shards=7, device="cpu")
        e.create_schema("t", spec)
        assert e._store("t").n_shards == 7


# -- the decider ----------------------------------------------------------------------
DECIDER_QUERIES = [
    ECQL,
    BOX,
    f"{BOX} AND code > 5",
    "IN ('3', '17')",
    f"{DURING} AND code < 0",
]


@pytest.mark.parametrize("decider", ["cost", "first"])
def test_strategy_decider(decider):
    """Under ``geomesa.strategy.decider`` other than ``cost`` the first
    candidate serves (fresh datasets: the reference's plan cache does not
    key the knob; the JAX side answers on its host runner, the same exact
    answers with no compile per query)."""
    spec = "weight:Float,code:Integer:index=true,dtg:Date,*geom:Point"
    data = make_data(4_000, 9)
    j = JGeoDataset(n_shards=2, prefer_device=False)
    p = GeoDataset(n_shards=2, device="cpu")
    for ds in (j, p):
        ds.create_schema("t", spec)
        ds.insert("t", data, fids=np.arange(4_000).astype(str))
        ds.flush("t")
    with both(STRATEGY_DECIDER=decider):
        for q in DECIDER_QUERIES:
            got, want, _, _ = run_both(j, p, q, lambda ds: ds.count("t", q))
            assert got == want, q
            assert p._plan("t", q).index_name == j._plan("t", q)[2].index_name, q
    if decider != "cost":
        # the port's plan cache keys the knob: cost decides again outside it
        assert p._plan("t", ECQL).index_name == "z3"
        with both(STRATEGY_DECIDER=decider):
            assert p._plan("t", ECQL).index_name == "z3"  # the first candidate
            assert p._plan("t", BOX).index_name == "z2"


# -- the device top-k's tie slack ----------------------------------------------------------
@pytest.mark.parametrize("slack", [4096, 8], ids=["default", "small"])
def test_topk_tie_slack(pair, slack):
    """A tie group wider than k + slack (about 180 rows of the lowest
    ``level``) leaves the device selection to the host sort in both
    packages; the rows are the same either way."""
    j, p = pair
    q = f"{BOX} AND code > 0"
    jq = JQuery(ecql=q, sort_by=[("level", False)], max_features=5)
    pq = Query(ecql=q, sort_by=[("level", False)], max_features=5)
    with both(TOPK_TIE_SLACK=slack, **COMPACT):
        jplan = j._plan("t", jq)[2]
        fj = j.query("t", jq)
        fp = p.query("t", pq)
        pplan = p._plan("t", pq)
    assert list(fp.columns["__fid__"]) == list(fj.columns["__fid__"])
    assert list(fp.columns["level"]) == [0] * 5
    sort = pplan.exec_path.get("sort")
    assert sort == jplan.exec_path.get("sort")
    assert (sort == "device-topk(k=5)") == (slack > 1000)


# -- per-key sampling's hash buckets -----------------------------------------------------
@pytest.mark.parametrize("buckets", [64, 16, 0])
def test_sample_hash_buckets(pair, buckets):
    """``sample_by`` a wide int key: hashed into the scoped bucket count on
    the device, or (0) counted exactly per key on the host; the sampling
    mode note and the sampled count are the reference's."""
    j, p = pair
    q = f"{BOX} AND {DURING}"
    with both(SAMPLE_HASH_BUCKETS=buckets, **COMPACT):
        jq = JQuery(ecql=q, sampling=3, sample_by="code")
        pq = Query(ecql=q, sampling=3, sample_by="code")
        jplan = j._plan("t", jq)[2]
        want = j.count("t", jq)
        got = p.count("t", pq)
        pp, jp = dict(p._plan("t", pq).exec_path), dict(jplan.exec_path)
    assert got == want
    assert pp.get("sampling") == jp.get("sampling") == ("hash" if buckets else None)
    assert pp["scan"] == jp["scan"]
    assert pp["scan"].startswith("device" if buckets else "host")


# -- the density ladder ---------------------------------------------------------------------
RUNGS = {
    # (knob scope, want density_kernel)
    "grouped": ({}, "grouped"),
    "einsum": (dict(DENSITY_PALLAS="false"), "mxu-einsum"),
    "einsum_over_the_dup_budget": (dict(DENSITY_PALLAS_MAX_DUP=0.0), "mxu-einsum"),
    "scatter": (dict(DENSITY_PALLAS="false", DENSITY_MXU="false"), "scatter"),
    "einsum_tile_16x32": (dict(DENSITY_PALLAS="false", MXU_TILE_X=32, MXU_TILE_Y=16),
                          "mxu-einsum"),
}


@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_density_rungs(pair, rung, weight):
    j, p = pair
    scope, kern = RUNGS[rung]
    q = ECQL
    with both(**scope, **COMPACT):
        g, w, pp, jp = run_both(j, p, q, lambda ds: ds.density("t", q, weight=weight, **GRID))
    jk = {"pallas-grouped-mxu": "grouped"}.get(jp.get("density_kernel"), jp.get("density_kernel"))
    assert pp["density_kernel"] == jk == kern
    assert pp["scan"] == jp["scan"] == "device-compact" and pp["B"] == jp["B"]
    assert g.dtype == np.float32 and g.shape == (GRID["height"], GRID["width"])
    if weight is None:
        assert np.array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("tile,grid", [((32, 64), (128, 96)), ((8, 128), (300, 200))],
                         ids=str)
def test_density_grid_pairs_equal_the_jax_einsum(pair, tile, grid):
    """The einsum rung on the same compact rows and pair arrays as the JAX
    ``density_grid_pairs``: the pair schedules equal, the unweighted grid
    bit for bit, the weighted within rtol 1e-4."""
    import jax.numpy as jnp

    j, p = pair
    W, H = grid
    bbox = GRID["bbox"]
    TY, TX = tile
    with both(MXU_TILE_Y=TY, MXU_TILE_X=TX, **COMPACT):
        ex = p._executor("t")
        plan = p._plan("t", ECQL)
        setup = ex._scan_setup(plan, ["geom__x", "geom__y", "weight"])
        ex._maybe_compact(plan, setup)
        d, table = setup["compact"], setup["table"]
        pr = pmxu.build_pairs(d, table, table.keyspace, bbox, W, H)
        jst, _, jplan = j._plan("t", ECQL)
        jex = j._executor(jst)
        jsetup = jex._scan_setup(jplan, [])
        jex._maybe_compact(jplan, jsetup, True)
        jpr = jmxu.build_pairs(jsetup["compact"], jsetup["table"], jsetup["table"].keyspace,
                               bbox, W, H)
    # the port's arrays are the reference's real pairs, without its padding
    n = pr["n_pairs"]
    for k in ("chunk", "px0", "py0", "tile"):
        assert np.array_equal(pr[k], jpr[k][:n]), k
    assert np.array_equal(jpr["pvalid"], np.arange(jpr["P"]) < n)
    for k in ("P", "PB", "ntx", "nty", "TY", "TX", "n_pairs"):
        assert pr[k] == jpr[k], k
    cols, m = ex._fused(plan, setup, ["geom__x", "geom__y", "weight"])
    x, y, wt = cols["geom__x"], cols["geom__y"], cols["weight"]
    sched = dict(pr, chunk=torch.from_numpy(pr["chunk"].astype(np.int64)),
                 tile=torch.from_numpy(pr["tile"].astype(np.int64)),
                 px0=torch.from_numpy(pr["px0"]), py0=torch.from_numpy(pr["py0"]))
    jargs = [jnp.asarray(jpr[k]) for k in ("chunk", "px0", "py0", "tile", "pvalid")]
    xs, ys, ms, ws = (jnp.asarray(t.numpy()) for t in (x, y, m, wt))
    for weight in (None, wt):
        got = pmxu.density_grid_pairs(x, y, m, bbox, W, H, weight, sched).numpy()
        want = np.asarray(jmxu.density_grid_pairs(
            xs, ys, ms, bbox, W, H, None if weight is None else ws, *jargs,
            pr["PB"], pr["ntx"], pr["nty"], TY, TX, jnp))
        assert got.shape == want.shape == (H, W)
        if weight is None:
            assert np.array_equal(got, want)
            assert got.sum() == float(m.sum())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_build_pairs_serves_z3_and_z2_only(pair):
    """The einsum rung's schedule exists for z3 / z2 keys only, as the
    reference's: another key space gets None (its scans scatter)."""
    _, p = pair
    ex = p._executor("t")
    with both(**COMPACT):
        plan = p._plan("t", ECQL)
        setup = ex._scan_setup(plan, [])
        ex._maybe_compact(plan, setup)
    d, table = setup["compact"], setup["table"]

    class _Other:
        kind = "xz2"

    assert pmxu.build_pairs(d, table, table.keyspace, GRID["bbox"], 64, 64) is not None
    assert pmxu.build_pairs(d, table, _Other(), GRID["bbox"], 64, 64) is None
    assert pmxu.pair_batch(128) == jmxu.pair_batch(128) == 4096
    assert pmxu.pair_batch(4096) == jmxu.pair_batch(4096) == 128
    with both(MXU_TILE_X=16, MXU_TILE_Y=8):
        assert pmxu.tile_shape() == jmxu.tile_shape() == (8, 16)
