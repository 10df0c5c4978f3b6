"""PyTorch port vs the JAX package: the grouped density kernel module.

The same 40k-row dataset is ingested by both packages (compaction forced,
as tests/test_density_pallas.py forces it). The port's pair schedule must
equal the JAX ``build_grouped`` arrays, and its plain grouped density (what
its wrapper runs for CPU tensors) must match the JAX Pallas kernel run in
interpret mode on the same compact rows: unweighted exactly, weighted within
the reference's rtol 1e-4 / atol 1e-3 (f32 sums in another order)."""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu.kernels import density_pallas as jdp
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import density_grouped as kg
from geomesa_tpu_torch import config as pconfig

ECQL = (
    "BBOX(geom, -100, 30, -80, 45) AND "
    "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
)
BBOX = (-100.0, 30.0, -80.0, 45.0)
GRIDS = [(256, 256), (300, 200), (512, 512)]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(13)
    n = 40_000
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }
    spec = "weight:Float,dtg:Date,*geom:Point"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        try:
            j = JGeoDataset(n_shards=4)
            j.create_schema("t", spec)
            j.insert("t", data, fids=np.arange(n).astype(str))
            j.flush("t")
            p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            p.create_schema("t", spec)
            p.insert("t", data)
            p.flush("t")
            yield j, p
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)


def _jax_compact(j):
    st, _, plan = j._plan("t", ECQL)
    ex = j._executor(st)
    setup = ex._scan_setup(plan, [])
    ex._maybe_compact(plan, setup, True)
    return setup["compact"], setup["table"]


def _port_compact(p):
    ex = p._executor("t")
    plan = p._plan("t", ECQL)
    setup = ex._scan_setup(plan, [])
    ex._maybe_compact(plan, setup)
    return setup["compact"], setup["table"]


def test_compact_descriptor_equal(pair):
    j, p = pair
    dj, _ = _jax_compact(j)
    dp, _ = _port_compact(p)
    assert dj is not None and dp is not None
    assert (dj["B"], dj["C"]) == (dp["B"], dp["C"])
    for k in ("cstart", "lo", "valid"):
        assert np.array_equal(dj[k], dp[k]), k


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_build_grouped_equal(pair, grid):
    j, p = pair
    W, H = grid
    dj, tj = _jax_compact(j)
    dp, tp = _port_compact(p)
    gj = jdp.build_grouped(dj, tj, tj.keyspace, BBOX, W, H)
    gp = kg.build_grouped(dp, tp, tp.keyspace, BBOX, W, H)
    assert gj is not None and gp is not None
    assert set(gj) == set(gp)
    for k, v in gj.items():
        assert np.array_equal(np.asarray(v), np.asarray(gp[k])), k


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("weighted", [False, True], ids=["count", "weighted"])
def test_plain_matches_pallas_interpret(pair, grid, weighted, monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setenv("GEOMESA_PALLAS_INTERPRET", "1")
    j, p = pair
    W, H = grid
    ex = p._executor("t")
    plan = p._plan("t", ECQL)
    ops = ex.density_inputs(plan, BBOX, W, H, "weight" if weighted else None)
    x, y, mask, weight = ops["x"], ops["y"], ops["mask"], ops["weight"]
    assert mask.dtype == torch.bool and mask.shape == x.shape
    if weighted:
        assert torch.equal(weight, ex.scan_columns(plan, ["weight"])["weight"])
    else:
        assert weight is None
    got = kg.density_grouped(x, y, mask, weight, BBOX, W, H, ops["sched"]).numpy()
    want = _jax_grouped(j, x, y, mask, weight, W, H)
    assert got.shape == want.shape == (H, W)
    if weighted:
        assert np.allclose(got, want, rtol=1e-4, atol=1e-3)
        assert abs(got.sum() - want.sum()) / max(want.sum(), 1) < 1e-4
    else:
        assert np.array_equal(got, want)
        assert got.sum() == float(mask.sum())


def _jax_grouped(j, x, y, mask, weight, W, H):
    """The JAX Pallas grouped kernel (interpret mode) on the port's compact
    operands, under the JAX package's own pair schedule."""
    import jax.numpy as jnp

    dj, tj = _jax_compact(j)
    gr = jdp.build_grouped(dj, tj, tj.keyspace, BBOX, W, H)
    return np.asarray(jdp.density_grid_grouped(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jnp.asarray(mask.numpy()), BBOX, W, H,
        None if weight is None else jnp.asarray(weight.numpy()),
        *(jnp.asarray(gr[k]) for k in ("sc", "row", "tile", "ox", "oy", "seen")),
        gr["B"], gr["ntx"], gr["nty"], gr["n_pairs"],
    ))


def test_nan_weight_under_a_false_mask_adds_nothing(pair, monkeypatch):
    """The kernel takes the mask and the weight apart, as the reference
    does: a NaN weight on a row whose mask is false never reaches the grid
    (``jnp.where(mask, weight, 0)`` in the reference)."""
    monkeypatch.setenv("GEOMESA_PALLAS_INTERPRET", "1")
    j, p = pair
    ex = p._executor("t")
    ops = ex.density_inputs(p._plan("t", ECQL), BBOX, 256, 256, "weight")
    x, y, mask = ops["x"], ops["y"], ops["mask"]
    assert 0 < int(mask.sum()) < mask.numel()
    weight = torch.where(mask, ops["weight"], torch.full((), float("nan")))
    got = kg.density_grouped(x, y, mask, weight, BBOX, 256, 256, ops["sched"]).numpy()
    want = _jax_grouped(j, x, y, mask, weight, 256, 256)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.allclose(got, want, rtol=1e-4, atol=1e-3)
    clean = kg.density_grouped(x, y, mask, ops["weight"], BBOX, 256, 256, ops["sched"])
    assert torch.equal(torch.from_numpy(got), clean)


@pytest.mark.parametrize("target", [1, 7, 8, 264])
def test_tile_segments_partition_the_pairs(pair, target):
    """Each tile of the grid gets exactly ``target`` (the cluster size)
    consecutive segments splitting its chunk run evenly; no pair is lost or
    doubled; tiles without pairs keep their segments, all empty, so the
    kernel writes their zeros. The second bbox reaches past the query's, so
    some of its tiles have no pairs."""
    _, p = pair
    dp, tp = _port_compact(p)
    empty_seen = 0
    for bbox in (BBOX, (-100.0, 30.0, -40.0, 45.0)):
        gr = kg.build_grouped(dp, tp, tp.keyspace, bbox, 512, 512)
        seg = kg.tile_segments(gr, target)
        real = gr["ox"] != kg._OFFGRID
        assert np.array_equal(seg["chunks"], (gr["sc"] * kg.SG + gr["row"])[real])
        assert np.array_equal(seg["pair_tile"], gr["tile"][real])
        ntiles = gr["ntx"] * gr["nty"]
        assert np.array_equal(seg["seg_tile"], np.repeat(np.arange(ntiles), target))
        # segments tile [0, P) in order, each inside one tile's run
        b, e = seg["seg_begin"], seg["seg_end"]
        assert b[0] == 0 and e[-1] == len(seg["chunks"])
        assert np.array_equal(b[1:], e[:-1]) and (e >= b).all()
        for t, lo, hi in zip(seg["seg_tile"], b, e):
            assert (seg["pair_tile"][lo:hi] == t).all()
        count = np.bincount(seg["pair_tile"], minlength=ntiles)
        sizes = (e - b).reshape(ntiles, target)
        assert np.array_equal(sizes.sum(axis=1), count)
        assert (sizes.max(axis=1) - sizes.min(axis=1) <= 1).all()
        assert (sizes[count == 0] == 0).all()
        empty_seen += int((count == 0).sum())
    assert empty_seen > 0


def test_scatter_rung_over_the_duplication_budget(pair):
    """Over the pair budget the port leaves the grouped rung, as the
    reference leaves its Pallas rung there: to the einsum pairs, and to the
    scatter with ``geomesa.density.mxu`` off; unweighted counts are the
    same on every rung."""
    _, p = pair
    plan = p._plan("t", ECQL)
    ex = p._executor("t")
    g_grouped = ex.density(plan, BBOX, 256, 256)
    assert plan.exec_path["density_kernel"] == "grouped"
    tight = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                       compact_fraction=2.0)
    tight.attach_store(p._store("t"))
    ex_tight = tight._executor("t")
    plan_t = tight._plan("t", ECQL)
    with pconfig.DENSITY_PALLAS_MAX_DUP.scoped(0.01):
        g_einsum = ex_tight.density(plan_t, BBOX, 256, 256)
        assert plan_t.exec_path["density_kernel"] == "mxu-einsum"
        with pconfig.DENSITY_MXU.scoped(False):
            g_scatter = ex_tight.density(plan_t, BBOX, 256, 256)
    assert plan_t.exec_path["density_kernel"] == "scatter"
    assert np.array_equal(g_grouped, g_scatter)
    assert np.array_equal(g_grouped, g_einsum)
