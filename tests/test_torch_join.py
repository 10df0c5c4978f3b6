"""PyTorch port vs the JAX package: the spatial joins.

The kernel functions of ``kernels/join.py`` (pair verdicts, crossing
parity, polygon verdicts, ``pip_assign``, cell classification) and the
plain versions of the port's join kernels against the JAX functions and
jitted kernels; ``co_partition`` plans against the JAX ``JoinPlan``;
``run_join`` / ``run_polygon_join`` against the JAX package and the NumPy
brute force; and the ``GeoDataset`` calls (``join``, ``join_spatial``,
``join_count``, ``explain_join``, ``spatial_join``) against the JAX
``GeoDataset``. Inputs are made from a NumPy seed; the JAX join runs
jitted on the CPU with one device (``geomesa.mesh.devices`` 1, as on the
one card), the port on the CPU with its kernels' plain versions. Every
comparison is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.cache import cells as jcells
from geomesa_tpu.kernels import join as jk
from geomesa_tpu.planning import join_exec as jje
from geomesa_tpu.utils import geometry as jgeo
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch import config
from geomesa_tpu_torch.cache import cells
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import join as kj
from geomesa_tpu_torch.planning import join_exec as je
from geomesa_tpu_torch.utils import geometry as geo

CPU = torch.device("cpu")
PRED_KW = {
    "bbox": {"dx": 0.25, "dy": 0.15},
    "dwithin": {"distance": 0.35},
    "dwithin_meters": {"distance": 30_000.0},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def one_device():
    """The JAX join on one device, as the port runs on one card."""
    jconfig.MESH_DEVICES.set(1)
    try:
        yield
    finally:
        jconfig.MESH_DEVICES.set(None)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clustered(rng, n, n_hot=12, spread=0.4, lo=-60, hi=60, centres=None):
    if centres is None:
        centres = (rng.uniform(lo, hi, n_hot), rng.uniform(lo / 2, hi / 2, n_hot))
    cx, cy = centres
    k = rng.integers(0, len(cx), n)
    return (np.clip(cx[k] + rng.normal(0, spread, n), -179, 179),
            np.clip(cy[k] + rng.normal(0, spread, n), -89, 89))


def _sides(seed, na=1500, nb=1200, n_hot=12, spread=0.4):
    """Two clustered point sets sharing their hot spots, so pairs match."""
    rng = np.random.default_rng(seed)
    centres = (rng.uniform(-60, 60, n_hot), rng.uniform(-30, 30, n_hot))
    ax, ay = _clustered(rng, na, spread=spread, centres=centres)
    bx, by = _clustered(rng, nb, spread=spread, centres=centres)
    return ax, ay, bx, by


def _pair(insert_a, insert_b, spec_a="name:String,*geom:Point",
          spec_b="tag:String,*geom:Point", n_shards=4):
    """(JAX, port) datasets with schemas a and b and the same rows."""
    out = []
    for ds in (JGeoDataset(n_shards=n_shards),
               GeoDataset(n_shards=n_shards, device="cpu")):
        ds.create_schema("a", spec_a)
        ds.create_schema("b", spec_b)
        for name, rows in (("a", insert_a), ("b", insert_b)):
            n = len(next(iter(rows.values())))
            ds.insert(name, rows, fids=[f"{name}{i}" for i in range(n)])
        ds.flush()
        out.append(ds)
    return out


def _points(x, y, attr, val):
    return {attr: [val(i) for i in range(len(x))], "geom": list(zip(x, y))}


@pytest.fixture(scope="module")
def pts():
    ax, ay, bx, by = _sides(7)
    j, p = _pair(_points(ax, ay, "name", lambda i: f"n{i % 5}"),
                 _points(bx, by, "tag", lambda i: f"t{i % 3}"))
    return j, p


def _brute(ds, predicate, left="a", right="b", lq="INCLUDE", rq="INCLUDE", **kw):
    p0, p1 = kj.pair_params(predicate, **kw)
    lfc, rfc = ds.query(left, lq), ds.query(right, rq)
    lx, ly = lfc.batch.columns["geom__x"], lfc.batch.columns["geom__y"]
    rx, ry = rfc.batch.columns["geom__x"], rfc.batch.columns["geom__y"]
    if predicate == kj.JOIN_DWITHIN_METERS:
        lux, luy, luz = kj.unit_vectors(lx, ly)
        rux, ruy, ruz = kj.unit_vectors(rx, ry)
        return kj.brute_force_pairs(lux, luy, rux, ruy, predicate, p0, p1, lz=luz, rz=ruz)
    return kj.brute_force_pairs(lx, ly, rx, ry, predicate, p0, p1)


def assert_stats_equal(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- kernel functions -------------------------------------------------------------------
def _edge_case_points(rng, n):
    """Uniform points, planted exact-distance and coincident pairs, and a
    NaN, as (lx, ly, rx, ry) f32."""
    lx = rng.uniform(-2, 2, n).astype(np.float32)
    ly = rng.uniform(-2, 2, n).astype(np.float32)
    rx = rng.uniform(-2, 2, n).astype(np.float32)
    ry = rng.uniform(-2, 2, n).astype(np.float32)
    rx[:8], ry[:8] = lx[:8] + np.float32(0.25), ly[:8]  # exactly 0.25 apart in x
    rx[8:12], ry[8:12] = lx[8:12], ly[8:12]
    lx[12] = np.nan
    return lx, ly, rx, ry


@pytest.mark.parametrize("predicate", sorted(PRED_KW))
def test_pair_mask_equals_jax(predicate):
    rng = np.random.default_rng(1)
    lx, ly, rx, ry = _edge_case_points(rng, 64)
    kw = {"bbox": {"dx": 0.25, "dy": 0.5}, "dwithin": {"distance": 0.25},
          "dwithin_meters": {"distance": 30_000.0}}[predicate]
    p0, p1 = kj.pair_params(predicate, **kw)
    assert (p0, p1) == jk.pair_params(predicate, **kw)
    z = {}
    if predicate == "dwithin_meters":
        for a, b in zip(kj.unit_vectors(lx, ly), jk.unit_vectors(lx, ly)):
            assert np.array_equal(a, b, equal_nan=True)
        lx, ly, lz = kj.unit_vectors(lx * 0.5, ly * 0.5)
        rx, ry, rz = kj.unit_vectors(rx * 0.5, ry * 0.5)
        z = {"lz": lz[:, None], "rz": rz[None, :]}
    args = (lx[:, None], ly[:, None], rx[None, :], ry[None, :])
    want = np.asarray(jk.pair_mask(*(jnp.asarray(a) for a in args), predicate, p0, p1, jnp,
                                   **{k: jnp.asarray(v) for k, v in z.items()}))
    got_np = kj.pair_mask(*args, predicate, p0, p1, np, **z)
    got_t = kj.pair_mask(*(t(a) for a in args), predicate, p0, p1, torch,
                         **{k: t(v) for k, v in z.items()})
    assert np.array_equal(got_np, want) and np.array_equal(got_t.numpy(), want)
    assert want.any() and not want.all()


def test_pair_mask_rejects_bad_arguments():
    for mod in (kj, jk):
        with pytest.raises(ValueError):
            mod.pair_params("bbox", dx=1.0)
        with pytest.raises(ValueError):
            mod.pair_params("dwithin")
        with pytest.raises(ValueError):
            mod.pair_params("nope", distance=1.0)
    with pytest.raises(ValueError):
        kj.pair_mask(t(np.zeros(2, np.float32)), t(np.zeros(2, np.float32)),
                     t(np.zeros(2, np.float32)), t(np.zeros(2, np.float32)),
                     "dwithin_meters", 1.0, 0.0, torch)


POLYS = [
    "POLYGON ((0 0, 8 0, 8 8, 0 8, 0 0), (3 3, 5 3, 5 5, 3 5, 3 3))",
    "POLYGON ((20 -20, 60 -20, 60 20, 20 20, 20 -20))",
    ("MULTIPOLYGON (((-30 -10, -25 -10, -25 -5, -30 -5, -30 -10)), "
     "((-20 -10, -15 -10, -15 -5, -20 -5, -20 -10)))"),
    "POLYGON ((100 40, 101 40, 101 41, 100 41, 100 40))",
    "POLYGON ((2 2, 30 4, 10 30, 2 2))",  # overlaps the donut and the square
]

EDGE_PTS = np.array([(0.0, 0.0), (8.0, 4.0), (3.0, 3.0), (5.0, 5.0), (40.0, 20.0),
                     (20.0, 0.0), (60.0, -20.0), (-25.0, -7.5), (4.0, 4.0), (40.0, 0.0),
                     (np.nan, 1.0), (1.0, np.nan), (6.0, 6.0)])


def _poly_points(seed=33, n=400):
    rng = np.random.default_rng(seed)
    px = np.concatenate([rng.uniform(-40, 70, n), EDGE_PTS[:, 0]])
    py = np.concatenate([rng.uniform(-30, 45, n), EDGE_PTS[:, 1]])
    return px, py


def _both_geoms(wkts):
    return [geo.parse_wkt(w) for w in wkts], [jgeo.parse_wkt(w) for w in wkts]


@pytest.mark.parametrize("pad", [False, True], ids=["exact", "padded"])
def test_polygon_tables_equal_jax(pad):
    pg, jg = _both_geoms(POLYS)
    kw = {"pad_edges": 128, "pad_parts": 8, "pad_rows": 8} if pad else {}
    got, want = kj.polygon_tables(pg, **kw), jk.polygon_tables(jg, **kw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v) and np.asarray(got[k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("predicate", ["pip", "poly_bbox"])
def test_polygon_mask_and_verdict_plain_equal_jax(predicate):
    pg, jg = _both_geoms(POLYS)
    px, py = _poly_points()
    tabs = kj.polygon_tables(pg, pad_edges=64, pad_parts=8, pad_rows=8)
    jtabs = jk.polygon_tables(jg, pad_edges=64, pad_parts=8, pad_rows=8)
    px32, py32 = px.astype(np.float32), py.astype(np.float32)
    want = np.asarray(jk.polygon_mask(jnp.asarray(px32), jnp.asarray(py32), jtabs,
                                      predicate, jnp))
    assert np.array_equal(kj.polygon_mask(px32, py32, tabs, predicate, np), want)
    got = kj.polygon_verdict(t(px32), t(py32), kj.table_tensors(tabs, CPU), predicate)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    # the jitted polygon kernel of the reference, at its pow2 buckets
    go = jje._poly_kernel(len(px32), 64, 8, 8, predicate)
    jv = np.asarray(go(px32, py32, jtabs["x1"], jtabs["y1"], jtabs["x2"], jtabs["y2"],
                       jtabs["part_id"], jtabs["part_row"], jtabs["boxes"]))
    assert np.array_equal(jv, want)
    assert want[:, :len(POLYS)].any() and not want[:, len(POLYS):].any()


def test_table_tensors_refuse_ungrouped_parts():
    pg, _ = _both_geoms(POLYS[:3])
    tabs = kj.polygon_tables(pg)
    tabs["part_id"] = tabs["part_id"][::-1].copy()
    with pytest.raises(ValueError, match="grouped"):
        kj.table_tensors(tabs, CPU)


def _edges(wkts):
    pg, jg = _both_geoms(wkts)
    flat = lambda gs, mod: mod.MultiPolygon(tuple(  # noqa: E731
        q for g in gs for q in (g.polygons if isinstance(g, mod.MultiPolygon) else (g,))))
    pe = geo.polygon_edge_buffers(flat(pg, geo))
    je_ = jgeo.polygon_edge_buffers(flat(jg, jgeo))
    f32 = lambda e: {k: (v.astype(np.float32) if k in ("x1", "y1", "x2", "y2") else v)  # noqa: E731
                     for k, v in e.items()}
    return f32(pe), f32(je_)


def test_crossing_matrix_and_pip_assign_equal_jax():
    pe, jedges = _edges(POLYS)
    for k in ("x1", "y1", "x2", "y2", "poly_id", "n_polys"):
        assert np.array_equal(pe[k], jedges[k])
    px, py = _poly_points(5)
    px32, py32 = px.astype(np.float32), py.astype(np.float32)
    args = (px32, py32, pe["x1"], pe["y1"], pe["x2"], pe["y2"])
    want = np.asarray(jk.crossing_matrix(*(jnp.asarray(a) for a in args), jnp))
    assert np.array_equal(kj.crossing_matrix(*args, np), want)
    assert np.array_equal(kj.crossing_matrix(*(t(a) for a in args), torch).numpy(), want)
    mask = np.random.default_rng(2).random(len(px)) < 0.8
    want_a = np.asarray(jk.pip_assign(jnp.asarray(px32), jnp.asarray(py32), jnp.asarray(mask),
                                      jedges, jnp))
    got_np = kj.pip_assign(px32, py32, mask, pe, np)
    got_t = kj.pip_assign(t(px32), t(py32), t(mask), kj.edge_tensors(pe, CPU), torch)
    assert got_t.dtype == torch.int32
    assert np.array_equal(got_np, want_a) and np.array_equal(got_t.numpy(), want_a)
    # overlapping polygons: the lowest id wins; unmasked and NaN points get -1
    assert (want_a == 0).any() and (want_a == 5).any() and (want_a == -1).any()
    assert (want_a[~mask] == -1).all()
    w = np.random.default_rng(3).random(len(px)).astype(np.float32)
    want_c = np.asarray(jk.pip_counts(jnp.asarray(px32), jnp.asarray(py32), jnp.asarray(mask),
                                      jedges, jnp.asarray(w), jnp))
    assert np.array_equal(kj.pip_counts(px32, py32, mask, pe, w, np), want_c)
    got_c = kj.pip_counts(t(px32), t(py32), t(mask), kj.edge_tensors(pe, CPU), t(w), torch)
    assert np.allclose(got_c.numpy(), want_c, rtol=1e-6)


def test_edge_tensors_refuse_ungrouped_edges():
    pe, _ = _edges(POLYS[:2])
    rev = {k: (v[::-1].copy() if isinstance(v, np.ndarray) else v) for k, v in pe.items()}
    with pytest.raises(ValueError, match="grouped"):
        kj.edge_tensors(rev, CPU)
    et = kj.edge_tensors(pe, CPU)
    assert et["grouped"] and et["n_edges"] == len(pe["x1"]) and et["n_polys"] == 2


@pytest.mark.parametrize("level", [3, 5, 7])
def test_classify_cells_and_cells_equal_jax(level):
    px, py = _poly_points(9, n=3000)
    ok = np.isfinite(px) & np.isfinite(py)
    ix, iy = cells.point_cells(px[ok], py[ok], level)
    jix, jiy = jcells.point_cells(px[ok], py[ok], level)
    assert np.array_equal(ix, jix) and np.array_equal(iy, jiy)
    boxes = cells.cell_boxes(level, ix, iy)
    assert np.array_equal(boxes, jcells.cell_boxes(level, ix, iy))
    n = 1 << level
    for cx, cy in ((0, 0), (n - 1, n - 1), (3, n // 2)):
        assert cells.cell_box(level, cx, cy) == jcells.cell_box(level, cx, cy)
        assert cells.cell_prefix(level, (cx, cy)) == jcells.cell_prefix(level, (cx, cy))
    for w in POLYS:
        g, jg = geo.parse_wkt(w), jgeo.parse_wkt(w)
        codes = kj.classify_cells(boxes, g, cells.CLASSIFY_MARGIN)
        assert np.array_equal(codes, jk.classify_cells(boxes, jg, jcells.CLASSIFY_MARGIN))
    assert cells.CLASSIFY_MARGIN == jcells.CLASSIFY_MARGIN


def _tile_operands(seed, predicate, C=5, Bp=16, Pp=8):
    rng = np.random.default_rng(seed)
    lx, ly = rng.uniform(-1, 1, (C, Bp)).astype(np.float32), rng.uniform(-1, 1, (C, Bp)).astype(np.float32)
    rx, ry = rng.uniform(-1, 1, (C, Pp)).astype(np.float32), rng.uniform(-1, 1, (C, Pp)).astype(np.float32)
    rx[:, 0], ry[:, 0] = lx[:, 0] + np.float32(0.25), ly[:, 0]
    lval = rng.integers(0, Bp + 1, C).astype(np.int32)
    rval = rng.integers(0, Pp + 1, C).astype(np.int32)
    lval[0], rval[0] = Bp, Pp
    ops = [lx, ly, rx, ry]
    if predicate == "dwithin_meters":
        lu = kj.unit_vectors(lx * 10, ly * 10)
        ru = kj.unit_vectors(rx * 10, ry * 10)
        ops = [lu[0], lu[1], ru[0], ru[1], lu[2], ru[2]]
    return ops, lval, rval


@pytest.mark.parametrize("predicate", sorted(PRED_KW))
@pytest.mark.parametrize("want_mask", [True, False], ids=["mask", "counts"])
def test_pair_tiles_plain_equals_jax_kernel(predicate, want_mask):
    ops, lval, rval = _tile_operands(4, predicate)
    kw = {"bbox": {"dx": 0.25, "dy": 0.3}, "dwithin": {"distance": 0.25},
          "dwithin_meters": {"distance": 120_000.0}}[predicate]
    p0, p1 = kj.pair_params(predicate, **kw)
    C, Bp = ops[0].shape
    Pp = ops[2].shape[1]
    go = jje._pairs_kernel("join.pairs", Bp, Pp, C, predicate)
    if predicate == "dwithin_meters":
        jm, jc = go(ops[0], ops[1], ops[4], ops[2], ops[3], ops[5], lval, rval, p0, p1)
        z = {"lzb": t(ops[4]), "rzb": t(ops[5])}
    else:
        jm, jc = go(*ops, lval, rval, p0, p1)
        z = {}
    m, c = kj.pair_tiles(*(t(a) for a in ops[:4]), t(lval), t(rval), predicate, p0, p1,
                         want_mask=want_mask, **z)
    assert c.dtype == torch.int32 and np.array_equal(c.numpy(), np.asarray(jc))
    if want_mask:
        assert np.array_equal(m.numpy(), np.asarray(jm))
    else:
        assert m is None
    assert np.asarray(jc).sum() > 0


@pytest.mark.parametrize("predicate", sorted(PRED_KW))
def test_pair_flat_plain_equals_jax_kernel(predicate):
    ops, _, _ = _tile_operands(5, predicate, C=1, Bp=64, Pp=64)
    flat = [a.reshape(-1) for a in ops]
    kp, kvalid = 64, 41
    flat = [a[:kp] for a in flat]
    kw = {"bbox": {"dx": 0.5, "dy": 0.5}, "dwithin": {"distance": 0.7},
          "dwithin_meters": {"distance": 300_000.0}}[predicate]
    p0, p1 = kj.pair_params(predicate, **kw)
    go = jje._brute_kernel(kp, predicate)
    if predicate == "dwithin_meters":
        jm, jn = go(flat[0], flat[1], flat[4], flat[2], flat[3], flat[5], np.int32(kvalid), p0, p1)
        z = {"lzv": t(flat[4]), "rzv": t(flat[5])}
    else:
        jm, jn = go(*flat[:4], np.int32(kvalid), p0, p1)
        z = {}
    m, n = kj.pair_flat(*(t(a) for a in flat[:4]), kvalid, predicate, p0, p1, **z)
    assert np.array_equal(m.numpy(), np.asarray(jm)) and int(n) == int(jn) > 0
    assert not m[kvalid:].any()


def test_launch_counters_count_kernels_only():
    kj.reset_launches()
    ops, lval, rval = _tile_operands(6, "dwithin")
    kj.pair_tiles(*(t(a) for a in ops[:4]), t(lval), t(rval), "dwithin", 0.1, 0.0)
    assert kj.launches == {"pair_tiles": 0, "pair_flat": 0, "polygon_verdict": 0,
                           "pip_assign": 0}


# -- plans ------------------------------------------------------------------------------------
def _plans_equal(got, want):
    assert got.predicate == want.predicate and (got.p0, got.p1) == (want.p0, want.p1)
    assert_stats_equal(got.stats, want.stats)
    assert len(got.sections) == len(want.sections)
    for a, b in zip(got.sections, want.sections):
        assert (a.strategy, a.site, a.Bp, a.Pp) == (b.strategy, b.site, b.Bp, b.Pp)
        for k in ("l_rows", "r_rows", "l_valid", "r_valid"):
            assert np.array_equal(getattr(a, k), getattr(b, k)) \
                and getattr(a, k).dtype == getattr(b, k).dtype, k
    for k in ("brute_l", "brute_r"):
        ga, wb = getattr(got, k), getattr(want, k)
        assert (ga is None) == (wb is None) and (ga is None or np.array_equal(ga, wb)), k
    assert (got.n_tiles, got.n_brute, got.Bp, got.Pp) == \
        (want.n_tiles, want.n_brute, want.Bp, want.Pp)


def _shaped(rng, shape, n):
    if shape == "dense":
        return _clustered(rng, n, n_hot=4, spread=0.25)
    if shape == "sparse":
        return rng.uniform(-170, 170, n // 4), rng.uniform(-85, 85, n // 4)
    if shape == "skewed":
        return _clustered(rng, n, n_hot=3, spread=0.15)
    dx, dy = _clustered(rng, n // 2, n_hot=4, spread=0.25)
    sx, sy = rng.uniform(-170, 170, n // 4), rng.uniform(-85, 85, n // 4)
    return np.concatenate([dx, sx]), np.concatenate([dy, sy])


def _shaped_sides(shape, seed):
    rng = np.random.default_rng(seed)
    na, nb = (1200, 90) if shape == "skewed" else (900, 800)
    ax, ay = _shaped(rng, shape, na)
    bx, by = _shaped(rng, shape, nb)
    if shape in ("skewed", "mixed"):
        # a heavy left hot spot against a few right rows: split cells
        hx = 12.345 + rng.normal(0, 0.02, 500)
        hy = 7.89 + rng.normal(0, 0.02, 500)
        ax, ay = np.concatenate([ax, hx]), np.concatenate([ay, hy])
        bx = np.concatenate([bx, np.full(4, 12.345)])
        by = np.concatenate([by, np.full(4, 7.89)])
    return ax, ay, bx, by


@pytest.mark.parametrize("shape", ["dense", "sparse", "skewed", "mixed"])
@pytest.mark.parametrize("adaptive", [None, False], ids=["adaptive", "single"])
@pytest.mark.parametrize("level", [None, 6], ids=["auto", "level6"])
def test_co_partition_equals_jax(shape, adaptive, level):
    ax, ay, bx, by = _shaped_sides(shape, {"dense": 21, "sparse": 22, "skewed": 23,
                                           "mixed": 24}[shape])
    for predicate in sorted(PRED_KW):
        kw = PRED_KW[predicate]
        p0, p1 = kj.pair_params(predicate, **kw)
        rx_, ry_, wrap = je.join_reach(predicate, p0, p1, kw.get("distance"), by)
        got = je.co_partition(ax, ay, bx, by, predicate, rx_, ry_, level=level,
                              p0=p0, p1=p1, wrap_x=wrap, adaptive=adaptive)
        want = jje.co_partition(ax, ay, bx, by, predicate, rx_, ry_, level=level,
                                p0=p0, p1=p1, wrap_x=wrap, adaptive=adaptive)
        _plans_equal(got, want)
        if adaptive is False:
            assert list(got.stats.strategy_cells) in ([], ["pairwise"])
    if shape == "mixed" and adaptive is None and level is None:
        assert {"brute", "pairwise", "split.l"} <= set(got.stats.strategy_cells)


@pytest.mark.parametrize("tile,brute,skew", [("16", "64", "4"), ("128", "0", "16")])
def test_co_partition_knobs_equal_jax(tile, brute, skew):
    ax, ay, bx, by = _shaped_sides("mixed", 25)
    p0, p1 = kj.pair_params("dwithin", distance=0.3)
    with config.JOIN_TILE.scoped(tile), config.JOIN_ADAPTIVE_BRUTE_PAIRS.scoped(brute), \
            config.JOIN_ADAPTIVE_SKEW_RATIO.scoped(skew), config.JOIN_MAX_LEVEL.scoped("9"), \
            jconfig.JOIN_TILE.scoped(tile), jconfig.JOIN_ADAPTIVE_BRUTE_PAIRS.scoped(brute), \
            jconfig.JOIN_ADAPTIVE_SKEW_RATIO.scoped(skew), jconfig.JOIN_MAX_LEVEL.scoped("9"):
        got = je.co_partition(ax, ay, bx, by, "dwithin", 0.3, 0.3, p0=p0, p1=p1)
        want = jje.co_partition(ax, ay, bx, by, "dwithin", 0.3, 0.3, p0=p0, p1=p1)
    _plans_equal(got, want)
    with config.JOIN_ADAPTIVE.scoped("false"), jconfig.JOIN_ADAPTIVE.scoped("false"):
        _plans_equal(je.co_partition(ax, ay, bx, by, "dwithin", 0.3, 0.3, p0=p0, p1=p1),
                     jje.co_partition(ax, ay, bx, by, "dwithin", 0.3, 0.3, p0=p0, p1=p1))


def test_level_and_reach_equal_jax():
    rng = np.random.default_rng(8)
    for n_l, n_r, reach in ((10, 10, 0.0), (100_000, 50, 0.001), (5_000, 5_000, 3.0)):
        for bounds in (None, (-74.26, 40.49, -73.70, 40.92), (-180, -90, 180, 90)):
            assert je.choose_level(n_l, n_r, reach, bounds) == \
                jje.choose_level(n_l, n_r, reach, bounds)
    lat = np.array([0.0, 40.0, 80.0, 89.9, -89.99])
    for d in (100.0, 30_000.0, 2_000_000.0, 2.1e7):
        gx, gy = je.meters_reach_deg(d, lat)
        wx, wy = jje.meters_reach_deg(d, lat)
        assert np.array_equal(gx, wx) and gy == wy
    bnds = np.abs(rng.normal(0, 1, (7, 4))).cumsum(axis=1)
    assert je._polygon_level(10, bnds) == jje._polygon_level(10, bnds)
    assert je.SECTION_ORDER == jje.SECTION_ORDER
    for n in (0, 1, 5, 64, 65):
        assert je._pow2(n) == jje._pow2(n)


# -- joins ----------------------------------------------------------------------------------
@pytest.mark.parametrize("predicate", sorted(PRED_KW))
@pytest.mark.parametrize("adaptive", [None, False], ids=["adaptive", "single"])
def test_run_join_equals_jax_and_brute_force(predicate, adaptive):
    ax, ay, bx, by = _shaped_sides("mixed", 26)
    kw = PRED_KW[predicate]
    pairs, total, st = je.run_join(ax, ay, bx, by, predicate, device="cpu",
                                   adaptive=adaptive, **kw)
    jp, jt, jst = jje.run_join(ax, ay, bx, by, predicate, adaptive=adaptive, **kw)
    assert np.array_equal(pairs, jp) and total == jt == len(pairs) > 0
    assert_stats_equal(st, jst)
    p0, p1 = kj.pair_params(predicate, **kw)
    if predicate == "dwithin_meters":
        lu, ru = kj.unit_vectors(ax, ay), kj.unit_vectors(bx, by)
        ref = kj.brute_force_pairs(lu[0], lu[1], ru[0], ru[1], predicate, p0, p1,
                                   lz=lu[2], rz=ru[2])
    else:
        ref = kj.brute_force_pairs(ax, ay, bx, by, predicate, p0, p1)
    assert np.array_equal(pairs, ref)
    none, count, _ = je.run_join(ax, ay, bx, by, predicate, device="cpu",
                                 want_pairs=False, adaptive=adaptive, **kw)
    assert none is None and count == total


def test_run_join_dwithin_meters_antimeridian_and_pole():
    def side(seed, n=400):
        r = np.random.default_rng(seed)
        lon = np.concatenate([r.uniform(179.0, 180.0, n // 4), r.uniform(-180.0, -179.0, n // 4),
                              r.uniform(-170.0, 170.0, n // 4),
                              r.uniform(-180.0, 180.0, n - 3 * (n // 4))])
        lat = np.concatenate([r.uniform(55.0, 60.0, n // 4), r.uniform(55.0, 60.0, n // 4),
                              r.uniform(-45.0, 45.0, n // 4), r.uniform(88.5, 90.0, n - 3 * (n // 4))])
        return lon, lat

    ax, ay = side(1)
    bx, by = side(2)
    for d in (20_000.0, 150_000.0):
        pairs, total, st = je.run_join(ax, ay, bx, by, "dwithin_meters", distance=d, device="cpu")
        jp, jt, jst = jje.run_join(ax, ay, bx, by, "dwithin_meters", distance=d)
        assert np.array_equal(pairs, jp) and total == jt
        assert_stats_equal(st, jst)
        assert (np.abs(ax[pairs[:, 0]] - bx[pairs[:, 1]]) > 300).any()


def test_run_join_inclusive_edges_and_strip_pairs():
    d = 0.25
    lx = np.array([11.25 - 0.01, 0.0, -45.0, 170.0])
    ly = np.array([5.0, 0.0, -22.5, 80.0])
    rx = np.array([11.25 + 0.01, d, -45.0 + d, 10.0])
    ry = np.array([5.0, 0.0, -22.5, 10.0])
    pairs, total, st = je.run_join(lx, ly, rx, ry, "dwithin", distance=d, device="cpu")
    jp, jt, jst = jje.run_join(lx, ly, rx, ry, "dwithin", distance=d)
    assert np.array_equal(pairs, jp) and total == jt >= 3 and st.strip_entries > 0
    assert_stats_equal(st, jst)
    dm = 10_000.0
    ddeg = np.degrees(dm / kj.EARTH_RADIUS_M)
    args = (np.array([10.0]), np.array([0.0]), np.array([10.0 + ddeg, 10.0 + 3 * ddeg]),
            np.array([0.0, 0.0]))
    pairs, total, _ = je.run_join(*args, "dwithin_meters", distance=dm, device="cpu")
    jp, jt, _ = jje.run_join(*args, "dwithin_meters", distance=dm)
    assert np.array_equal(pairs, jp) and total == jt <= 1


def test_run_join_empty_and_disjoint_sides():
    rng = np.random.default_rng(3)
    ax, ay = rng.uniform(-60, -40, 300), rng.uniform(-30, -10, 300)
    bx, by = rng.uniform(40, 60, 300), rng.uniform(10, 30, 300)
    e = np.zeros(0)
    for args in ((ax, ay, bx, by), (e, e, bx, by), (ax, ay, e, e)):
        for want_pairs in (True, False):
            pairs, total, st = je.run_join(*args, "dwithin", distance=0.5, device="cpu",
                                           want_pairs=want_pairs)
            jp, jt, jst = jje.run_join(*args, "dwithin", distance=0.5, want_pairs=want_pairs)
            assert total == jt == 0 and st.cells_joint == 0
            assert (pairs is None) == (jp is None) and (pairs is None or len(pairs) == 0)
            assert_stats_equal(st, jst)


@pytest.mark.parametrize("predicate", ["pip", "poly_bbox"])
@pytest.mark.parametrize("level", [None, 3, 8], ids=["auto", "level3", "level8"])
def test_run_polygon_join_equals_jax_and_brute_force(predicate, level):
    pg, jg = _both_geoms(POLYS)
    px, py = _poly_points(10, n=3000)
    pairs, total, st = je.run_polygon_join(px, py, pg, predicate, level=level, device="cpu")
    jp, jt, jst = jje.run_polygon_join(px, py, jg, predicate, level=level)
    assert np.array_equal(pairs, jp) and total == jt == len(pairs) > 0
    assert_stats_equal(st, jst)
    assert np.array_equal(pairs, kj.polygon_brute_force(px, py, pg, predicate))
    _, count, st2 = je.run_polygon_join(px, py, pg, predicate, level=level, device="cpu",
                                        want_pairs=False)
    assert count == total
    if level is None:
        assert st.wholesale_pairs > 0 and st.strategy_cells["interior"] > 0
        assert 0 < st.candidate_pairs < len(px) * len(pg)


def test_run_polygon_join_empty_sides():
    pg, jg = _both_geoms(POLYS)
    e = np.zeros(0)
    for args in ((e, e, pg, jg), (np.array([1.0]), np.array([1.0]), [], [])):
        pairs, total, st = je.run_polygon_join(args[0], args[1], args[2], "pip", device="cpu")
        jp, jt, jst = jje.run_polygon_join(args[0], args[1], args[3], "pip")
        assert np.array_equal(pairs, jp) and total == jt == 0
        assert_stats_equal(st, jst)


# -- GeoDataset calls --------------------------------------------------------------------------------
@pytest.mark.parametrize("predicate", sorted(PRED_KW))
def test_join_and_join_count_equal_jax(pts, predicate):
    j, p = pts
    kw = PRED_KW[predicate]
    got, want = p.join("a", "b", predicate=predicate, **kw), j.join("a", "b", predicate=predicate, **kw)
    assert np.array_equal(got.pairs, want.pairs) and got.count == want.count > 0
    assert np.array_equal(got.pairs, _brute(p, predicate, **kw))
    assert_stats_equal(got.stats, want.stats)
    assert p.join_count("a", "b", predicate=predicate, **kw) == want.count
    assert got.stats.candidate_fraction < 0.2 and got.stats.cells_joint > 0


def _explain_lines(text):
    """The explain text without its timing line."""
    return [ln for ln in text.splitlines() if not ln.strip().startswith(("pairwise ms", "kernel ms"))]


@pytest.mark.parametrize("predicate", sorted(PRED_KW))
@pytest.mark.parametrize("analyze", [False, True])
def test_explain_join_equals_jax(pts, predicate, analyze):
    j, p = pts
    kw = PRED_KW[predicate]
    got = p.explain_join("a", "b", predicate=predicate, analyze=analyze, **kw)
    want = j.explain_join("a", "b", predicate=predicate, analyze=analyze, **kw)
    assert _explain_lines(got) == _explain_lines(want)
    for marker in ("Join", "candidate pairs", "boundary-strip fraction",
                   "co-partition level", "Adaptive", "statistics read"):
        assert marker in got
    if analyze:
        n = p.join_count("a", "b", predicate=predicate, **kw)
        assert f"matched (analyze): {n}" in got and "pairwise ms" in got


def test_join_spatial_filtered_sides_and_batches(pts):
    j, p = pts
    lq, rq = "BBOX(geom, -60, -30, 20, 30)", "tag = 't1'"
    got = p.join_spatial("a", "b", predicate="bbox", dx=0.3, dy=0.3, left_query=lq,
                         right_query=rq)
    want = j.join_spatial("a", "b", predicate="bbox", dx=0.3, dy=0.3, left_query=lq,
                          right_query=rq)
    assert np.array_equal(got.pairs, want.pairs) and got.count == want.count > 0
    assert np.array_equal(got.pairs, _brute(p, "bbox", lq=lq, rq=rq, dx=0.3, dy=0.3))
    gb, wb = list(got.batches(batch_rows=97)), list(want.batches(batch_rows=97))
    assert [b.n for b in gb] == [b.n for b in wb] and all(b.n <= 97 for b in gb)
    for a, b in zip(gb, wb):
        assert "right.geom__x" in a.columns and "geom__x" in a.columns
        for k in ("__fid__", "geom__x", "geom__y", "name", "right.__fid__", "right.geom__x",
                  "right.geom__y", "right.tag"):
            assert np.array_equal(a.columns[k], b.columns[k]), k
    assert sum(b.n for b in got) == got.count
    assert got.to_batch().n == got.count
    with config.JOIN_BATCH_ROWS.scoped("50"), jconfig.JOIN_BATCH_ROWS.scoped("50"):
        assert [b.n for b in got.batches()] == [b.n for b in want.batches()]
    res = p._join_run("a", "b", "bbox", None, 0.3, 0.3, lq, rq, None, want_pairs=False)
    with pytest.raises(ValueError, match="no pairs"):
        next(res.batches())


def test_equi_join_equals_jax():
    rng = np.random.default_rng(12)
    n = 300
    a = {"name": [f"k{i % 7}" for i in range(n)], "v": rng.integers(0, 5, n).astype(np.int32),
         "geom": list(zip(rng.uniform(-10, 10, n), rng.uniform(-10, 10, n)))}
    b = {"tag": [f"k{i % 4}" for i in range(50)], "w": rng.integers(0, 5, 50).astype(np.int32),
         "geom": list(zip(rng.uniform(-10, 10, 50), rng.uniform(-10, 10, 50)))}
    j, p = _pair(a, b, "name:String,v:Integer,*geom:Point", "tag:String,w:Integer,*geom:Point")
    for la, ra in (("name", "tag"), ("v", "w")):
        got, want = p.join("a", "b", la, ra), j.join("a", "b", la, ra)
        assert got.n == want.n > 0
        for k in ("__fid__", "name", "v", "geom__x", "geom__y", "right.__fid__", "right.tag",
                  "right.w", "right.geom__x", "right.geom__y"):
            assert np.array_equal(got.columns[k], want.columns[k]), k
    got = p.join("a", "b", "name", "tag", left_query="v = 1", right_query="w < 3")
    want = j.join("a", "b", "name", "tag", left_query="v = 1", right_query="w < 3")
    assert got.n == want.n > 0
    assert p.join("a", "b", "name", "tag", left_query="v > 99").n == 0
    for ds in (j, p):
        with pytest.raises(ValueError, match="types differ"):
            ds.join("a", "b", "name", "w")


def test_join_rejects_what_the_reference_rejects():
    out = []
    for ds in (JGeoDataset(n_shards=4), GeoDataset(n_shards=4, device="cpu")):
        ds.create_schema("pt", "*geom:Point")
        ds.create_schema("ln", "*geom:LineString")
        ds.create_schema("pg", "*geom:Polygon")
        cases = [
            lambda: ds.join("pt", "ln", predicate="dwithin", distance=1.0),
            lambda: ds.join("pt", "pt", predicate="dwithin"),
            lambda: ds.join("pt", "pt", predicate="nope", distance=1.0),
            lambda: ds.join("pt", "pt"),
            lambda: ds.join("pt", "pt", predicate="bbox", dx=1.0),
            lambda: ds.join("pt", "pt", predicate="pip"),
            lambda: ds.join("pg", "pg", predicate="pip"),
            lambda: ds.join_count("ln", "pt", predicate="dwithin_meters", distance=5.0),
        ]
        msgs = []
        for case in cases:
            with pytest.raises(ValueError) as e:
                case()
            msgs.append(str(e.value))
        out.append(msgs)
    assert out[0] == out[1]
    assert "POINT" in out[0][0] and "POLYGON" in out[0][5]


@pytest.fixture(scope="module")
def polys():
    px, py = _poly_points(33, n=2000)
    ok = np.isfinite(px) & np.isfinite(py)
    return _pair(_points(px[ok], py[ok], "name", lambda i: "p"),
                 {"kind": [f"k{i}" for i in range(len(POLYS))], "geom": np.array(POLYS, object)},
                 "name:String,*geom:Point", "kind:String,*geom:Polygon")


@pytest.mark.parametrize("predicate", ["pip", "poly_bbox"])
def test_polygon_join_equals_jax(polys, predicate):
    j, p = polys
    got, want = p.join("a", "b", predicate=predicate), j.join("a", "b", predicate=predicate)
    assert np.array_equal(got.pairs, want.pairs) and got.count == want.count > 0
    assert_stats_equal(got.stats, want.stats)
    fc = p.query("a", "INCLUDE")
    geoms = [geo.parse_wkt(str(w)) for w in p.query("b", "INCLUDE").batch.columns["geom__wkt"]]
    ref = kj.polygon_brute_force(fc.batch.columns["geom__x"], fc.batch.columns["geom__y"],
                                 geoms, predicate)
    assert np.array_equal(got.pairs, ref)
    assert p.join_count("a", "b", predicate=predicate) == want.count
    b = got.to_batch()
    assert b.n == got.count and "right.geom__wkt" in b.columns and "right.kind" in b.columns
    for analyze in (False, True):
        e1 = p.explain_join("a", "b", predicate=predicate, analyze=analyze)
        e2 = j.explain_join("a", "b", predicate=predicate, analyze=analyze)
        assert _explain_lines(e1) == _explain_lines(e2)
        assert "wholesale" in e1 and "classify_cells" in e1


def test_join_count_with_a_partitioned_right_store(tmp_path):
    """A count-only join over a partitioned right store streams the right
    side through the lake window pushdown (``dwithin`` / ``bbox``) or
    materializes it (``dwithin_meters``) in both packages. The counts are
    equal, and equal to the materialized join."""
    rng = np.random.default_rng(44)
    n = 4000
    cx, cy = rng.uniform(-115, -75, 6), rng.uniform(28, 47, 6)
    k = rng.integers(0, 6, n)
    side = {"name": [f"r{i % 9}" for i in range(n)],
            "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"),
                                n).astype("datetime64[ms]"),
            "geom__x": np.clip(cx[k] + rng.normal(0, 0.25, n), -120, -70),
            "geom__y": np.clip(cy[k] + rng.normal(0, 0.25, n), 25, 50)}
    k = rng.integers(0, 4, 300)
    left = {"name": ["p"] * 300,
            "geom": list(zip(np.clip(cx[k] + rng.normal(0, 0.2, 300), -120, -70),
                             np.clip(cy[k] + rng.normal(0, 0.2, 300), 25, 50)))}
    dss = []
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("t", "name:String,dtg:Date,*geom:Point;geomesa.partition='time'")
        st = ds._store("t")
        st._spill_dir = str(tmp_path / type(ds).__module__)
        st.max_resident = 1
        ds.insert("t", side)
        ds.create_schema("pts", "name:String,*geom:Point")
        ds.insert("pts", left)
        ds.flush()
        dss.append(ds)
    j, p = dss
    for predicate, kw in (("dwithin", {"distance": 0.1}), ("bbox", {"dx": 0.1, "dy": 0.05}),
                          ("dwithin_meters", {"distance": 9000.0})):
        got = p.join_count("pts", "t", predicate=predicate, **kw)
        full = p.join("pts", "t", predicate=predicate, **kw)
        assert got == j.join_count("pts", "t", predicate=predicate, **kw) == full.count > 0
        assert np.array_equal(full.pairs, j.join("pts", "t", predicate=predicate, **kw).pairs)


@pytest.fixture(scope="module")
def pushdown_pair(tmp_path_factory):
    """(JAX, port, left xy, right xy): a flat left side of 400 points and a
    partitioned right store of 6,000 clustered points in 256-row row
    groups, every partition spilled."""
    rng = np.random.default_rng(45)
    n = 6000
    cx, cy = rng.uniform(-115, -75, 8), rng.uniform(28, 47, 8)
    k = rng.integers(0, 8, n)
    side = {"name": [f"r{i % 9}" for i in range(n)],
            "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"),
                                n).astype("datetime64[ms]"),
            "geom__x": np.clip(cx[k] + rng.normal(0, 0.3, n), -120, -70),
            "geom__y": np.clip(cy[k] + rng.normal(0, 0.3, n), 25, 50)}
    k = rng.integers(0, 5, 400)
    lx = np.clip(cx[k] + rng.normal(0, 0.3, 400), -120, -70)
    ly = np.clip(cy[k] + rng.normal(0, 0.3, 400), 25, 50)
    dss = []
    with config.LAKE_ROWGROUP_ROWS.scoped(256), jconfig.LAKE_ROWGROUP_ROWS.scoped(256):
        for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
            ds.create_schema("t", "name:String,dtg:Date,*geom:Point;geomesa.partition='time'")
            st = ds._store("t")
            st._spill_dir = str(tmp_path_factory.mktemp(type(ds).__module__.split(".")[0]))
            st.max_resident = 1
            ds.insert("t", side)
            ds.create_schema("pts", "name:String,*geom:Point")
            ds.insert("pts", {"name": ["p"] * 400, "geom__x": lx, "geom__y": ly})
            ds.flush()
            st.spill_all()
            dss.append(ds)
    return dss[0], dss[1], (lx, ly), (side["geom__x"], side["geom__y"])


@pytest.mark.parametrize("residency", ["64", "0"])
@pytest.mark.parametrize("predicate", ["dwithin", "bbox"])
def test_join_pushdown_count_and_stats_equal_jax(pushdown_pair, predicate, residency):
    """The window-pushdown count: the count equals the JAX package's and a
    NumPy brute force, and ``JoinStats`` equals the JAX package's, the
    ``pushdown`` account (residency hits and saved bytes) included."""
    j, p, (lx, ly), (rx, ry) = pushdown_pair
    kw = {"dwithin": {"distance": 0.08}, "bbox": {"dx": 0.06, "dy": 0.04}}[predicate]
    j._plan_cache_clear("t")  # the JAX side plans each chunk afresh
    with config.JOIN_PUSHDOWN_CELLS.scoped(16), jconfig.JOIN_PUSHDOWN_CELLS.scoped(16), \
            config.JOIN_PUSHDOWN_RESIDENCY_MB.scoped(residency), \
            jconfig.JOIN_PUSHDOWN_RESIDENCY_MB.scoped(residency):
        pr = p._join_run("pts", "t", predicate, kw.get("distance"), kw.get("dx"),
                         kw.get("dy"), "INCLUDE", "INCLUDE", None, want_pairs=False)
        jr = j._join_run("pts", "t", predicate, kw.get("distance"), kw.get("dx"),
                         kw.get("dy"), "INCLUDE", "INCLUDE", None, want_pairs=False)
    p0, p1 = kj.pair_params(predicate, **kw)
    brute = len(kj.brute_force_pairs(lx, ly, rx, ry, predicate, p0, p1))
    assert pr.count == jr.count == brute > 0
    assert dataclasses.asdict(pr.stats) == dataclasses.asdict(jr.stats)
    pd = pr.stats.pushdown
    assert pd["chunks"] > 1 and 0 < pd["groups_loaded"]
    assert pd["bytes_side"] > 0 and pd["groups_side"] > 0
    assert (pd["residency_hits"] > 0) == (residency != "0")
    with config.JOIN_PUSHDOWN.scoped(False):
        off = p._join_run("pts", "t", predicate, kw.get("distance"), kw.get("dx"),
                          kw.get("dy"), "INCLUDE", "INCLUDE", None, want_pairs=False)
    assert off.count == pr.count and off.stats.pushdown == {}


# -- spatial_join ------------------------------------------------------------------------------
BOROUGHS = [
    "POLYGON ((-100 30, -90 30, -90 40, -100 40, -100 30), (-97 33, -93 33, -93 37, -97 37, -97 33))",
    ("MULTIPOLYGON (((-89 31, -84 31, -84 36, -89 36, -89 31)), "
     "((-83 38, -80 38, -81 44, -83 38)))"),
    "POLYGON ((-95 35, -86 32, -86 43, -95 35))",  # overlaps both
]
SJ_SPEC = "fare:Float,dtg:Date,*geom:Point"
SJ_DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"


@pytest.fixture(scope="module")
def taxi():
    rng = np.random.default_rng(17)
    n = 8000
    data = {"fare": rng.uniform(2, 60, n).astype(np.float32),
            "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"),
                                n).astype("datetime64[ms]"),
            "geom__x": rng.uniform(-102, -78, n), "geom__y": rng.uniform(28, 46, n)}
    # rows on the band query's f32 bounds, inside its window and interval
    data["geom__x"][:30] = -98.0
    data["geom__y"][:30] = rng.uniform(32, 40, 30)
    data["dtg"][:30] = np.datetime64("2020-01-07T00:00:00", "ms")
    # vertices and edges of the polygons
    data["geom__x"][30:36] = [-100.0, -90.0, -97.0, -89.0, -84.0, -95.0]
    data["geom__y"][30:36] = [30.0, 35.0, 33.0, 31.0, 33.5, 35.0]
    out = []
    for ds in (JGeoDataset(n_shards=4), GeoDataset(n_shards=4, device="cpu")):
        ds.create_schema("taxi", SJ_SPEC)
        ds.insert("taxi", data)
        ds.flush()
        out.append(ds)
    return out


@pytest.mark.parametrize("query", ["INCLUDE", SJ_DURING,
                                   f"BBOX(geom, -98, 31, -85, 42) AND {SJ_DURING}",
                                   "fare > 30", "BBOX(geom, 0, 0, 1, 1)"],
                         ids=["include", "during", "band_rows", "attribute", "empty"])
@pytest.mark.parametrize("weight", [None, "fare"], ids=["count", "weighted"])
def test_spatial_join_equals_jax(taxi, query, weight):
    j, p = taxi
    ga, gc = p.spatial_join("taxi", BOROUGHS, query, weight=weight)
    wa, wc = j.spatial_join("taxi", BOROUGHS, query, weight=weight)
    assert ga.dtype == np.int32 and gc.dtype == np.float32
    assert np.array_equal(ga, wa) and np.array_equal(gc, wc)
    if query != "BBOX(geom, 0, 0, 1, 1)":
        assert (ga >= 0).any() and {0, 1, 2} <= set(ga.tolist())
    path = p._plan("taxi", query).exec_path
    if query.startswith("BBOX(geom, -98"):
        assert path["band_rows"] > 0 and path["scan"].startswith("host")
    elif query != "BBOX(geom, 0, 0, 1, 1)":
        assert path["scan"] == "device-padded"


def test_spatial_join_geometry_objects_and_partitioned_store(taxi, tmp_path):
    j, p = taxi
    pg = [geo.parse_wkt(w) for w in BOROUGHS]
    jg = [jgeo.parse_wkt(w) for w in BOROUGHS]
    ga, gc = p.spatial_join("taxi", pg, SJ_DURING)
    wa, wc = j.spatial_join("taxi", jg, SJ_DURING)
    assert np.array_equal(ga, wa) and np.array_equal(gc, wc)
    for ds in (JGeoDataset(n_shards=2), GeoDataset(n_shards=2, device="cpu")):
        ds.create_schema("tp", SJ_SPEC + ";geomesa.partition='time'")
        with pytest.raises(NotImplementedError, match="time-partitioned"):
            ds.spatial_join("tp", BOROUGHS)
