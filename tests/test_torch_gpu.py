"""CUDA kernels of geomesa_tpu_torch against their plain PyTorch versions.

Marked ``gpu``: each test needs a CUDA device and skips (from inside the
``cuda`` fixture) without one. This file imports no JAX, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import gc
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.kernels import density_grouped as kg
from geomesa_tpu_torch.kernels.density import pixel_coords
from geomesa_tpu_torch.kernels import pip as kpip
from geomesa_tpu_torch.utils.geometry import parse_wkt

pytestmark = pytest.mark.gpu

SPEC = "weight:Float,dtg:Date,*geom:Point"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
ECQL = f"BBOX(geom, -100, 30, -80, 45) AND {DURING}"
BBOX = (-100.0, 30.0, -80.0, 45.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ngon(n, cx=0.0, cy=0.0, r=10.0):
    pts = [(cx + r * (1 + 0.1 * math.sin(9 * 2 * math.pi * k / n)) * math.cos(2 * math.pi * k / n),
            cy + r * (1 + 0.1 * math.sin(9 * 2 * math.pi * k / n)) * math.sin(2 * math.pi * k / n))
           for k in range(n)]
    pts.append(pts[0])
    return "POLYGON ((" + ", ".join(f"{x!r} {y!r}" for x, y in pts) + "))"


POLYGONS = {
    "triangle": "POLYGON ((0 0, 10 0, 5 8, 0 0))",
    "donut": "POLYGON ((-9 -9, 9 -9, 9 9, -9 9, -9 -9), (-4 -4, 4 -4, 4 4, -4 4, -4 -4))",
    "edges64": _ngon(64),
    "edges1024": _ngon(1024),  # exactly one 1024-edge shared-memory tile
    "edges1025": _ngon(1025),
    "edges1500": _ngon(1500),  # more than one 1024-edge shared-memory tile
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
@pytest.mark.parametrize("shape", [(1,), (3,), (255,), (257,), (4 * 256 + 1,), (3, 1001),
                                   ((1 << 20) + 3,)],
                         ids=str)
def test_pip_kernel_matches_plain(cuda, name, shape):
    (x1, *_), packed = kpip.polygon_edge_tables(parse_wkt(POLYGONS[name]))
    g = torch.Generator(device="cpu").manual_seed(7)
    x = (torch.rand(shape, generator=g) * 24 - 12).to(cuda)
    y = (torch.rand(shape, generator=g) * 24 - 12).to(cuda)
    edges = torch.from_numpy(packed).to(cuda)
    before = kpip.launches
    got = kpip.pip_mask(x, y, edges, len(x1))
    torch.cuda.synchronize()
    assert kpip.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.bool
    assert torch.equal(got, kpip.pip_mask_plain(x, y, edges, len(x1)))
    assert torch.equal(got, kpip.pip_mask(x, y, edges))  # padded table


@pytest.mark.parametrize("where", ["above", "below", "vertex_rows"])
def test_pip_culling_is_exact(cuda, where):
    """Points whose warps' y-ranges miss every edge (above or below the
    polygon) are culled edge by edge and stay outside; points on the
    vertices' own y values still match the plain version exactly."""
    (x1, y1, *_), packed = kpip.polygon_edge_tables(parse_wkt(POLYGONS["edges64"]))
    rng = np.random.default_rng(4)
    n = 4 * 256 * 5 + 7
    x = rng.uniform(-12, 12, n).astype(np.float32)
    if where == "above":
        y = rng.uniform(12, 30, n).astype(np.float32)
    elif where == "below":
        y = rng.uniform(-30, -12, n).astype(np.float32)
    else:
        y = rng.choice(y1.astype(np.float32), n)
    xt, yt = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    edges = torch.from_numpy(packed).to(cuda)
    got = kpip.pip_mask(xt, yt, edges, len(x1))
    assert torch.equal(got, kpip.pip_mask_plain(xt, yt, edges, len(x1)))
    if where != "vertex_rows":
        assert not got.any()
        assert kpip.span_pairs(y, packed, len(x1)) == 0
    else:
        assert got.any()


def test_pip_kernel_refuses_what_it_does_not_take(cuda):
    _, packed = kpip.polygon_edge_tables(parse_wkt(POLYGONS["triangle"]))
    edges = torch.from_numpy(packed).to(cuda)
    x = torch.zeros(8, 4, device=cuda)
    with pytest.raises(TypeError):
        kpip.pip_mask(x.double(), x.double(), edges)
    with pytest.raises(ValueError):
        kpip.pip_mask(x.t(), x.t(), edges)
    with pytest.raises(ValueError):
        kpip.pip_mask(x, x, edges, packed.shape[1] + 1)


def _datasets(cuda, n, seed=5, **kw):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }
    out = []
    for dev in (cuda, "cpu"):
        ds = GeoDataset(n_shards=4, device=dev, compact_min_rows=1,
                        compact_fraction=2.0, **kw)
        ds.create_schema("t", SPEC)
        ds.insert("t", data)
        ds.flush("t")
        out.append(ds)
    return out


@pytest.mark.parametrize("grid", [(512, 512), (300, 200), (129, 127), (1024, 1024)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
def test_density_kernel_matches_plain(cuda, grid, weight):
    W, H = grid
    # 64 tiles over the query's bbox would pair chunks past the duplication
    # budget; over a wider one most of the 64 tiles have no pairs
    bbox = BBOX if W < 1024 else (-140.0, 10.0, -40.0, 60.0)
    gpu, cpu = _datasets(cuda, 40_000)
    ex = gpu._executor("t")
    plan = gpu._plan("t", ECQL)
    ops = ex.density_inputs(plan, bbox, W, H, weight)
    assert ops is not None, "the query did not take the grouped rung"
    args = (ops["x"], ops["y"], ops["mask"], ops["weight"], bbox, W, H, ops["sched"])
    before = kg.launches
    got = kg.density_grouped(*args)
    torch.cuda.synchronize()
    assert kg.launches == before + 1
    want = kg.density_grouped_plain(*args)
    if weight is None:
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    # through the API, against the CPU dataset's plain path
    g_gpu = gpu.density("t", ECQL, bbox=bbox, width=W, height=H, weight=weight)
    g_cpu = cpu.density("t", ECQL, bbox=bbox, width=W, height=H, weight=weight)
    if weight is None:
        assert np.array_equal(g_gpu, g_cpu)
    else:
        assert np.allclose(g_gpu, g_cpu, rtol=1e-4, atol=1e-3)


def _grouped_case(cuda, B, chunk_tiles, W, H, mask_p, seed=0):
    """Compact [C, B] operands whose chunk c lies inside tile
    ``chunk_tiles[c]`` (None: anywhere on the grid), with its schedule
    built from the rows' own cells; weights under a false mask are NaN."""
    rng = np.random.default_rng(seed)
    ntx, nty = -(-W // kg.TILE), -(-H // kg.TILE)
    C = len(chunk_tiles)
    x = np.empty((C, B), np.float32)
    y = np.empty((C, B), np.float32)
    for c, t in enumerate(chunk_tiles):
        if t is None:
            x[c], y[c] = rng.uniform(0, W, B), rng.uniform(0, H, B)
        else:
            ox, oy = (t % ntx) * kg.TILE, (t // ntx) * kg.TILE
            x[c] = rng.uniform(ox + 1, min(ox + kg.TILE, W) - 1, B)
            y[c] = rng.uniform(oy + 1, min(oy + kg.TILE, H) - 1, B)
    mask = rng.random((C, B)) < mask_p
    weight = np.where(mask, rng.uniform(0, 1, (C, B)), np.nan).astype(np.float32)
    bbox = (0.0, 0.0, float(W), float(H))
    px, py = pixel_coords(torch.from_numpy(x), torch.from_numpy(y), bbox, W, H)
    tile = ((py // kg.TILE) * ntx + px // kg.TILE).numpy()
    chunk = np.repeat(np.arange(C), B).reshape(C, B)
    pairs = np.unique(np.stack([tile.reshape(-1), chunk.reshape(-1)], 1), axis=0)
    gr = {"sc": pairs[:, 1] // kg.SG, "row": pairs[:, 1] % kg.SG,
          "tile": pairs[:, 0], "ox": (pairs[:, 0] % ntx) * kg.TILE,
          "ntx": ntx, "nty": nty}
    sched = {k: torch.from_numpy(v).to(cuda) if isinstance(v, np.ndarray) else v
             for k, v in kg.tile_segments(gr).items()}
    dev = [torch.from_numpy(a).to(cuda) for a in (x, y, mask, weight)]
    return dev, bbox, sched


# tiles of a 384x256 grid (3 x 2 tiles): tile 0 one chunk, tile 1 fewer
# chunks than a cluster has blocks, tile 2 many, tile 4 none at all
SHAPED = [0] + [1] * 3 + [2] * 21 + [3] * 9 + [5] * 2


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("case", ["shaped", "spread", "all_false"])
@pytest.mark.parametrize("weighted", [False, True], ids=["count", "weighted"])
def test_density_kernel_schedules(cuda, B, case, weighted):
    W, H = (384, 256) if case != "spread" else (512, 512)
    tiles = [None] * 40 if case == "spread" else SHAPED
    (x, y, mask, weight), bbox, sched = _grouped_case(
        cuda, B, tiles, W, H, 0.0 if case == "all_false" else 0.6)
    if case == "shaped":
        counts = np.bincount(sched["pair_tile"].cpu().numpy(), minlength=6)
        assert list(counts) == [1, 3, 21, 9, 0, 2]
    w = weight if weighted else None
    got = kg.density_grouped(x, y, mask, w, bbox, W, H, sched)
    want = kg.density_grouped_plain(x, y, mask, w, bbox, W, H, sched)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if weighted:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        assert torch.equal(got, want)
        assert float(got.sum()) == float(mask.sum())
    if case == "all_false":
        assert not got.any()


def test_density_kernel_refuses_what_it_does_not_take(cuda):
    (x, y, mask, weight), bbox, sched = _grouped_case(cuda, 128, SHAPED, 384, 256, 0.5)
    with pytest.raises(ValueError):
        kg.density_grouped(x, y, mask.float(), None, bbox, 384, 256, sched)
    with pytest.raises(ValueError):
        kg.density_grouped(x[:, :64], y[:, :64], mask[:, :64], None, bbox, 384, 256, sched)
    with pytest.raises(ValueError):  # a schedule for another grid
        kg.density_grouped(x, y, mask, None, bbox, 512, 256, sched)


def test_chunk_at_the_table_end(cuda):
    """Full shards (n = 4 x 8192) and a query reaching the last rows: the
    final slabs start early (``lo > 0``) and the kernel still agrees."""
    gpu, cpu = _datasets(cuda, 4 * 8192, seed=9)
    q = "BBOX(geom, -110, 30, -75, 48) AND dtg DURING 2020-01-10T12:00:00Z/2020-03-01T00:00:00Z"
    assert gpu.count("t", q) == cpu.count("t", q)
    d = gpu._plan("t", q).__dict__["_exec_cache"]["compact"]
    assert d is not None and (d["lo"] > 0).any()
    for w in (None, "weight"):
        g_gpu = gpu.density("t", q, bbox=(-110, 30, -75, 48), width=200, height=100, weight=w)
        g_cpu = cpu.density("t", q, bbox=(-110, 30, -75, 48), width=200, height=100, weight=w)
        assert gpu._plan("t", q).exec_path["density_kernel"] == "grouped"
        assert np.allclose(g_gpu, g_cpu, rtol=1e-4, atol=1e-3)
        if w is None:
            assert np.array_equal(g_gpu, g_cpu)


LOAD_AND_RUN = """
import sys
from pathlib import Path
import torch
from geomesa_tpu_torch.kernels import _build, pip as kpip
from geomesa_tpu_torch.utils.geometry import parse_wkt
_build.BUILD_DIR = Path(sys.argv[1])
(x1, *_), packed = kpip.polygon_edge_tables(parse_wkt("POLYGON ((0 0, 10 0, 5 8, 0 0))"))
g = torch.Generator().manual_seed(int(sys.argv[2]))
x = (torch.rand(100_000, generator=g) * 24 - 12).cuda()
y = (torch.rand(100_000, generator=g) * 24 - 12).cuda()
edges = torch.from_numpy(packed).cuda()
assert torch.equal(kpip.pip_mask(x, y, edges, len(x1)),
                   kpip.pip_mask_plain(x, y, edges, len(x1)))
print("ok")
"""


def test_two_processes_build_and_load_at_once(cuda, tmp_path):
    """Two processes find the library missing together: one compiles, the
    other waits on the build lock, and both load a whole library."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(repo), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", LOAD_AND_RUN, str(tmp_path), str(i)],
                              cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip().splitlines()[-1] for o in outs] == ["ok", "ok"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [".lock", "libpip.so"]


def test_polygon_count_kernel_matches_cpu(cuda):
    gpu, cpu = _datasets(cuda, 200_000, seed=3)
    q = f"INTERSECTS(geom, {_ngon(1500, -90, 37, 6)}) AND {DURING}"
    before = kpip.launches
    assert gpu.count("t", q) == cpu.count("t", q)
    assert kpip.launches > before


# -- slice 3: the kernels under z2 plans, every index path on the card -----------
SPEC3 = "name:String:index=true,code:Long,weight:Float,dtg:Date,*geom:Point"
BOX3 = "BBOX(geom, -100, 30, -80, 45)"


def _datasets3(cuda, n, seed=11):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    names = np.array([f"c{i:03d}" for i in range(256)])
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "name": names[rng.choice(256, n, p=zipf / zipf.sum())],
        "code": rng.integers(0, 1 << 40, n),
    }
    fids = np.char.add("e", np.arange(n).astype(str))
    out = []
    for dev in (cuda, "cpu"):
        ds = GeoDataset(n_shards=4, device=dev, compact_min_rows=1, compact_fraction=2.0)
        ds.create_schema("t", SPEC3)
        ds.insert("t", data, fids=fids)
        ds.flush("t")
        out.append(ds)
    return out


@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
def test_density_kernel_on_a_z2_plan(cuda, weight):
    gpu, cpu = _datasets3(cuda, 60_000)
    plan = gpu._plan("t", BOX3)
    assert plan.index_name == "z2"
    ops = gpu._executor("t").density_inputs(plan, BBOX, 512, 512, weight)
    assert ops is not None, "the z2 plan did not take the grouped rung"
    args = (ops["x"], ops["y"], ops["mask"], ops["weight"], BBOX, 512, 512, ops["sched"])
    before = kg.launches
    got = kg.density_grouped(*args)
    torch.cuda.synchronize()
    assert kg.launches == before + 1
    want = kg.density_grouped_plain(*args)
    g_gpu = gpu.density("t", BOX3, bbox=BBOX, width=512, height=512, weight=weight)
    g_cpu = cpu.density("t", BOX3, bbox=BBOX, width=512, height=512, weight=weight)
    assert gpu._plan("t", BOX3).exec_path["density_kernel"] == "grouped"
    if weight is None:
        assert torch.equal(got, want)
        assert np.array_equal(g_gpu, g_cpu)
    else:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
        assert np.allclose(g_gpu, g_cpu, rtol=1e-4, atol=1e-3)


def test_pip_kernel_on_z2_compact_columns(cuda):
    gpu, cpu = _datasets3(cuda, 60_000)
    q = f"INTERSECTS(geom, {_ngon(64, -90, 37, 6)})"
    plan = gpu._plan("t", q)
    assert plan.index_name == "z2"
    ex = gpu._executor("t")
    cols = ex.scan_columns(plan, ["geom__x", "geom__y"])
    x, y = cols["geom__x"], cols["geom__y"]
    assert x.dim() == 2 and ex._cache(plan)["compact"] is not None
    (x1, *_), packed = kpip.polygon_edge_tables(parse_wkt(_ngon(64, -90, 37, 6)))
    edges = torch.from_numpy(packed).to(cuda)
    before = kpip.launches
    got = kpip.pip_mask(x, y, edges, len(x1))
    assert kpip.launches == before + 1
    assert torch.equal(got, kpip.pip_mask_plain(x, y, edges, len(x1)))
    assert gpu.count("t", q) == cpu.count("t", q)


@pytest.mark.parametrize("q", [
    BOX3, "INCLUDE", f"name = 'c007' AND {BOX3}", f"name = 'c000' AND {BOX3}",
    "IN ('e17', 'e4242')", f"code > 500000000000 AND {BOX3} AND {DURING}",
    f"name IN ('c003', 'c010') AND weight BETWEEN 0.25 AND 0.75 AND {BOX3} AND {DURING}",
    "name LIKE 'c01%' AND DWITHIN(geom, POINT(-90 40), 500, kilometers)",
], ids=range(8))
def test_every_index_path_matches_cpu(cuda, q):
    """Counts and unweighted grids on the card equal the CPU dataset's on
    the z2, attribute, id and z3 plans and all three scan paths (the
    DWITHIN row may differ only on rows within 10 m of the radius)."""
    gpu, cpu = _datasets3(cuda, 60_000)
    assert gpu._plan("t", q).index_name == cpu._plan("t", q).index_name
    cg, cc = gpu.count("t", q), cpu.count("t", q)
    assert gpu._plan("t", q).exec_path["scan"] == cpu._plan("t", q).exec_path["scan"]
    if "DWITHIN" in q:
        assert abs(cg - cc) <= 2
    else:
        assert cg == cc
        assert np.array_equal(gpu.density("t", q, bbox=BBOX, width=256, height=256),
                              cpu.density("t", q, bbox=BBOX, width=256, height=256))


# -- slice 4: feature queries, stats, sampling and kNN on the card -------------------
@pytest.fixture(scope="module")
def pair4():
    """About 1M rows of slice 3's schema on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _datasets3(torch.device("cuda"), 1 << 20, seed=13)


Q4 = f"{BOX3} AND {DURING}"
POLY4 = f"INTERSECTS(geom, {_ngon(64, -90, 37, 6)})"


@pytest.mark.parametrize("q", [
    Q4, POLY4,
    ("sort", [("weight", True)], 10), ("sort", [("weight", True)], 1000),
    ("sort", [("name", False), ("weight", True)], 100),
    ("sort", [("code", False)], 50), ("sample", None, 10), ("sample", "name", 10),
    ("project", ["name"], 25),
], ids=["bbox", "polygon", "top10", "top1000", "two_keys", "long_key", "sample",
        "sample_by_name", "projection"])
def test_query_matches_cpu(pair4, q):
    """The card's features equal the CPU dataset's: rows, order, values,
    and the sort path; the polygon query launches the PIP kernel."""
    from geomesa_tpu_torch.api.dataset import Query

    gpu, cpu = pair4
    if isinstance(q, tuple):
        kind, arg, k = q
        q = {"sort": lambda: Query(Q4, sort_by=arg, max_features=k),
             "sample": lambda: Query(Q4, sampling=k, sample_by=arg),
             "project": lambda: Query(Q4, properties=arg, max_features=k)}[kind]()
    before = kpip.launches
    got, want = gpu.query("t", q), cpu.query("t", q)
    if q == POLY4:
        assert kpip.launches > before
    assert len(got) == len(want) > 0
    assert got.fids == want.fids
    for k, v in want.columns.items():
        assert np.array_equal(got.columns[k], v), k
    pg, pc = gpu._plan("t", q).exec_path, cpu._plan("t", q).exec_path
    assert pg.get("sort") == pc.get("sort")
    assert pg.get("feature_scan", pg.get("scan")) == pc.get("feature_scan", pc.get("scan"))


def test_stats_match_cpu(pair4):
    """Counts, min / max, histogram, enumeration and top-k exact; the
    descriptive sums within rtol 1e-5 of an f64 oracle and of the CPU."""
    gpu, cpu = pair4
    spec = ("Count();MinMax(weight);MinMax(geom);Histogram(weight,64,0,1);Enumeration(name);"
            "TopK(name,10);DescriptiveStats(weight)")
    for q in (Q4, POLY4, BOX3):
        g, c = gpu.stats("t", spec, q), cpu.stats("t", spec, q)
        assert gpu._plan("t", q).exec_path["scan"] == cpu._plan("t", q).exec_path["scan"]
        for a, b in zip(g.stats[:-1], c.stats[:-1]):
            assert a.value() == b.value(), a.kind
        w = cpu.query("t", q).columns["weight"].astype(np.float64)
        d, dc = g.stats[-1], c.stats[-1]
        assert d.count == dc.count == len(w)
        np.testing.assert_allclose(d.s1, [w.sum()], rtol=1e-5)
        np.testing.assert_allclose(d.s2, [[(w * w).sum()]], rtol=1e-5)
        np.testing.assert_allclose(d.s1, dc.s1, rtol=1e-5)
        np.testing.assert_allclose(d.s2, dc.s2, rtol=1e-5)


@pytest.mark.parametrize("case", [(-90.0, 40.0, 10, "INCLUDE"), (-90.0, 40.0, 100, "name = 'c007'"),
                                  (-75.0, 30.0, 40, Q4)], ids=["k10", "k100_name", "k40_bbox"])
def test_knn_matches_cpu(pair4, case):
    """The card's kNN distance set equals the CPU's and the f64 brute
    force's at rtol 1e-9, but for rows within 1e-6 (relative) of the k-th
    distance (f32 transcendentals on the card and on the CPU)."""
    from geomesa_tpu_torch.utils.geometry import haversine_m

    gpu, cpu = pair4
    x, y, k, q = case
    rows = cpu.query("t", q)
    d_all = np.sort(haversine_m(rows.columns["geom__x"], rows.columns["geom__y"], x, y))[:k]
    for fc in (gpu.knn("t", x, y, k, q), cpu.knn("t", x, y, k, q)):
        d = np.sort(haversine_m(fc.columns["geom__x"], fc.columns["geom__y"], x, y))
        assert len(d) == len(d_all) == k
        off = ~np.isclose(d, d_all, rtol=1e-9)
        assert np.allclose(d[off], d_all[-1], rtol=1e-6)


# -- slice 5: time-partitioned stores, the staged uploads ----------------------------
PSPEC = SPEC + ";geomesa.partition='time'"
#: nine weekly partitions (epoch weeks 2608-2616, Thursday to Thursday)
P_ROWS = 1 << 20
WEEKS = "dtg DURING 2020-01-01T00:00:00Z/2020-02-26T00:00:00Z"
#: inside epoch week 2611 alone
ONE_WEEK = "dtg DURING 2020-01-17T00:00:00Z/2020-01-22T00:00:00Z"


def _partitioned(dev, max_resident, tmp_path, seed=17):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, P_ROWS),
        "geom__y": rng.uniform(25, 50, P_ROWS),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-26"), P_ROWS).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, P_ROWS).astype(np.float32),
    }
    ds = GeoDataset(n_shards=4, device=dev, compact_min_rows=1, compact_fraction=2.0)
    ds.create_schema("t", PSPEC)
    st = ds._store("t")
    st.max_resident = max_resident
    st._spill_dir = str(tmp_path / f"spill_{dev}")
    ds.insert("t", data, fids=np.arange(P_ROWS).astype(str))
    ds.flush("t")
    return ds


@pytest.mark.parametrize("name", ["geom__x", "geom__y", "dtg", "weight", "__z3_bin"])
def test_staged_upload_equals_synchronous_copy(cuda, name):
    """A column stacked into a pooled pinned buffer and copied on the side
    stream equals a synchronous upload byte for byte; a second staging
    reuses the pool's buffer."""
    from geomesa_tpu_torch.index.staging import Uploader

    gpu, _ = _datasets(cuda, 300_000, seed=23)
    table = gpu._store("t").tables["z3"]
    up = Uploader(cuda)
    for rep in range(2):
        table.drop_device()
        assert table.stage_host([name], up) > 0
        got = table.device_columns([name])[name]
        want = torch.from_numpy(table._stack_host(name)).cuda()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.contiguous().view(torch.uint8), want.view(torch.uint8))
    assert up.pool.allocations == 1 and up.pool.buffers() == 1


def test_partitioned_density_prefetch_on_equals_off(cuda, tmp_path):
    """Nine partitions streamed through a budget of 2: counts, grids and
    rows with the prefetch pipeline on equal those with it off and the
    CPU's; both kernels launch once per partition. (At about 116k rows a
    week the grouped rung's duplication budget would send the box's
    full-week scans to the scatter; it is lifted so the kernel runs.)"""
    from geomesa_tpu_torch import config
    from geomesa_tpu_torch.api.dataset import Query

    with config.DENSITY_PALLAS_MAX_DUP.scoped(1e9):
        gpu = _partitioned(cuda, 2, tmp_path)
        cpu = _partitioned("cpu", 2, tmp_path)
        ex = gpu._executor("t")
        poly = f"INTERSECTS(geom, {_ngon(64, -90, 37, 6)}) AND {WEEKS}"
        box = f"BBOX(geom, -100, 30, -80, 45) AND {WEEKS}"
        calls = {
            "count": lambda ds: ds.count("t", box),
            "density": lambda ds: ds.density("t", box, bbox=BBOX, width=512, height=512),
            "weighted": lambda ds: ds.density("t", box, bbox=BBOX, width=512, height=512,
                                              weight="weight"),
            "polygon": lambda ds: ds.count("t", poly),
            "sorted": lambda ds: ds.query("t", Query(WEEKS, sort_by=[("weight", True)],
                                                     max_features=100)).fids,
        }
        for key, fn in calls.items():
            pip0, den0 = kpip.launches, kg.launches
            on = fn(gpu)
            launched = (kpip.launches - pip0, kg.launches - den0)
            ex.prefetch = False
            try:
                off = fn(gpu)
            finally:
                ex.prefetch = True
            want = fn(cpu)
            if key == "weighted":
                np.testing.assert_allclose(on, off, rtol=1e-4, atol=1e-3)
                np.testing.assert_allclose(on, want, rtol=1e-4, atol=1e-3)
            elif key == "density":
                np.testing.assert_array_equal(on, off)
                np.testing.assert_array_equal(on, want)
            else:
                assert on == off == want, key
            if key in ("density", "weighted"):
                # one launch for each partition whose scan took the grouped rung
                parts = gpu._plan("t", box).exec_path["partitions"]
                assert len(parts) == 9
                assert all(p["density_kernel"] == "grouped" for p in parts.values()), parts
                assert launched[1] == 9, launched
            if key == "polygon":
                assert launched[0] == 9, launched
        assert ex.uploader.pool.allocations <= 2 * ex.uploader.pool.max_buffers


def test_partitioned_device_memory_is_bounded(cuda, tmp_path):
    """Streaming nine partitions through a budget of 2 peaks at no more
    than (budget + 1) times one partition's own peak plus the grids the
    merge holds (at most five 1 MB grids for nine partials), and spilling
    every partition gives their device memory back."""
    gpu = _partitioned(cuda, 2, tmp_path)
    st = gpu._store("t")
    # the nine whole-week scans take the einsum rung, whose products use
    # cuBLAS's workspace: the process's first matrix product on a stream
    # allocates it (at most 32 MiB) and keeps it, so a 1x1 product allocates
    # it before the baseline and its size is held apart from the bound
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.mm(torch.ones(1, 1, device=cuda), torch.ones(1, 1, device=cuda))
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before <= 32 * 2**20

    def peak_of(q):
        st.spill_all()
        gc.collect()  # earlier tests' tensors must not free inside the window
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # settles frees deferred by record_stream
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gpu.density("t", q, bbox=BBOX, width=512, height=512)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, base

    one, base = peak_of(ONE_WEEK)
    assert gpu._plan("t", ONE_WEEK).exec_path["partitions_scanned"] == 1
    every, _ = peak_of(WEEKS)
    assert gpu._plan("t", WEEKS).exec_path["partitions_scanned"] == 9
    grids = 5 * 512 * 512 * 4
    assert 0 < one and every <= (st.max_resident + 1) * one + grids, (every, one)
    st.spill_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() <= base


# -- slice 6: extent geometries and expressions on the card -------------------------
POLY_SPEC = "name:String,height:Float,dtg:Date,*geom:Polygon"
VIEW = (-2.0, -2.0, 3.0, 3.0)


def _poly_wkts(rng, n):
    out = []
    for i in range(n):
        cx, cy = rng.uniform(-10, 10, 2)
        k = int(rng.integers(3, 7))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        r = rng.uniform(0.05, 0.4, k)
        ring = [(float(cx + a * np.cos(t)), float(cy + a * np.sin(t)))
                for t, a in zip(ang, r)]
        body = ", ".join(f"{x!r} {y!r}" for x, y in ring + ring[:1])
        out.append(f"POLYGON (({body}))" if i % 10 != 3 else
                   f"POLYGON (({body}), ("
                   + ", ".join(f"{float(cx + 0.3 * (x - cx))!r} {float(cy + 0.3 * (y - cy))!r}"
                               for x, y in ring + ring[:1]) + "))")
    return out


def _poly_datasets(cuda, n, spec=POLY_SPEC, seed=13, tmp_path=None):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    data = {"name": [f"a{i % 20}" for i in range(n)],
            "height": rng.uniform(0, 40, n).astype(np.float32),
            "dtg": rng.integers(lo, parse_iso_ms("2020-03-01"), n).astype("datetime64[ms]"),
            "geom": _poly_wkts(rng, n)}
    fids = np.char.add("p", np.arange(n).astype(str))
    out = []
    for dev in (cuda, "cpu"):
        ds = GeoDataset(n_shards=4, device=dev, compact_min_rows=1, compact_fraction=2.0)
        ds.create_schema("t", spec)
        if tmp_path is not None:
            st = ds._store("t")
            st.max_resident = 2
            st._spill_dir = str(tmp_path / f"poly_{dev}")
        ds.insert("t", data, fids=fids)
        ds.flush("t")
        out.append(ds)
    return out


def test_loose_bbox_density_kernel_on_a_polygon_schema(cuda):
    """Loose BBOX on an extent column runs the grouped kernel over the xz
    plan's chunks (boxes from the centroid columns): the kernel equals its
    plain version, and the grids and counts equal the CPU's."""
    from geomesa_tpu_torch import config

    gpu, cpu = _poly_datasets(cuda, 60_000)
    q = f"BBOX(geom, {', '.join(str(v) for v in VIEW)}) AND {DURING}"
    with config.LOOSE_BBOX.scoped(True):
        plan = gpu._plan("t", q)
        assert plan.index_name in ("xz3", "xz2") and plan.compiled.refine is None
        ops = gpu._executor("t").density_inputs(plan, VIEW, 256, 256)
        assert ops is not None, "the loose BBOX did not take the grouped rung"
        args = (ops["x"], ops["y"], ops["mask"], ops["weight"], VIEW, 256, 256, ops["sched"])
        before = kg.launches
        got = kg.density_grouped(*args)
        torch.cuda.synchronize()
        assert kg.launches == before + 1
        assert torch.equal(got, kg.density_grouped_plain(*args))
        g_gpu = gpu.density("t", q, bbox=VIEW, width=256, height=256)
        assert gpu._plan("t", q).exec_path["density_kernel"] == "grouped"
        assert np.array_equal(g_gpu, cpu.density("t", q, bbox=VIEW, width=256, height=256))
        assert gpu.count("t", q) == cpu.count("t", q)


def test_pip_kernel_under_an_expression_plan(cuda):
    """A point schema's INTERSECTS(polygon) AND an expression refines on
    the host after a coarse device mask that runs the PIP kernel; the
    answers equal the CPU's."""
    gpu, cpu = _datasets3(cuda, 60_000)
    q = f"INTERSECTS(geom, {_ngon(64, -90, 37, 6)}) AND weight * 2 > 1.2 AND {DURING}"
    before = kpip.launches
    assert gpu.count("t", q) == cpu.count("t", q)
    assert kpip.launches > before
    assert gpu._plan("t", q).exec_path["scan"] == "host+device-coarse"
    assert np.array_equal(gpu.density("t", q, bbox=BBOX, width=256, height=256),
                          cpu.density("t", q, bbox=BBOX, width=256, height=256))
    assert sorted(gpu.query("t", q).fids) == sorted(cpu.query("t", q).fids)


@pytest.mark.parametrize("q", [
    f"INTERSECTS(geom, POLYGON ((-2 -2, 4 -1, 5 4, -1 5, -3 1, -2 -2))) AND {DURING}",
    "NOT BBOX(geom, -2, -2, 3, 3) AND dtg DURING 2020-01-01T00:00:00Z/2020-03-01T00:00:00Z",
    "DWITHIN(geom, LINESTRING (-8 -8, 0 0, 3 6), 30, kilometers)",
    "height * 2 > 40 AND BBOX(geom, -5, -5, 5, 5)",
    "st_area(geom) > 0.1 AND BBOX(geom, -5, -5, 5, 5)",
], ids=["intersects", "not_bbox", "dwithin", "expr", "st_area"])
def test_partitioned_polygon_store_matches_cpu(cuda, tmp_path, q):
    """A partitioned polygon store with 2 of 9 partitions resident: counts,
    fids, grids and WKT on the card equal the CPU's."""
    gpu, cpu = _poly_datasets(cuda, 20_000, POLY_SPEC + ";geomesa.partition='time'",
                              tmp_path=tmp_path)
    assert gpu.count("t", q) == cpu.count("t", q)
    got, want = gpu.query("t", q).to_dict(), cpu.query("t", q).to_dict()
    assert dict(zip(got.get("__fid__", []), got.get("geom", []))) == \
        dict(zip(want.get("__fid__", []), want.get("geom", [])))
    assert np.array_equal(gpu.density("t", q, bbox=(-12, -12, 12, 12), width=64, height=64),
                          cpu.density("t", q, bbox=(-12, -12, 12, 12), width=64, height=64))
    assert gpu._store("t").loads > 0


# -- slice 7: the join kernels -------------------------------------------------------
from geomesa_tpu_torch.kernels import join as kj  # noqa: E402
from geomesa_tpu_torch.planning import join_exec as je  # noqa: E402

JOIN_PREDS = {"bbox": {"dx": 0.05, "dy": 0.03}, "dwithin": {"distance": 0.05},
              "dwithin_meters": {"distance": 6000.0}}


def _tile_ops(C, Bp, Pp, predicate, seed=0):
    """Random tiles (x, y in a 0.5-degree square), with exact-distance and
    coincident pairs, a NaN, and random valid counts (the first tiles
    full and empty)."""
    rng = np.random.default_rng(seed)
    lx = rng.uniform(0, 0.5, (C, Bp)).astype(np.float32)
    ly = rng.uniform(0, 0.5, (C, Bp)).astype(np.float32)
    rx = rng.uniform(0, 0.5, (C, Pp)).astype(np.float32)
    ry = rng.uniform(0, 0.5, (C, Pp)).astype(np.float32)
    rx[:, 0], ry[:, 0] = lx[:, 0] + np.float32(0.05), ly[:, 0]
    rx[:, -1], ry[:, -1] = lx[:, -1], ly[:, -1]
    lx[0, -1] = np.nan
    lval = rng.integers(0, Bp + 1, C).astype(np.int32)
    rval = rng.integers(0, Pp + 1, C).astype(np.int32)
    lval[0], rval[0] = Bp, Pp
    if C > 1:
        lval[1] = 0
    ops = [lx, ly, rx, ry]
    z = [None, None]
    if predicate == "dwithin_meters":
        lu, ru = kj.unit_vectors(lx, ly), kj.unit_vectors(rx, ry)
        ops, z = [lu[0], lu[1], ru[0], ru[1]], [lu[2], ru[2]]
    return ops, z, lval, rval


def _cu(a, cuda):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(cuda)


@pytest.mark.parametrize("predicate", sorted(JOIN_PREDS))
@pytest.mark.parametrize("shape", [(1, 64, 64), (37, 64, 8), (37, 8, 64), (5, 4, 2),
                                   (3, 128, 128), (70_000, 8, 8)], ids=str)
def test_pair_tiles_kernel_matches_plain(cuda, predicate, shape):
    C, Bp, Pp = shape
    ops, z, lval, rval = _tile_ops(C, Bp, Pp, predicate)
    p0, p1 = kj.pair_params(predicate, **JOIN_PREDS[predicate])
    args = [_cu(a, cuda) for a in ops] + [_cu(lval, cuda), _cu(rval, cuda)]
    zk = {"lzb": _cu(z[0], cuda), "rzb": _cu(z[1], cuda)}
    before = kj.launches["pair_tiles"]
    m, c = kj.pair_tiles(*args, predicate, p0, p1, True, **zk)
    pm, pc = kj.pair_tiles_plain(*args, predicate, p0, p1, True, **zk)
    m0, c0 = kj.pair_tiles(*args, predicate, p0, p1, False, **zk)
    torch.cuda.synchronize()
    assert kj.launches["pair_tiles"] == before + 2
    assert m0 is None and torch.equal(c0, pc) and torch.equal(c, pc)
    assert m.dtype == torch.bool and torch.equal(m, pm)
    assert int(pc.sum()) > 0


@pytest.mark.parametrize("predicate", sorted(JOIN_PREDS))
@pytest.mark.parametrize("kp,kvalid", [(1, 1), (300, 0), (16384, 16384), (16384, 9001),
                                       (1 << 21, (1 << 21) - 5)])
def test_pair_flat_kernel_matches_plain(cuda, predicate, kp, kvalid):
    ops, z, _, _ = _tile_ops(1, kp, kp, predicate, seed=1)
    p0, p1 = kj.pair_params(predicate, **JOIN_PREDS[predicate])
    args = [_cu(a.reshape(-1), cuda) for a in ops]
    zk = {"lzv": _cu(None if z[0] is None else z[0].reshape(-1), cuda),
          "rzv": _cu(None if z[1] is None else z[1].reshape(-1), cuda)}
    m, n = kj.pair_flat(*args, kvalid, predicate, p0, p1, True, **zk)
    pm, pn = kj.pair_flat_plain(*args, kvalid, predicate, p0, p1, True, **zk)
    m0, n0 = kj.pair_flat(*args, kvalid, predicate, p0, p1, False, **zk)
    torch.cuda.synchronize()
    assert torch.equal(m, pm) and int(n) == int(pn) == int(n0) and m0 is None


JOIN_POLYS = [
    "POLYGON ((0 0, 8 0, 8 8, 0 8, 0 0), (3 3, 5 3, 5 5, 3 5, 3 3))",
    "POLYGON ((20 -20, 60 -20, 60 20, 20 20, 20 -20))",
    ("MULTIPOLYGON (((-30 -10, -25 -10, -25 -5, -30 -5, -30 -10)), "
     "((-20 -10, -15 -10, -15 -5, -20 -5, -20 -10)))"),
    "POLYGON ((2 2, 30 4, 10 30, 2 2))",
    _ngon(1500, 10, 0, 25),
]


def _join_points(n, seed=2):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-40, 70, n).astype(np.float32)
    py = rng.uniform(-30, 45, n).astype(np.float32)
    edge = np.array([(0, 0), (8, 4), (3, 3), (5, 5), (40, 20), (20, 0), (60, -20), (-25, -7.5),
                     (np.nan, 1), (1, np.nan), (6, 6)], np.float32)
    k = min(n, len(edge))
    px[:k], py[:k] = edge[:k, 0], edge[:k, 1]
    return px, py


@pytest.mark.parametrize("predicate", ["pip", "poly_bbox"])
@pytest.mark.parametrize("n", [1, 255, 4099, 1 << 18])
@pytest.mark.parametrize("pad", [False, True], ids=["exact", "pow2"])
def test_polygon_verdict_kernel_matches_plain(cuda, predicate, n, pad):
    geoms = [parse_wkt(w) for w in JOIN_POLYS]
    t = kj.polygon_tables(geoms)
    if pad:
        t = kj.polygon_tables(geoms, pad_edges=je._pow2(t["n_edges"]),
                              pad_parts=je._pow2(t["n_parts"]), pad_rows=je._pow2(t["n_rows"]))
    tabs = kj.table_tensors(t, cuda)
    px, py = _join_points(n)
    got = kj.polygon_verdict(_cu(px, cuda), _cu(py, cuda), tabs, predicate)
    want = kj.polygon_verdict_plain(_cu(px, cuda), _cu(py, cuda), tabs, predicate)
    torch.cuda.synchronize()
    assert got.shape == (n, t["n_rows_padded"]) and torch.equal(got, want)
    assert torch.equal(want.cpu(), torch.from_numpy(kj.polygon_mask(px, py, t, predicate, np)))


@pytest.mark.parametrize("n", [1, 1000, 3 * (1 << 18) + 7])
@pytest.mark.parametrize("masked", [1.0, 0.3])
def test_pip_assign_kernel_matches_plain(cuda, n, masked):
    geoms = [parse_wkt(w) for w in JOIN_POLYS]
    flat = tuple(q for g in geoms for q in (g.polygons if hasattr(g, "polygons") else (g,)))
    from geomesa_tpu_torch.utils import geometry as geo

    edges = geo.polygon_edge_buffers(geo.MultiPolygon(flat))
    edges = {k: (v.astype(np.float32) if k in ("x1", "y1", "x2", "y2") else v)
             for k, v in edges.items()}
    et = kj.edge_tensors(edges, cuda)
    px, py = _join_points(n, seed=3)
    mask = np.random.default_rng(4).random(n) < masked
    args = (_cu(px, cuda), _cu(py, cuda), _cu(mask, cuda))
    before = kj.launches["pip_assign"]
    got = kj.pip_assign(*args, et, torch)
    want = kj.pip_assign_plain(*args, et)
    torch.cuda.synchronize()
    assert kj.launches["pip_assign"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if n >= 1000:
        assert set(got.unique().tolist()) >= {-1, 0, 1, 5}


def test_join_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 8), device=cuda)
    v = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kj.pair_tiles(x, x, x, x, v, v, "dwithin_meters", 1.0, 0.0)
    with pytest.raises(TypeError):
        kj.pair_tiles(x.double(), x, x, x, v, v, "dwithin", 1.0, 0.0)
    with pytest.raises(ValueError):
        kj.pair_tiles(x, x, x[:1], x[:1], v, v, "dwithin", 1.0, 0.0)
    with pytest.raises(ValueError):
        kj.pair_flat(x[0], x[0], x[0], x[0], 9, "dwithin", 1.0, 0.0)
    t = kj.polygon_tables([parse_wkt(JOIN_POLYS[0])])
    with pytest.raises(ValueError):  # tables not made by table_tensors
        kj.polygon_verdict(x[0], x[0], {k: (_cu(a, cuda) if isinstance(a, np.ndarray) else a)
                                        for k, a in t.items()}, "pip")
    with pytest.raises(ValueError):
        kj.pip_assign(x[0], x[0], x[0] > 0, {"n_polys": 1}, torch)


def _join_datasets(cuda, n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-74.2, -73.75, 8), rng.uniform(40.55, 40.9, 8)
    def side(m):
        k = rng.integers(0, 8, m)
        return {"fare": rng.uniform(2, 60, m).astype(np.float32),
                "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"),
                                    m).astype("datetime64[ms]"),
                "geom__x": cx[k] + rng.normal(0, 0.02, m), "geom__y": cy[k] + rng.normal(0, 0.02, m)}
    pick, drop, stations = side(n), side(n // 2), side(300)
    polys = {"nta": [f"n{i}" for i in range(4)], "geom": np.array(JOIN_POLYS_NYC, object)}
    out = []
    for dev in (cuda, "cpu"):
        ds = GeoDataset(n_shards=4, device=dev)
        for name, rows in (("pick", pick), ("drop", drop), ("st", stations)):
            ds.create_schema(name, "fare:Float,dtg:Date,*geom:Point")
            ds.insert(name, rows, fids=[f"{name}{i}" for i in range(len(rows["fare"]))])
        ds.create_schema("nta", "nta:String,*geom:Polygon")
        ds.insert("nta", polys, fids=["a", "b", "c", "d"])
        ds.flush()
        out.append(ds)
    return out


JOIN_POLYS_NYC = [
    "POLYGON ((-74.1 40.6, -73.9 40.6, -73.9 40.8, -74.1 40.8, -74.1 40.6), "
    "(-74.0 40.65, -73.95 40.65, -73.95 40.7, -74.0 40.7, -74.0 40.65))",
    "MULTIPOLYGON (((-73.9 40.7, -73.8 40.7, -73.85 40.85, -73.9 40.7)), "
    "((-74.2 40.5, -74.15 40.5, -74.15 40.6, -74.2 40.5)))",
    _ngon(200, -73.97, 40.75, 0.05),
    "POLYGON ((-73.8 40.6, -73.75 40.6, -73.75 40.65, -73.8 40.6))",
]


@pytest.mark.parametrize("call", ["dwithin_meters", "dwithin", "bbox", "pip", "poly_bbox"])
def test_joins_on_the_card_match_cpu(cuda, call):
    gpu, cpu = _join_datasets(cuda)
    right = {"dwithin_meters": "st", "pip": "nta", "poly_bbox": "nta"}.get(call, "drop")
    kw = {"dwithin_meters": {"distance": 100.0}, "dwithin": {"distance": 0.0005},
          "bbox": {"dx": 0.0005, "dy": 0.0005}}.get(call, {})
    kj.reset_launches()
    g = gpu.join_spatial("pick", right, predicate=call, **kw)
    c = cpu.join_spatial("pick", right, predicate=call, **kw)
    assert np.array_equal(g.pairs, c.pairs) and g.count == c.count > 0
    assert g.stats == c.stats
    assert gpu.join_count("pick", right, predicate=call, **kw) == c.count
    if call in ("pip", "poly_bbox"):
        assert kj.launches["polygon_verdict"] >= 2
    else:
        assert kj.launches["pair_tiles"] + kj.launches["pair_flat"] >= 2


def test_spatial_join_and_regions_on_the_card_match_cpu(cuda):
    gpu, cpu = _join_datasets(cuda)
    q = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
    before = kj.launches["pip_assign"]
    for weight in (None, "fare"):
        ga, gc = gpu.spatial_join("pick", JOIN_POLYS_NYC, q, weight=weight)
        ca, cc = cpu.spatial_join("pick", JOIN_POLYS_NYC, q, weight=weight)
        assert np.array_equal(ga, ca) and np.array_equal(gc, cc) and (ga >= 0).any()
    assert kj.launches["pip_assign"] == before + 2
    halves = ("MULTIPOLYGON (((-74.3 40.4, -73.95 40.4, -73.95 41, -74.3 41, -74.3 40.4)), "
              "((-73.9 40.4, -73.6 40.4, -73.6 41, -73.9 41, -73.9 40.4)))")
    assert cpu.count("pick", q, region=halves) > 0
    for region in (JOIN_POLYS_NYC[0], halves):
        assert gpu.count("pick", q, region=region) == cpu.count("pick", q, region=region)
        assert np.array_equal(
            gpu.density("pick", q, width=128, height=128, region=region),
            cpu.density("pick", q, width=128, height=128, region=region))
        assert gpu.stats("pick", "Count();MinMax(fare)", q, region=region).value() == \
            cpu.stats("pick", "Count();MinMax(fare)", q, region=region).value()


def _batch_queries(seed, m):
    rng = np.random.default_rng(seed)
    qs, boxes = [], []
    for i in range(m):
        x0, y0 = float(rng.uniform(-118, -80)), float(rng.uniform(26, 44))
        boxes.append((x0, y0, x0 + 6.0, y0 + 4.0))
        d0 = 2 + (3 * i) % 24
        qs.append(f"BBOX(geom, {x0}, {y0}, {x0 + 6.0}, {y0 + 4.0}) AND dtg DURING "
                  f"2020-01-{d0:02d}T00:00:00Z/2020-01-{d0 + 3:02d}T00:00:00Z")
    return qs, boxes


@pytest.mark.parametrize("m", [2, 5, 8])
def test_batches_on_the_card_equal_serial(cuda, m):
    """count / density / stats batches and the curve batches on the card:
    every member equals its serial call on the card (counts, unweighted
    grids and integer sketches bit for bit, weighted grids within rtol
    1e-4: float atomics fix no order) and the CPU's answers."""
    gpu, cpu = _datasets(cuda, 200_000, seed=13)
    qs, boxes = _batch_queries(40 + m, m)
    got = gpu.count_batch("t", qs)
    assert gpu._plan("t", qs[0]).exec_path["scan"] == "device-batch"
    assert got == [gpu.count("t", q) for q in qs] == cpu.count_batch("t", qs)
    for w in (None, "weight"):
        grids = gpu.density_batch("t", qs, bboxes=boxes, width=64, height=48, weight=w)
        for q, b, g, c in zip(qs, boxes, grids,
                              cpu.density_batch("t", qs, bboxes=boxes, width=64, height=48,
                                                weight=w)):
            s = gpu.density("t", q, bbox=b, width=64, height=48, weight=w)
            if w is None:
                assert np.array_equal(g, s) and np.array_equal(g, c)
            else:
                assert np.allclose(g, s, rtol=1e-4, atol=1e-3)
                assert np.allclose(g, c, rtol=1e-4, atol=1e-3)
    spec = "Count();MinMax(weight);Histogram(weight,16,0,1)"
    st = [s.to_json() for s in gpu.stats_batch("t", spec, qs)]
    assert st == [gpu.stats("t", spec, q).to_json() for q in qs]
    assert st == [s.to_json() for s in cpu.stats_batch("t", spec, qs)]
    curves = gpu.density_curve_filter_batch("t", qs, level=11, bboxes=boxes)
    for q, b, (g, _), (c, _) in zip(qs, boxes, curves,
                                    cpu.density_curve_filter_batch("t", qs, level=11,
                                                                   bboxes=boxes)):
        assert np.array_equal(g, gpu.density_curve("t", q, level=11, bbox=b)[0])
        assert np.array_equal(g, c)
    tiles = gpu.density_curve_batch("t", qs[0], level=12, bboxes=boxes)
    for b, (g, _) in zip(boxes, tiles):
        assert np.array_equal(g, cpu.density_curve("t", qs[0], level=12, bbox=b)[0])


def test_density_curve_on_the_card(cuda):
    """The int32 prefix stays int32 on the card, and the weighted curve
    stays within rtol 1e-4 plus 16 f32 ulps of the largest prefix of the
    CPU's (the card's scan sums predecessor tiles in an order set by
    timing; chip_smoke.py's CURVE_ULPS)."""
    gpu, cpu = _datasets(cuda, 300_000, seed=17)
    # the largest prefix: the weight of every match (the prefix runs over the
    # whole table, whatever the crop)
    total = float(cpu.density("t", ECQL, bbox=BBOX, width=1, height=1, weight="weight").sum())
    for level, bbox in ((9, (-125, 24, -66, 49)), (12, (-95, 35, -94, 36))):
        g, s = gpu.density_curve("t", ECQL, level=level, bbox=bbox)
        c, cs = cpu.density_curve("t", ECQL, level=level, bbox=bbox)
        assert s == cs and np.array_equal(g, c) and g.sum() > 0
        gw, _ = gpu.density_curve("t", ECQL, level=level, bbox=bbox, weight="weight")
        cw, _ = cpu.density_curve("t", ECQL, level=level, bbox=bbox, weight="weight")
        assert np.allclose(gw, cw, rtol=1e-4, atol=16 * float(np.spacing(np.float32(total))))
    before = kpip.launches
    tri = "POLYGON ((-100 30, -80 31, -90 44, -100 30))"
    g, _ = gpu.density_curve("t", ECQL, level=10, bbox=BBOX, region=tri)
    c, _ = cpu.density_curve("t", ECQL, level=10, bbox=BBOX, region=tri)
    assert np.array_equal(g, c) and g.sum() > 0
    assert kpip.launches > before


# -- slice 9: lake pushdown and lifecycle on the card --------------------------------
def test_pruned_child_on_the_card_equals_the_full_load(cuda, tmp_path):
    """A spilled lake partition pruned to the query's box loads as an
    ephemeral child that never becomes resident; its count, polygon count
    and grid (through both kernels) equal the whole partition's and the
    CPU's."""
    from geomesa_tpu_torch import config

    with config.DENSITY_PALLAS_MAX_DUP.scoped(1e9), config.LAKE_ROWGROUP_ROWS.scoped(4096):
        gpu = _partitioned(cuda, 2, tmp_path)
        cpu = _partitioned("cpu", 2, tmp_path)
        st = gpu._store("t")
        box = f"BBOX(geom, -100, 30, -92, 36) AND {WEEKS}"
        poly = f"INTERSECTS(geom, {_ngon(64, -96, 33, 3)}) AND {WEEKS}"
        calls = {
            "count": lambda ds: ds.count("t", box),
            "density": lambda ds: ds.density("t", box, bbox=BBOX, width=512, height=512),
            "polygon": lambda ds: ds.count("t", poly),
        }
        for key, fn in calls.items():
            st.spill_all()
            pip0, den0 = kpip.launches, kg.launches
            on = fn(gpu)
            launched = (kpip.launches - pip0, kg.launches - den0)
            q = poly if key == "polygon" else box
            path = gpu._plan("t", q).exec_path
            # the call's audit event carries its lake account
            assert "lake" in path and gpu.audit.recent(1)[0].hints["lake"]["groups_pruned"] > 0, path
            assert not st.partitions, "a pruned child became resident"
            st.spill_all()
            with config.LAKE_PUSHDOWN.scoped(False):
                off = fn(gpu)
            want = fn(cpu)
            if key == "density":
                np.testing.assert_array_equal(on, off)
                np.testing.assert_array_equal(on, want)
                assert launched[1] == 9, launched
            else:
                assert on == off == want, key
            if key == "polygon":
                assert launched[0] == 9, launched


def test_lifecycle_on_the_card_matches_cpu(cuda, tmp_path):
    """update_schema, an attribute index, delete_features and age_off on a
    partitioned store on the card: counts and grids after each equal the
    CPU's."""
    gpu = _partitioned(cuda, 2, tmp_path)
    cpu = _partitioned("cpu", 2, tmp_path)
    box = f"BBOX(geom, -100, 30, -80, 45) AND {WEEKS}"
    steps = [
        lambda ds: ds.update_schema("t", "tag:Integer"),
        lambda ds: ds.add_attribute_index("t", "tag"),
        lambda ds: ds.delete_features("t", "BBOX(geom, -95, 35, -90, 40)"),
        lambda ds: ds.age_off("t", "2020-01-20T00:00:00Z"),
        lambda ds: ds.remove_attribute_index("t", "tag"),
    ]
    for step in steps:
        assert step(gpu) == step(cpu)
        assert gpu.count("t", box) == cpu.count("t", box)
        np.testing.assert_array_equal(
            gpu.density("t", box, bbox=BBOX, width=256, height=256),
            cpu.density("t", box, bbox=BBOX, width=256, height=256))


# -- slice 10: durable datasets on the card ------------------------------------------
def test_save_load_replay_on_the_card(cuda, tmp_path):
    """A flat store saved, loaded on the card (journal attached), journaled
    inserts, a reload that replays them: the loaded store's count, polygon
    count and grids equal the live store's, and both kernels on the loaded
    store's operands equal their plain versions."""
    from geomesa_tpu_torch import config

    live, _ = _datasets(cuda, 300_000, seed=23)
    root = str(tmp_path / "root")
    live.save(root)
    poly = f"INTERSECTS(geom, {_ngon(64, -90, 37, 6)}) AND {DURING}"

    def answers(ds):
        return (ds.count("t", ECQL), ds.count("t", poly),
                ds.density("t", ECQL, bbox=BBOX, width=512, height=512),
                ds.density("t", ECQL, bbox=BBOX, width=512, height=512, weight="weight"))

    with config.DENSITY_PALLAS_MAX_DUP.scoped(1e9):
        loaded = GeoDataset.load(root, compact_min_rows=1, compact_fraction=2.0)
        assert loaded.device.type == "cuda" and loaded._journal is not None
        pip0, den0 = kpip.launches, kg.launches
        got, want = answers(loaded), answers(live)
        assert kpip.launches > pip0 and kg.launches > den0
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[3], want[3], rtol=1e-4, atol=1e-3)
        ex = loaded._executor("t")
        cols = ex.scan_columns(loaded._plan("t", poly), ["geom__x", "geom__y"])
        (x1, *_), packed = kpip.polygon_edge_tables(parse_wkt(_ngon(64, -90, 37, 6)))
        edges = torch.from_numpy(packed).to(cuda)
        assert torch.equal(kpip.pip_mask(cols["geom__x"], cols["geom__y"], edges, len(x1)),
                           kpip.pip_mask_plain(cols["geom__x"], cols["geom__y"], edges, len(x1)))
        o = ex.density_inputs(loaded._plan("t", ECQL), BBOX, 512, 512)
        a = (o["x"], o["y"], o["mask"], o["weight"], BBOX, 512, 512, o["sched"])
        assert torch.equal(kg.density_grouped(*a), kg.density_grouped_plain(*a))
        rng = np.random.default_rng(3)
        extra = {"geom__x": rng.uniform(-100, -80, 500), "geom__y": rng.uniform(30, 45, 500),
                 "dtg": np.full(500, parse_iso_ms("2020-01-10"), "datetime64[ms]"),
                 "weight": rng.uniform(0, 1, 500).astype(np.float32)}
        for ds in (loaded, live):
            ds.insert("t", extra, fids=[f"x{i}" for i in range(500)])
        replayed = GeoDataset.load(root, compact_min_rows=1, compact_fraction=2.0)
        assert replayed._journal_replayed == 1
        got = answers(replayed)
        assert got[:2] == answers(live)[:2]
        np.testing.assert_array_equal(got[2], answers(live)[2])


def test_partitioned_checkpoint_on_the_card(cuda, tmp_path):
    """A partitioned store on the card checkpointed and attached cold: the
    pruned children's answers equal the live store's."""
    gpu = _partitioned(cuda, 2, tmp_path)
    root = str(tmp_path / "root")
    gpu.save(root)
    loaded = GeoDataset.load(root, compact_min_rows=1, compact_fraction=2.0)
    st = loaded._store("t")
    assert not st.partitions and st.count == P_ROWS
    box = f"BBOX(geom, -100, 30, -92, 36) AND {WEEKS}"
    assert loaded.count("t", box) == gpu.count("t", box)
    np.testing.assert_array_equal(
        loaded.density("t", box, bbox=BBOX, width=512, height=512),
        gpu.density("t", box, bbox=BBOX, width=512, height=512))


# -- slice 11: the aggregate cache on the card --------------------------------------
def _dispatches():
    from geomesa_tpu_torch import metrics

    return metrics.registry().counter(metrics.EXEC_DEVICE_DISPATCH).value


def test_cache_zoom_out_on_the_card_launches_nothing(cuda):
    """bench.py's zoom-out with the cache on: the quadrants warm the cells
    on the card, the domain count then launches nothing and equals the
    cache-off scans on the card and on the CPU."""
    from geomesa_tpu_torch import config

    gpu, cpu = _datasets(cuda, 200_000, seed=21)
    quads = [f"BBOX(geom, {b}) AND {DURING}" for b in (
        "-180, -90, 0, 0", "0, -90, 180, 0", "-180, 0, 0, 90", "0, 0, 180, 90")]
    zoom = f"BBOX(geom, -180, -90, 180, 90) AND {DURING}"
    want = gpu.count("t", zoom)
    assert want == cpu.count("t", zoom) > 0
    with config.CACHE_ENABLED.scoped("true"), config.CACHE_CELLS_PER_AXIS.scoped(4):
        d0 = _dispatches()
        assert [gpu.count("t", q) for q in quads] == [cpu.count("t", q) for q in quads]
        assert _dispatches() > d0
        d0 = _dispatches()
        assert gpu.count("t", zoom) == want
        assert _dispatches() == d0
        hits, total = map(int, gpu._plan("t", zoom).exec_path["cache_cells"].split("/"))
        assert hits == total > 0


def test_cache_polygon_region_through_pip_on_the_card(cuda):
    """A polygon region with the cache on: interior cells cached, the
    boundary scanned through pip.cu; count and density bit-identical to
    the cache-off scans, the warm repeat a whole-result hit."""
    from geomesa_tpu_torch import config

    gpu, cpu = _datasets(cuda, 200_000, seed=23)
    poly = _ngon(64, -95, 37, 8)
    off = (gpu.count("t", DURING, region=poly),
           gpu.density("t", DURING, bbox=BBOX, width=256, height=256, region=poly))
    assert off[0] == cpu.count("t", DURING, region=poly) > 0
    with config.CACHE_ENABLED.scoped("true"):
        before = kpip.launches
        n = gpu.count("t", DURING, region=poly)
        path = gpu._plan("t", gpu._with_region("t", DURING, poly)).exec_path
        assert path["cache_region"] == "polygon" and path["cache_boundary_cells"] > 0
        assert kpip.launches > before
        g = gpu.density("t", DURING, bbox=BBOX, width=256, height=256, region=poly)
        d0 = _dispatches()
        assert gpu.count("t", DURING, region=poly) == n == off[0]
        assert _dispatches() == d0
    np.testing.assert_array_equal(g, off[1])


# -- slice 14: tracing on the card -------------------------------------------------
def test_traced_calls_on_the_card_equal_untraced(cuda, monkeypatch):
    """Traced count, density and polygon count equal the untraced calls;
    ``density_grouped.cu`` and ``pip.cu`` launch under ``scan.kernel``
    spans; tracing adds no ``torch.cuda.synchronize``."""
    from geomesa_tpu_torch import config, tracing

    gpu, _ = _datasets(cuda, 200_000, seed=29)
    poly = f"INTERSECTS(geom, {_ngon(64, -95, 37, 8)}) AND {DURING}"
    calls = [lambda: gpu.count("t", ECQL),
             lambda: gpu.density("t", ECQL, bbox=BBOX, width=512, height=512),
             lambda: gpu.count("t", poly)]
    want = [c() for c in calls]
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), real_sync(*a, **k))[1])
    spans = {"pip": [], "grouped": []}
    real_pip, real_dg = kpip.pip_mask, kg.density_grouped

    def pip_mask(*a, **k):
        spans["pip"].append(getattr(tracing.current_span(), "name", None))
        return real_pip(*a, **k)

    def density_grouped(*a, **k):
        spans["grouped"].append(getattr(tracing.current_span(), "name", None))
        return real_dg(*a, **k)

    monkeypatch.setattr(kpip, "pip_mask", pip_mask)
    monkeypatch.setattr(kg, "density_grouped", density_grouped)
    untraced_syncs = len(syncs)
    for c in calls:
        c()
    untraced_syncs = len(syncs) - untraced_syncs
    l_pip, l_dg = kpip.launches, kg.launches
    with config.TRACE_ENABLED.scoped("true"):
        n0 = len(syncs)
        got = []
        for c in calls:
            got.append(c())
            names = [s.name for s in tracing.last_trace().root.children]
            assert "scan.kernel" in names and "scan.sync" in names
        traced_syncs = len(syncs) - n0
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    assert kpip.launches > l_pip and kg.launches > l_dg
    assert spans["pip"][-1] == "scan.kernel" and spans["grouped"][-1] == "scan.kernel"
    assert traced_syncs == untraced_syncs


# -- slice 15: the kernel registry and device utilization on the card --------------------
def _busy_union_ms(prof) -> float:
    """The union of the kernel, memcpy and memset intervals of a
    ``torch.profiler`` run, in ms."""
    import json as _json
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = _json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy / 1e3


def test_device_ms_from_events_covers_the_profiler_busy_union(cuda):
    """``device_ms.0`` of a traced warm call, from the CUDA event pair around
    its dispatch and copy back, lies between 0.9x the profiler's busy union
    of the same call and the call's wall."""
    from torch.profiler import ProfilerActivity, profile

    from geomesa_tpu_torch import config, tracing, utilization

    gpu, _ = _datasets(cuda, 200_000, seed=31)
    poly = f"INTERSECTS(geom, {_ngon(64, -95, 37, 8)}) AND {DURING}"
    calls = {"count": lambda: gpu.count("t", ECQL),
             "density": lambda: gpu.density("t", ECQL, bbox=BBOX, width=512, height=512),
             "polygon": lambda: gpu.count("t", poly)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with config.TRACE_ENABLED.scoped("true"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        tr = tracing.last_trace()
        dev_ms, wall = tr.cost["device_ms.0"], tr.root.duration_ms
        union = _busy_union_ms(prof)
        assert 0 < dev_ms <= wall, (name, dev_ms, wall)
        assert dev_ms >= 0.9 * union, (name, dev_ms, union)
    assert utilization.pending() == 0
    assert 0 < utilization.snapshot()["devices"]["0"]["busy_fraction"] <= 1


def test_registry_hits_on_the_card(cuda):
    """The main path's calls build one scan callable each, then hit it:
    ``kernel`` notes ``trace`` then ``hit``, launches through the kernels on
    every call, and no recompile alert."""
    from geomesa_tpu_torch import metrics
    from geomesa_tpu_torch.kernels import registry as kreg

    gpu, _ = _datasets(cuda, 200_000, seed=33)
    poly = f"INTERSECTS(geom, {_ngon(64, -95, 37, 8)}) AND {DURING}"
    calls = {ECQL: lambda: gpu.count("t", ECQL), poly: lambda: gpu.count("t", poly)}
    kreg.reset_alert()
    reg = gpu._executor("t").kernel_registry()
    for q, fn in calls.items():
        n0 = sum(reg.traces().values())
        l0 = kpip.launches
        fn()
        assert gpu._plan("t", q).exec_path["kernel"] == "trace"
        assert sum(reg.traces().values()) == n0 + 1
        fn()
        assert gpu._plan("t", q).exec_path["kernel"] == "hit"
        assert sum(reg.traces().values()) == n0 + 1
        if q == poly:
            assert kpip.launches >= l0 + 2
    assert metrics.registry().gauge(metrics.KERNEL_RECOMPILE_ALERT).value == 0


@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
def test_einsum_rung_on_the_card(cuda, weight):
    """The einsum rung (``geomesa.density.pallas`` off) on the card: its grid
    equals the CPU's and the grouped kernel's (unweighted bit for bit,
    weighted within rtol 1e-4), at PyTorch's default float32 matmul
    precision, which the run checks it ran under."""
    from geomesa_tpu_torch import config
    from geomesa_tpu_torch.kernels import density_mxu as kmxu

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    gpu, cpu = _datasets(cuda, 200_000, seed=41)
    grid = dict(bbox=BBOX, width=512, height=512, weight=weight)
    before = kg.launches
    grouped = gpu.density("t", ECQL, **grid)
    assert gpu._plan("t", ECQL).exec_path["density_kernel"] == "grouped"
    assert kg.launches > before
    with config.DENSITY_PALLAS.scoped("false"):
        before = kg.launches
        einsum = gpu.density("t", ECQL, **grid)
        assert gpu._plan("t", ECQL).exec_path["density_kernel"] == "mxu-einsum"
        assert kg.launches == before
        on_cpu = cpu.density("t", ECQL, **grid)
        assert cpu._plan("t", ECQL).exec_path["density_kernel"] == "mxu-einsum"
        # the rung's function itself on the card against the CPU, same operands
        ex, plan = gpu._executor("t"), gpu._plan("t", ECQL)
        cols_all = ["geom__x", "geom__y", "weight"]
        setup = ex._scan_setup(plan, cols_all)
        ex._maybe_compact(plan, setup)
        cols, m = ex._fused(plan, setup, cols_all)
        rung, sched = ex._density_rung(plan, setup, BBOX, 512, 512)
        assert rung == "mxu-einsum"
        w = None if weight is None else cols["weight"]
        got = kmxu.density_grid_pairs(cols["geom__x"], cols["geom__y"], m, BBOX, 512, 512,
                                      w, sched)
        cpu_sched = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                     for k, v in sched.items()}
        want = kmxu.density_grid_pairs(cols["geom__x"].cpu(), cols["geom__y"].cpu(), m.cpu(),
                                       BBOX, 512, 512, None if w is None else w.cpu(),
                                       cpu_sched)
    assert einsum.sum() > 0
    if weight is None:
        assert np.array_equal(einsum, grouped)
        assert np.array_equal(einsum, on_cpu)
        assert torch.equal(got.cpu(), want)
    else:
        assert np.allclose(einsum, grouped, rtol=1e-4, atol=1e-3)
        assert np.allclose(einsum, on_cpu, rtol=1e-4, atol=1e-3)
        assert torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-3)


def test_pip_kernel_on_an_s3_tables_compacted_layout(cuda):
    """An ``INTERSECTS`` polygon on an s3 table: the compacted [C, B] point
    columns through ``pip.cu`` equal its plain version, and the count
    equals the CPU's."""
    rng = np.random.default_rng(43)
    n = 200_000
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }
    out = []
    for dev in (cuda, "cpu"):
        ds = GeoDataset(n_shards=4, device=dev, compact_min_rows=1, compact_fraction=2.0)
        ds.create_schema("t", SPEC + ";geomesa.indices='s3,id'")
        ds.insert("t", data)
        ds.flush("t")
        out.append(ds)
    gpu, cpu = out
    wkt = _ngon(64, -90, 37, 6)
    q = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    plan = gpu._plan("t", q)
    assert plan.index_name == "s3"
    ex = gpu._executor("t")
    cols = ex.scan_columns(plan, ["geom__x", "geom__y"])
    x, y = cols["geom__x"], cols["geom__y"]
    assert x.dim() == 2 and ex._cache(plan)["compact"] is not None
    (x1, *_), packed = kpip.polygon_edge_tables(parse_wkt(wkt))
    edges = torch.from_numpy(packed).to(cuda)
    before = kpip.launches
    got = kpip.pip_mask(x, y, edges, len(x1))
    assert kpip.launches == before + 1
    assert torch.equal(got, kpip.pip_mask_plain(x, y, edges, len(x1)))
    before = kpip.launches
    assert gpu.count("t", q) == cpu.count("t", q) > 0
    assert kpip.launches > before
    assert gpu._plan("t", q).exec_path["scan"] == "device-compact"


# -- slice 18: the streaming tier on the card ---------------------------------------
def test_stream_density_and_lambda_polygon_count_on_the_card(cuda):
    """The live window's density binned on the card equals the CPU's f32
    grid bit for bit; the Lambda store's merged polygon count equals the
    CPU's and its cold tier launches pip.cu; the merged f64 density equals
    the CPU's."""
    from geomesa_tpu_torch import stream

    n, t0 = 20_000, parse_iso_ms("2020-01-05")
    rng = np.random.default_rng(18)
    x, y = rng.uniform(-120, -70, n), rng.uniform(25, 50, n)
    data = {"weight": rng.uniform(0, 1, n).astype(np.float32),
            "dtg": t0 + np.arange(n, dtype=np.int64) * 1000,
            "geom": list(zip(x.tolist(), y.tolist()))}
    fids = [f"f{i}" for i in range(n)]
    ts = [t0 + (i % 2) * 10_000_000 + i for i in range(n)]
    out = []
    for dev in (cuda, "cpu"):
        cold = GeoDataset(n_shards=4, device=dev, compact_min_rows=1, compact_fraction=2.0)
        lam = stream.LambdaDataset(cold, stream.StreamingDataset(device=dev))
        lam.create_schema("t", SPEC)
        lam.write("t", data, fids, ts_ms=ts)
        out.append(lam)
    gpu, cpu = out
    grid = gpu.transient.density("t", ECQL, bbox=BBOX, width=512, height=512)
    assert np.array_equal(grid, cpu.transient.density("t", ECQL, bbox=BBOX, width=512,
                                                      height=512))
    assert grid.sum() == gpu.transient.count("t", ECQL) > 0
    now = t0 + 10_000_000 - 1
    assert gpu.run_persistence(now_ms=now) == cpu.run_persistence(now_ms=now) == n // 2
    q = f"INTERSECTS(geom, {_ngon(64, -95, 37, 8)}) AND {DURING}"
    before = kpip.launches
    assert gpu.count("t", q) == cpu.count("t", q) > 0
    assert kpip.launches > before
    np.testing.assert_array_equal(
        gpu.density("t", q, bbox=BBOX, width=256, height=256),
        cpu.density("t", q, bbox=BBOX, width=256, height=256))
