"""CUDA kernels of geomesa_tpu_torch against their plain PyTorch versions.

Marked ``gpu``: each test needs a CUDA device and skips (from inside the
``cuda`` fixture) without one. This file imports no JAX, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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
    "edges1500": _ngon(1500),  # more than one 1024-edge shared-memory tile
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
@pytest.mark.parametrize("shape", [(1,), (255,), (257,), (3, 1001), ((1 << 20) + 3,)],
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


@pytest.mark.parametrize("grid", [(512, 512), (300, 200), (129, 127)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
def test_density_kernel_matches_plain(cuda, grid, weight):
    W, H = grid
    gpu, cpu = _datasets(cuda, 40_000)
    ex = gpu._executor("t")
    plan = gpu._plan("t", ECQL)
    ops = ex.density_inputs(plan, BBOX, W, H, weight)
    assert ops is not None, "the query did not take the grouped rung"
    before = kg.launches
    got = kg.density_grouped(ops["x"], ops["y"], ops["w"], BBOX, W, H, ops["sched"])
    torch.cuda.synchronize()
    assert kg.launches == before + 1
    want = kg.density_grouped_plain(ops["x"], ops["y"], ops["w"], BBOX, W, H, ops["sched"])
    if weight is None:
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    # through the API, against the CPU dataset's plain path
    g_gpu = gpu.density("t", ECQL, bbox=BBOX, width=W, height=H, weight=weight)
    g_cpu = cpu.density("t", ECQL, bbox=BBOX, width=W, height=H, weight=weight)
    if weight is None:
        assert np.array_equal(g_gpu, g_cpu)
    else:
        assert np.allclose(g_gpu, g_cpu, rtol=1e-4, atol=1e-3)


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
