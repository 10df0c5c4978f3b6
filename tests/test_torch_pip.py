"""PyTorch port vs the JAX package: the point-in-polygon kernel module.

The port's plain version (what its wrapper runs for CPU tensors) is held
exactly against the JAX Pallas kernel run in interpret mode, on the same
NumPy points; the edge tables must be byte-identical."""

import math

import numpy as np
import pytest
import torch

from geomesa_tpu.kernels import pallas_kernels as pk
from geomesa_tpu.utils.geometry import parse_wkt as jparse_wkt
from geomesa_tpu_torch.kernels import pip as tpip
from geomesa_tpu_torch.utils.geometry import parse_wkt

TRIANGLE = "POLYGON ((0 0, 10 0, 5 8, 0 0))"
DONUT = (
    "POLYGON ((0 0, 20 0, 20 20, 0 20, 0 0), (5 5, 15 5, 15 15, 5 15, 5 5))"
)


def _ngon(n: int, cx=10.0, cy=10.0, r=9.0) -> str:
    pts = []
    for k in range(n):
        a = 2 * math.pi * k / n
        rr = r * (1 + 0.2 * math.sin(7 * a))
        pts.append((round(cx + rr * math.cos(a), 6), round(cy + rr * math.sin(a), 6)))
    pts.append(pts[0])
    return "POLYGON ((" + ", ".join(f"{x} {y}" for x, y in pts) + "))"


POLY64 = _ngon(64)


@pytest.mark.parametrize("wkt", [TRIANGLE, DONUT, POLY64],
                         ids=["triangle", "donut", "poly64"])
def test_edge_tables_byte_identical(wkt):
    (f64_t, packed_t) = tpip.polygon_edge_tables(parse_wkt(wkt))
    (f64_j, packed_j) = pk.polygon_edge_tables(jparse_wkt(wkt))
    assert packed_t.dtype == packed_j.dtype == np.float32
    assert packed_t.tobytes() == packed_j.tobytes()
    for a, b in zip(f64_t, f64_j):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("wkt", [TRIANGLE, DONUT, POLY64],
                         ids=["triangle", "donut", "poly64"])
@pytest.mark.parametrize("shape", [(3001,), (4, 777)], ids=["1d", "2d"])
def test_plain_matches_pallas_interpret(wkt, shape):
    import jax.numpy as jnp

    _, packed = tpip.polygon_edge_tables(parse_wkt(wkt))
    rng = np.random.default_rng(11)
    x = rng.uniform(-2, 22, shape).astype(np.float32)
    y = rng.uniform(-2, 22, shape).astype(np.float32)
    want = np.asarray(pk.pip_mask(jnp.asarray(x), jnp.asarray(y), packed,
                                  interpret=True))
    got = tpip.pip_mask(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(packed))
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size  # the polygon splits the points


def test_real_edge_count_equals_padded_table():
    """Passing the real edge count gives what the padded table gives:
    padding columns never cross."""
    (x1, *_), packed = tpip.polygon_edge_tables(parse_wkt(DONUT))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-2, 22, 5000).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-2, 22, 5000).astype(np.float32))
    e = torch.from_numpy(packed)
    assert torch.equal(tpip.pip_mask(x, y, e, len(x1)), tpip.pip_mask(x, y, e))


def test_cpu_tensors_take_the_plain_version_without_launching():
    _, packed = tpip.polygon_edge_tables(parse_wkt(TRIANGLE))
    before = tpip.launches
    tpip.pip_mask(torch.zeros(10), torch.zeros(10), torch.from_numpy(packed))
    assert tpip.launches == before


@pytest.mark.parametrize("wkt", [TRIANGLE, DONUT, POLY64],
                         ids=["triangle", "donut", "poly64"])
def test_span_pairs_counts_the_crossing_tests(wkt):
    """``span_pairs`` (the culling bound's count) equals its definition,
    the (point, edge) pairs with ``(y1 > y) != (y2 > y)`` over the f32
    table, with points on the vertices' own y values and NaN among them."""
    (x1, y1, *_), packed = tpip.polygon_edge_tables(parse_wkt(wkt))
    rng = np.random.default_rng(5)
    y = np.concatenate([rng.uniform(-2, 22, 2000), y1, [np.nan, -5.0, 30.0]])
    y = y.astype(np.float32)
    e1, e2 = packed[1, :len(x1)], packed[2, :len(x1)]
    want = int(((e1 > y[:, None]) != (e2 > y[:, None])).sum())
    assert want > 0
    assert tpip.span_pairs(y, packed, len(x1)) == want
    assert tpip.span_pairs(y, packed) == want  # padding edges never span
