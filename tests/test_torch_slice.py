"""PyTorch port vs the JAX package over the whole slice: ingest state, scan
windows, the compiled filter, end-to-end count / density answers, state
carried across, and the port's boundaries.

Both packages ingest the same 40k rows made from a NumPy seed into 4 shards;
the JAX side runs its Pallas kernels in interpret mode with compaction
forced (as tests/test_density_pallas.py does), the port runs on the CPU
with its kernels' plain versions."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config
from geomesa_tpu import native
from geomesa_tpu.filter import compile_filter as jcompile
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.index import keyspace as jks
from geomesa_tpu.schema.feature_type import FeatureType as JFeatureType
from geomesa_tpu_torch import GeoDataset
from geomesa_tpu_torch.api.dataset import Query
from geomesa_tpu_torch.convert import store_from_arrays
from geomesa_tpu_torch.curves.cover import zcover
from geomesa_tpu_torch.filter.compile import compile_filter
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.schema.feature_type import FeatureType

REPO = Path(__file__).resolve().parent.parent
SPEC = "weight:Float,dtg:Date,*geom:Point"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
ECQL = f"BBOX(geom, -100, 30, -80, 45) AND {DURING}"
BBOX = (-100.0, 30.0, -80.0, 45.0)
POLY = ("POLYGON((-95 32, -85 33, -82 40, -90 44, -98 41, -95 32), "
        "(-92 37, -88 37, -88 39, -92 39, -92 37))")
ECQL_POLY = f"INTERSECTS(geom, {POLY}) AND {DURING}"
QUERIES = {"bbox": ECQL, "polygon": ECQL_POLY}


def _data(n=40_000, seed=13):
    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }
    # rows on the query's f32 bounds: the band the host corrects exactly
    data["geom__x"][:40] = -100.0
    data["geom__y"][40:80] = 45.0
    data["geom__x"][80:120] = np.nextafter(-80.0, -79.0)
    return data


@pytest.fixture(scope="module")
def pair():
    data = _data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        try:
            j = JGeoDataset(n_shards=4)
            j.create_schema("t", SPEC)
            j.insert("t", data, fids=np.arange(len(data["dtg"])).astype(str))
            j.flush("t")
            p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            p.create_schema("t", SPEC)
            p.insert("t", data)
            p.flush("t")
            yield j, p, data
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)


def _oracle_mask(data):
    x, y = data["geom__x"], data["geom__y"]
    t = data["dtg"].astype(np.int64)
    return ((x >= -100) & (x <= -80) & (y >= 30) & (y <= 45)
            & (t >= parse_iso_ms("2020-01-05")) & (t <= parse_iso_ms("2020-01-15")))


# -- ingest --------------------------------------------------------------------
def test_ingest_state_equal(pair):
    j, p, _ = pair
    jt, pt = j._store("t").tables["z3"], p._store("t").tables["z3"]
    assert jt.key_shifts == pt.key_shifts
    assert np.array_equal(jt.order, pt.order)
    assert np.array_equal(jt.shard_bounds, pt.shard_bounds)
    assert jt.shard_len == pt.shard_len
    for k in ("__z3_bin", "__z3"):
        assert jt.key_columns[k].dtype == pt.key_columns[k].dtype
        assert np.array_equal(jt.key_columns[k], pt.key_columns[k]), k
    for k in ("geom__x", "geom__y", "dtg__bin", "dtg__off", "weight"):
        assert np.array_equal(jt.col_sorted(k), pt.col_sorted(k)), k


@pytest.mark.parametrize("name", sorted(QUERIES))
@pytest.mark.parametrize("cover", [2000, 32768], ids=["planner", "fine"])
def test_windows_equal(pair, name, cover):
    """Scan windows from NumPy searchsorted equal the JAX package's (which
    resolves through native C++ where it is built), at the planner's range
    budget and at the compacted path's fine cover."""
    j, p, _ = pair
    jst, _, jplan = j._plan("t", QUERIES[name])
    assert jplan.index_name == "z3"
    jt, pt = jst.tables["z3"], p._store("t").tables["z3"]
    with config.SCAN_RANGES_TARGET.scoped(cover), jks.window_cap(
            max(cover, jks.MAX_SHARD_WINDOWS)):
        jkp = jt.keyspace.plan(jst.ft, jplan.filter)
        want = jt.windows(jkp)
    pst = p._store("t")
    pkp = pt.keyspace.plan(pst.ft, parse_ecql(QUERIES[name]), cover)
    got = pt.windows(pkp, cap=max(cover, jks.MAX_SHARD_WINDOWS))
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("budget", [64, 2000, 32768])
def test_zcover_matches_the_jax_cover(budget):
    from geomesa_tpu.curves.cover import zcover as jzcover

    rng = np.random.default_rng(budget)
    for _ in range(3):
        lo = rng.integers(0, 1 << 20, 3)
        hi = lo + rng.integers(1, 1 << 16, 3)
        want = (native.zcover if native.available() else jzcover)(
            lo, hi, 21, 3, budget)
        assert [tuple(r) for r in zcover(lo, hi, 21, 3, budget)] == \
            [tuple(r) for r in want]


# -- filter --------------------------------------------------------------------
FILTERS = {
    "bbox_during": ECQL,
    "polygon": ECQL_POLY,
    "not_bbox": f"NOT BBOX(geom, -100, 30, -80, 45) AND {DURING}",
    "bbox_or_polygon": f"(BBOX(geom, -110, 26, -105, 30) OR INTERSECTS(geom, {POLY})) AND {DURING}",
    "disjoint": f"DISJOINT(geom, {POLY}) AND dtg AFTER 2020-01-20T00:00:00Z",
    "multipolygon": ("INTERSECTS(geom, MULTIPOLYGON(((-95 32, -85 33, -90 44, -95 32)),"
                     " ((-110 30, -104 30, -107 35, -110 30)))) AND "
                     "dtg BEFORE 2020-01-10T00:00:00Z"),
    "include": "INCLUDE",
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_compiled_mask_and_band_equal(pair, name):
    _, p, data = pair
    text = FILTERS[name]
    dcols = p._store("t").tables["z3"]._master  # ingest order, f64 coordinates
    cols64 = {k: dcols[k] for k in ("geom__x", "geom__y", "dtg__bin", "dtg__off")}
    cols32 = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
              for k, v in cols64.items()}
    jc = jcompile(jparse(text), JFeatureType.from_spec("t", SPEC), {})
    pc = compile_filter(parse_ecql(text), FeatureType.from_spec("t", SPEC))
    assert pc.columns == jc.columns
    n = len(cols32["geom__x"])
    want = np.broadcast_to(np.asarray(jc(cols32, np)), (n,))
    got = pc({k: torch.from_numpy(v) for k, v in cols32.items()}, torch)
    assert np.array_equal(np.broadcast_to(np.asarray(got), (n,)), want)
    assert (jc.band is None) == (pc.band is None)
    if pc.band is not None:
        bj = np.asarray(jc.band(cols64, np))
        if "BBOX(geom, -100, 30, -80, 45)" in text:
            assert bj.any()  # the fixture's boundary rows are in the band
        assert np.array_equal(np.asarray(pc.band(cols64, np)), bj)
        tb = pc.band({k: torch.from_numpy(v) for k, v in cols32.items()}, torch)
        assert np.array_equal(tb.numpy(), np.asarray(jc.band(cols32, np)))
        assert np.array_equal(np.asarray(pc.refine(cols64, np)),
                              np.asarray(jc.refine(cols64, np)))


# -- end to end ------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_count_equal(pair, name):
    j, p, data = pair
    got = p.count("t", QUERIES[name])
    assert got == j.count("t", QUERIES[name])
    assert p._plan("t", QUERIES[name]).exec_path["scan"] == "device-compact"
    if name == "bbox":
        assert got == int(_oracle_mask(data).sum())
        assert p._plan("t", ECQL).exec_path["band_rows"] > 0


@pytest.mark.parametrize("grid", [(256, 256), (300, 200)], ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("weight", [None, "weight"], ids=["count", "weighted"])
def test_density_equal(pair, grid, weight):
    j, p, _ = pair
    W, H = grid
    want = j.density("t", ECQL, bbox=BBOX, width=W, height=H, weight=weight)
    got = p.density("t", ECQL, bbox=BBOX, width=W, height=H, weight=weight)
    path = p._plan("t", ECQL).exec_path
    assert path["scan"] == "device-compact" and path["density_kernel"] == "grouped"
    assert got.dtype == np.float32 and got.shape == (H, W)
    if weight is None:
        assert np.array_equal(got, want)
    else:
        assert np.allclose(got, want, rtol=1e-4, atol=1e-3)
        assert abs(got.sum() - want.sum()) / max(want.sum(), 1) < 1e-4


def test_padded_layout_equal(pair):
    """Below the compaction threshold the port scans the padded [S, L]
    layout (window mask + scatter): same answers."""
    j, p, _ = pair
    padded = GeoDataset(n_shards=4, device="cpu")
    padded.attach_store(p._store("t"))
    assert padded.count("t", ECQL) == j.count("t", ECQL)
    assert padded.count("t", ECQL_POLY) == j.count("t", ECQL_POLY)
    g = padded.density("t", ECQL, bbox=BBOX, width=256, height=256)
    path = padded._plan("t", ECQL).exec_path
    assert path["scan"] == "device-padded" and path["density_kernel"] == "scatter"
    assert np.array_equal(g, j.density("t", ECQL, bbox=BBOX, width=256, height=256))


def test_chunk_at_the_table_end():
    """Full shards (n = 4 x 8192) and a window reaching the last rows: the
    final slabs start early (``lo > 0``) and never read past the table."""
    n = 4 * 8192
    rng = np.random.default_rng(9)
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, n), "geom__y": rng.uniform(25, 50, n),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-01"), n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }
    ds = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1, compact_fraction=2.0)
    ds.create_schema("t", SPEC)
    ds.insert("t", data)
    ds.flush("t")
    q = ("BBOX(geom, -110, 30, -75, 48) AND "
         "dtg DURING 2020-01-10T12:00:00Z/2020-03-01T00:00:00Z")
    x, y, t = data["geom__x"], data["geom__y"], data["dtg"].astype(np.int64)
    want = ((x >= -110) & (x <= -75) & (y >= 30) & (y <= 48)
            & (t >= parse_iso_ms("2020-01-10T12:00:00"))).sum()
    assert ds.count("t", q) == want
    d = ds._plan("t", q).__dict__["_exec_cache"]["compact"]
    assert (d["lo"] > 0).any()
    assert (d["cstart"].astype(np.int64) + d["B"] <= 4 * ds._store("t").tables["z3"].shard_len).all()
    g = ds.density("t", q, bbox=(-110, 30, -75, 48), width=200, height=100)
    assert g.sum() == want


def test_two_flushes_answer_as_the_jax_package():
    """A second insert + flush merges the fresh rows into the table under
    its old key shift, in both packages: the answers agree."""
    data = _data(n=20_000, seed=21)
    more = _data(n=12_000, seed=22)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        config.COMPACT_MIN_ROWS.set(1)
        config.COMPACT_FRACTION.set(2.0)
        try:
            j = JGeoDataset(n_shards=4)
            j.create_schema("t", SPEC)
            p = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                           compact_fraction=2.0)
            p.create_schema("t", SPEC)
            for part in (data, more):
                j.insert("t", part, fids=np.arange(len(part["dtg"])).astype(str))
                j.flush("t")
                p.insert("t", part)
                p.flush("t")
            for q in QUERIES.values():
                assert p.count("t", q) == j.count("t", q)
            assert np.array_equal(
                p.density("t", ECQL, bbox=BBOX, width=128, height=128),
                j.density("t", ECQL, bbox=BBOX, width=128, height=128))
        finally:
            config.COMPACT_MIN_ROWS.set(None)
            config.COMPACT_FRACTION.set(None)


def _wide_data(n, seed):
    """Rows over thirty years: their time bins span so many bits that the
    keys cannot be quantized with a one-month table's shift."""
    data = _data(n=n, seed=seed)
    rng = np.random.default_rng(seed)
    data["dtg"] = rng.integers(parse_iso_ms("2000-01-01"), parse_iso_ms("2030-01-01"),
                               n).astype("datetime64[ms]")
    return data


@pytest.mark.parametrize("flushes", [2, 3, 4])
def test_lsm_append_state_equal(flushes):
    """Flush by flush, the port's table state equals the JAX store's: the
    second batch merges under the first's key shift, the third (thirty
    years of bins) forces a full rebuild with a coarser shift, the fourth
    merges under that one."""
    parts = [_data(n=20_000, seed=31), _data(n=7_000, seed=32),
             _wide_data(5_000, 33), _data(n=3_000, seed=34)][:flushes]
    j = JGeoDataset(n_shards=4)
    j.create_schema("t", SPEC)
    p = GeoDataset(n_shards=4, device="cpu")
    p.create_schema("t", SPEC)
    shifts, start = [], 0
    for part in parts:
        n = len(part["dtg"])
        j.insert("t", part, fids=np.arange(start, start + n).astype(str))
        j.flush("t")
        p.insert("t", part)
        p.flush("t")
        start += n
        jt, pt = j._store("t").tables["z3"], p._store("t").tables["z3"]
        assert jt.key_shifts == pt.key_shifts
        assert np.array_equal(jt.order, pt.order)
        assert np.array_equal(jt.shard_bounds, pt.shard_bounds)
        for k in ("__z3_bin", "__z3"):
            assert jt.key_columns[k].dtype == pt.key_columns[k].dtype
            assert np.array_equal(jt.key_columns[k], pt.key_columns[k]), k
        for k in ("geom__x", "dtg__off", "weight"):
            assert np.array_equal(jt.col_sorted(k), pt.col_sorted(k)), k
        shifts.append(pt.key_shifts["__z3"])
    assert shifts[:2] == [shifts[0]] * min(2, flushes)  # the merge keeps the shift
    if flushes >= 3:
        assert shifts[2] > shifts[1]  # the wide batch forced a rebuild
        assert shifts[3:] == [shifts[2]] * (flushes - 3)
    for q in QUERIES.values():
        assert p.count("t", q) == j.count("t", q)


@pytest.mark.parametrize("q", [
    "EXCLUDE",
    f"BBOX(geom, -100, 30, -80, 45) AND {DURING} AND BBOX(geom, 0, 0, 1, 1)",
    "BBOX(geom, -100, 30, -80, 45) AND dtg DURING 2021-01-05T00:00:00Z/2021-01-15T00:00:00Z",
], ids=["exclude", "disjoint_boxes", "no_rows_in_time"])
def test_empty_answers(pair, q):
    j, p, _ = pair
    assert p.count("t", q) == 0 == j.count("t", q)
    g = p.density("t", q, bbox=BBOX, width=32, height=16)
    assert g.shape == (16, 32) and not g.any()


def test_empty_store():
    p = GeoDataset(n_shards=4, device="cpu")
    p.create_schema("t", SPEC)
    assert p.count("t", ECQL) == 0
    assert not p.density("t", ECQL, bbox=BBOX, width=8, height=8).any()


def test_default_bbox_is_the_data_bounds(pair):
    j, p, _ = pair
    assert np.array_equal(p.density("t", ECQL, width=64, height=32),
                          j.density("t", ECQL, width=64, height=32))


def test_carry_across(pair):
    """A port store rebuilt from the JAX store's arrays, without
    re-sorting, answers as the JAX package does."""
    j, _, _ = pair
    jst = j._store("t")
    jt = jst.tables["z3"]
    names = ("geom__x", "geom__y", "dtg", "dtg__bin", "dtg__off", "weight")
    arrays = {
        "master": {k: jt._master[k] for k in names},
        "tables": {"z3": {"keys": dict(jt.key_columns), "order": jt.order,
                          "shard_bounds": jt.shard_bounds,
                          "key_shifts": jt.key_shifts}},
        "device": {"z3": {k: jt.col_sorted(k).astype(np.float32)
                          for k in ("geom__x", "geom__y")}},
    }
    st = store_from_arrays(SPEC, arrays, 4, device="cpu", name="t")
    p2 = GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                    compact_fraction=2.0)
    p2.attach_store(st)
    for q in QUERIES.values():
        assert p2.count("t", q) == j.count("t", q)
    for w in (None, "weight"):
        got = p2.density("t", ECQL, bbox=BBOX, width=256, height=256, weight=w)
        want = j.density("t", ECQL, bbox=BBOX, width=256, height=256, weight=w)
        assert np.allclose(got, want, rtol=1e-4, atol=1e-3)
        if w is None:
            assert np.array_equal(got, want)
    bad = dict(arrays, device={"z3": {"geom__x": arrays["device"]["z3"]["geom__y"]}})
    with pytest.raises(ValueError):
        store_from_arrays(SPEC, bad, 4, device="cpu")


# -- boundaries ------------------------------------------------------------------
def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list((REPO / "geomesa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
))
def test_port_imports_no_jax(path):
    for mod in _imports(REPO / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "geomesa_tpu"), f"{path} imports {mod}"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        GeoDataset(device="cuda")
    with pytest.raises(RuntimeError):
        GeoDataset()


REGION = "POLYGON((-95 32, -85 32, -90 40, -95 32))"


@pytest.mark.parametrize("call", ["query_object", "estimate"])
def test_unserved_queries_name_the_roadmap(pair, call):
    j, p, _ = pair
    if call == "estimate":
        # served since the query-axis batches: an estimate never scans, so
        # there is nothing to batch, and both packages give None
        assert p.count_batch("t", [ECQL], exact=False) is None
        assert j.count_batch("t", [ECQL], exact=False) is None
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p.query("t", Query(ECQL, srid=3857))


@pytest.mark.parametrize("call", ["expression", "non_point_dwithin", "extent_geometry",
                                  "region"])
def test_once_unserved_queries_are_served(pair, call):
    """Expressions, DWITHIN with a line literal, polygon schemas and
    ``region=`` are served, with the JAX package's answers."""
    j, p, _ = pair
    if call == "region":
        got = p.stats("t", "Count();MinMax(weight)", ECQL, region=REGION)
        want = j.stats("t", "Count();MinMax(weight)", ECQL, region=REGION)
        assert [s.value() for s in got.stats] == [s.value() for s in want.stats]
        assert got.stats[0].value() == p.count("t", f"{ECQL} AND INTERSECTS(geom, {REGION})") > 0
        return
    if call == "extent_geometry":
        spec = "dtg:Date,*geom:Polygon"
        jd, pd = JGeoDataset(n_shards=4), GeoDataset(n_shards=4, device="cpu")
        data = {"dtg": np.full(3, np.datetime64("2020-01-07", "ms")),
                "geom": ["POLYGON ((-95 32, -85 32, -90 40, -95 32))",
                         "POLYGON ((0 0, 1 0, 1 1, 0 0))",
                         "POLYGON ((-91 35, -89 35, -89 36, -91 35))"]}
        for ds in (jd, pd):
            ds.create_schema("u", spec)
            ds.insert("u", data, fids=["a", "b", "c"])
        q = f"INTERSECTS(geom, {REGION}) AND {DURING}"
        assert list(pd._store("u").tables) == list(jd._store("u").tables)
        assert sorted(pd.query("u", q).fids) == sorted(jd.query("u", q).fids) == ["a", "c"]
        return
    q = {
        "expression": f"weight * 2 > 1 AND {DURING}",
        "non_point_dwithin": "DWITHIN(geom, LINESTRING(-100 30, -90 40), 1000, meters)",
    }[call]
    assert p.count("t", q) == j.count("t", q)
