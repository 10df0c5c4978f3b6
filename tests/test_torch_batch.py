"""PyTorch port vs the JAX package: query-axis batches (``count_batch``,
``density_batch``, ``stats_batch``), their templates and specs, on flat
and time-partitioned point stores.

Both packages ingest the same rows made from a NumPy seed (the fixtures
of tests/test_query_batch.py, plus a Long column and rows planted on some
boxes' f32 bounds). The JAX side runs with one device
(``geomesa.mesh.devices`` 1) and, on the CPU, its point-in-polygon test
through the plain reference rather than the Pallas kernel.
Every batch member equals the port's own serial call bit for bit (counts,
grids, sketches) and the JAX package's batch; every call that gives None
in the JAX package gives None in the port, and no other.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.api.dataset import Query as JQuery
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.filter import template as jtpl
from geomesa_tpu.kernels import density as jdensity
from geomesa_tpu.kernels import masks as jmasks
from geomesa_tpu.kernels import registry as jregistry
from geomesa_tpu.kernels import stats_scan as jstats
from geomesa_tpu.stats import parse_stat as jparse_stat
from geomesa_tpu_torch import GeoDataset, Query
from geomesa_tpu_torch.filter import template as ftpl
from geomesa_tpu_torch.filter.ecql import parse_ecql
from geomesa_tpu_torch.kernels import density as kdensity
from geomesa_tpu_torch.kernels import masks as kmasks
from geomesa_tpu_torch.kernels import registry
from geomesa_tpu_torch.kernels import stats_scan as kstats
from geomesa_tpu_torch.planning import batch as pbatch
from geomesa_tpu_torch.stats import parse_stat

SPEC = "speed:Float,kind:String,code:Long,dtg:Date,*geom:Point"
PSPEC = "speed:Float,dtg:Date,*geom:Point;geomesa.partition='time'"
TRI = "POLYGON((-30 -20, 25 -15, 0 30, -30 -20))"
#: boxes whose f32 bounds hold planted rows (band corrections)
BANDED = [(-20.0, -10.0, 20.0, 10.0), (-35.5, -5.25, 12.75, 33.0)]
STATS = ("Count()", "MinMax(speed)", "Histogram(speed,12,0,100)",
         "Enumeration(kind)", "TopK(kind,2)", "Count();MinMax(speed);Enumeration(kind)")


def _bbox_ecql(b, extra="speed > 20"):
    base = f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]})"
    return f"{base} AND {extra}" if extra else base


def _rand_boxes(rng, m):
    out = []
    for _ in range(m):
        x0 = float(rng.uniform(-70, 30))
        y0 = float(rng.uniform(-35, 15))
        out.append((x0, y0, x0 + float(rng.uniform(5, 60)),
                    y0 + float(rng.uniform(5, 30))))
    return out


def _ms(s):
    return np.datetime64(s).astype("datetime64[ms]").astype(np.int64)


def _flat_data():
    rng = np.random.default_rng(11)
    n = 3000
    t0 = _ms("2024-01-01T00:00:00")
    x, y = rng.uniform(-80, 80, n), rng.uniform(-40, 40, n)
    # planted on the banded boxes' bounds, inside them
    for i, (x0, y0, x1, y1) in enumerate(BANDED):
        x[10 * i:10 * i + 5] = x0
        y[10 * i:10 * i + 5] = (y0 + y1) / 2
        x[10 * i + 5:10 * i + 10] = (x0 + x1) / 2
        y[10 * i + 5:10 * i + 10] = y1
    return {
        "speed": rng.uniform(0, 100, n),
        "kind": rng.choice(["a", "b", "c"], n),
        "code": rng.integers(0, 1 << 40, n),
        "dtg": (t0 + rng.integers(0, 90 * 86400 * 1000, n)).astype("datetime64[ms]"),
        "geom": list(zip(x, y)),
    }


def _part_data():
    rng = np.random.default_rng(13)
    n = 2200
    t0 = _ms("2024-01-01T00:00:00")
    # two weeks: three weekly partitions (the JAX side compiles a batch's
    # kernel once per partition)
    return {
        "speed": rng.uniform(0, 100, n),
        "dtg": (t0 + rng.integers(0, 14 * 86400 * 1000, n)).astype("datetime64[ms]"),
        "geom": list(zip(rng.uniform(-80, 80, n), rng.uniform(-40, 40, n))),
    }


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores (ten times slower beside seven busy processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """{"flat": (JAX, port), "partitioned": (JAX, port)}."""
    jconfig.MESH_DEVICES.set(1)
    try:
        out = {}
        for kind, spec, data, shards in (("flat", SPEC, _flat_data(), 4),
                                         ("partitioned", PSPEC, _part_data(), 2)):
            fids = np.arange(len(data["speed"])).astype(str)
            both = []
            for ds in (JGeoDataset(n_shards=shards), GeoDataset(n_shards=shards, device="cpu")):
                ds.create_schema("pts", spec)
                if kind == "partitioned":
                    ds._store("pts")._spill_dir = str(tmp_path_factory.mktemp("spill"))
                ds.insert("pts", data, fids=fids)
                ds.flush("pts")
                both.append(ds)
            out[kind] = tuple(both)
        yield out
    finally:
        jconfig.MESH_DEVICES.set(None)


def _jq(q):
    return JQuery(**vars(q)) if isinstance(q, Query) else q


# -- helpers shared with the reference --------------------------------------
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 100])
def test_bucket_batch_and_count_equal_jax(n):
    assert registry.bucket_batch(n) == jregistry.bucket_batch(n)
    assert registry.bucket_count(n) == jregistry.bucket_count(n)


@pytest.mark.parametrize("member", [0, 2, 3])
def test_window_mask_batch_equals_jax(member):
    rng = np.random.default_rng(5)
    S, K, L, Mp = 3, 4, 40, 4
    starts = np.sort(rng.integers(0, L, (Mp, S, K)), axis=2).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, 6, (Mp, S, K)), L).astype(np.int32)
    # windows never overlap within a shard
    ends[:, :, :-1] = np.minimum(ends[:, :, :-1], starts[:, :, 1:])
    starts[3], ends[3] = 0, 0  # a padded member
    counts = np.array([40, 31, 0], np.int32)
    got = kmasks.window_mask_batch(*(torch.from_numpy(a) for a in (starts, ends, counts)),
                                   L, member)
    want = jmasks.window_mask_batch(starts, ends, counts, L, member)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if member == 3:
        assert not got.any()


@pytest.mark.parametrize("weighted", [False, True])
def test_density_grid_at_equals_jax(weighted):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    x = rng.uniform(-10, 10, (4, 500)).astype(np.float32)
    y = rng.uniform(-5, 5, (4, 500)).astype(np.float32)
    m = rng.uniform(size=(4, 500)) < 0.4
    w = rng.uniform(0, 3, (4, 500)).astype(np.float32) if weighted else None
    bbox = (-7.3, -4.1, 8.2, 3.3)
    gp = kdensity.grid_params(bbox)
    assert np.array_equal(gp, jdensity.grid_params(bbox))
    g = torch.from_numpy(gp)
    got = kdensity.density_grid_at(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(m), g[0], g[1], g[2], g[3],
        24, 16, None if w is None else torch.from_numpy(w))
    want = jdensity.density_grid_at(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), *(jnp.float32(v) for v in gp),
        24, 16, None if w is None else jnp.asarray(w), jnp)
    if weighted:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))
    serial = kdensity.density_grid(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(m), bbox, 24, 16,
                                   None if w is None else torch.from_numpy(w))
    assert torch.equal(serial, got)


@pytest.mark.parametrize("spec", STATS + ("DescriptiveStats(speed)",
                                          "Count();DescriptiveStats(speed)", "Frequency(kind,64)"))
def test_batch_supported_equals_jax(spec):
    assert kstats.batch_supported(parse_stat(spec)) == jstats.batch_supported(jparse_stat(spec))


# -- templates and specs -----------------------------------------------------
TEMPLATE_CASES = {
    "bbox": _bbox_ecql((-10, -10, 10, 10)),
    "bbox_during": ("BBOX(geom, -10, -10, 10, 10) AND dtg DURING "
                    "2024-01-01T00:00:00Z/2024-02-01T00:00:00Z"),
    "nested_and": ("(BBOX(geom, -1.5, -2.25, 3.125, 4) AND speed > 3) AND (kind = 'a' AND "
                   "dtg DURING 2024-02-10T00:00:00Z/2024-03-01T00:00:00Z)"),
    "two_boxes": _bbox_ecql((-10, -10, 10, 10), "BBOX(geom, 0, 0, 20, 20)"),
    "or_shield": "BBOX(geom, 0, 0, 5, 5) AND (BBOX(geom, -9, -9, -1, -1) OR speed > 50)",
    "not_shield": "NOT BBOX(geom, 0, 0, 5, 5) AND speed > 1",
    "polygon": f"INTERSECTS(geom, {TRI}) AND {_bbox_ecql((-40, -30, 30, 35), None)}",
    "no_slot": "speed > 5",
    "fid": "IN ('1', '2')",
}


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_split_literals_equals_jax(pair, case):
    j, p = pair["flat"]
    ecql = TEMPLATE_CASES[case]
    got = ftpl.split_literals(parse_ecql(ecql), p._store("pts").ft)
    want = jtpl.split_literals(jparse(ecql), j._store("pts").ft)
    assert (got is None) == (want is None) == (case in ("no_slot", "not_shield", "fid"))
    if got is None:
        return
    assert got.key == want.key
    assert [(s.kind, s.prop, s.f_off, s.i_off) for s in got.slots] == \
        [(s.kind, s.prop, s.f_off, s.i_off) for s in want.slots]
    assert np.array_equal(got.lits_f, want.lits_f) and got.lits_f.dtype == np.float32
    assert np.array_equal(got.lits_i, want.lits_i) and got.lits_i.dtype == np.int32
    assert repr(got.residual) == repr(want.residual)


def test_template_keys_follow_structure(pair):
    _, p = pair["flat"]
    ft = p._store("pts").ft
    a = ftpl.split_literals(parse_ecql(_bbox_ecql((-10, -10, 10, 10))), ft)
    b = ftpl.split_literals(parse_ecql(_bbox_ecql((3, -7, 40, 12))), ft)
    c = ftpl.split_literals(parse_ecql(_bbox_ecql((-10, -10, 10, 10), "speed > 30")), ft)
    assert a.key == b.key and not np.array_equal(a.lits_f, b.lits_f)
    assert c.key != a.key


@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_compile_batched_masks_equal_serial(pair, case):
    """A member's batched mask and band (literals as 0-d tensors, the
    residual and the slots evaluated apart, as the executor does) equal
    its serial compiled predicate's."""
    _, p = pair["flat"]
    st = p._store("pts")
    tpl = ftpl.split_literals(parse_ecql(TEMPLATE_CASES[case]), st.ft)
    if tpl is None:
        return
    plan = p._plan("pts", TEMPLATE_CASES[case])
    from geomesa_tpu_torch.filter.compile import compile_filter

    bf = ftpl.compile_batched(tpl, compile_filter(tpl.residual, st.ft, st.dicts))
    cols = st.tables["z3"].device_columns(list(dict.fromkeys(bf.columns + plan.compiled.columns)))
    lf, li = torch.from_numpy(tpl.lits_f), torch.from_numpy(tpl.lits_i)
    m = bf.residual(cols, torch) & bf.slots(cols, torch, lf, li)
    assert torch.equal(m, plan.compiled(cols, torch) & torch.ones_like(m))
    bands = [b for b in (None if bf.residual.band is None else bf.residual.band(cols, torch),
                         None if bf.slots_band is None else bf.slots_band(cols, torch, lf, li))
             if b is not None]
    if plan.compiled.band is None:
        assert not bands
    else:
        band = bands[0] if len(bands) == 1 else bands[0] | bands[1]
        assert torch.equal(band, plan.compiled.band(cols, torch))


def _spec_none(ds, queries, jax_side):
    """Is the batch spec None (members planned as the API plans them)?"""
    if jax_side:
        st, plans, spec = ds._batch_plans("pts", queries)
        return spec is None
    plans, spec = ds._batch_plans("pts", queries)
    return spec is None


SPEC_CASES = {
    "same": ([_bbox_ecql((-10, -10, 10, 10)), _bbox_ecql((3, -7, 40, 12))], False),
    "residual_differs": ([_bbox_ecql((-10, -10, 10, 10)),
                          _bbox_ecql((3, -7, 40, 12), "speed > 30")], True),
    "slots_differ": ([_bbox_ecql((-10, -10, 10, 10)),
                      _bbox_ecql((3, -7, 40, 12)) + " AND dtg DURING "
                      "2024-01-01T00:00:00Z/2024-02-01T00:00:00Z"], True),
    "no_slot": (["speed > 5", "speed > 5"], True),
    "host_refinement": ([_bbox_ecql((-10, -10, 10, 10), "code > 500000000000"),
                         _bbox_ecql((3, -7, 40, 12), "code > 500000000000")], True),
    "polygon": ([f"INTERSECTS(geom, {TRI}) AND {_bbox_ecql(b, None)}"
                 for b in ((-40, -30, 30, 35), (-10, -20, 0, 0))], False),
    "one_member": ([_bbox_ecql((-10, -10, 10, 10))], False),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_build_spec_eligibility_equals_jax(pair, case):
    j, p = pair["flat"]
    queries, none = SPEC_CASES[case]
    assert _spec_none(p, queries, False) == _spec_none(j, queries, True) == none
    if not none:
        plans, spec = p._batch_plans("pts", queries)
        _, jplans, jspec = j._batch_plans("pts", queries)
        assert spec.M == jspec.M == len(queries) and spec.Mp == jspec.Mp
        assert np.array_equal(spec.lits_f, jspec.lits_f)
        assert np.array_equal(spec.lits_i, jspec.lits_i)
        assert spec.key == jspec.key and spec.token == jspec.token
        assert pbatch.build_spec(p._store("pts"), []) is None


# -- batches against serial calls and the JAX package ------------------------
def _queries(kind, m, seed):
    rng = np.random.default_rng(seed)
    boxes = _rand_boxes(rng, m)
    if kind == "flat":
        return [_bbox_ecql(b) for b in boxes], boxes
    windows = ["2024-01-01T00:00:00Z/2024-01-06T00:00:00Z",
               "2024-01-04T00:00:00Z/2024-01-12T00:00:00Z",
               "2024-01-02T00:00:00Z/2024-01-14T00:00:00Z"]
    return [f"{_bbox_ecql(b, None)} AND dtg DURING {windows[i % 3]}"
            for i, b in enumerate(boxes)], boxes


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("m", [2, 5, 8])
def test_count_batch_equals_serial_and_jax(pair, kind, m):
    j, p = pair[kind]
    queries, _ = _queries(kind, m, 100 + m)
    got = p.count_batch("pts", queries)
    if kind == "flat":
        plan = p._plan("pts", queries[-1])
        assert plan.exec_path["scan"] == "device-batch" and plan.exec_path["batch"] == m
    assert got == [p.count("pts", q) for q in queries] == j.count_batch("pts", queries)
    assert any(got)


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("m", [2, 5, 8])
@pytest.mark.parametrize("weight", [None, "speed"], ids=["count", "weighted"])
def test_density_batch_equals_serial_and_jax(pair, kind, m, weight):
    j, p = pair[kind]
    queries, boxes = _queries(kind, m, 200 + m)
    w, h = (32, 32) if weight is None else (16, 12)
    got = p.density_batch("pts", queries, bboxes=boxes, width=w, height=h, weight=weight)
    assert len(got) == m
    for q, b, g in zip(queries, boxes, got):
        assert g.dtype == np.float32 and g.shape == (h, w)
        assert np.array_equal(g, p.density("pts", q, bbox=b, width=w, height=h, weight=weight))
    if weight is not None and kind == "partitioned":
        return  # weighted against the JAX package: on the flat store
    want = j.density_batch("pts", queries, bboxes=boxes, width=w, height=h, weight=weight)
    for g, jg in zip(got, want):
        if weight is None:
            assert np.array_equal(g, jg)
        else:
            np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("m", [2, 5, 8])
def test_stats_batch_equals_serial_and_jax(pair, kind, m):
    j, p = pair[kind]
    queries, _ = _queries(kind, m, 300 + m)
    specs = STATS if kind == "flat" else STATS[:3]
    for spec in specs:
        got = p.stats_batch("pts", spec, queries)
        assert got is not None, spec
        assert [s.to_json() for s in got] == \
            [p.stats("pts", spec, q).to_json() for q in queries], spec
    # the JAX package's batch, once over every leaf
    spec = ";".join(specs)
    want = j.stats_batch("pts", spec, queries)
    assert [s.to_json() for s in p.stats_batch("pts", spec, queries)] == \
        [s.to_json() for s in want]


def test_density_batch_default_bboxes(pair):
    j, p = pair["flat"]
    queries, _ = _queries("flat", 3, 41)
    got = p.density_batch("pts", queries, width=20, height=10)
    want = j.density_batch("pts", queries, width=20, height=10)
    for q, g, jg in zip(queries, got, want):
        assert np.array_equal(g, jg)
        assert np.array_equal(g, p.density("pts", q, width=20, height=10))


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
def test_polygon_residual_batch(pair, kind):
    """Members sharing an INTERSECTS residual: the residual's mask (the
    point-in-polygon kernel's plain version here) is evaluated once."""
    j, p = pair[kind]
    queries = [f"INTERSECTS(geom, {TRI}) AND {q}" for q in _queries(kind, 5, 400)[0]]
    got = p.count_batch("pts", queries)
    assert got == [p.count("pts", q) for q in queries]
    if kind == "flat":
        assert got == j.count_batch("pts", queries)
    assert any(got)
    st = "Count();MinMax(speed)"
    assert [s.to_json() for s in p.stats_batch("pts", st, queries)] == \
        [p.stats("pts", st, q).to_json() for q in queries]
    if kind == "flat":
        assert [s.to_json() for s in p.stats_batch("pts", st, queries)] == \
            [s.to_json() for s in j.stats_batch("pts", st, queries)]


def test_band_rows_corrected_per_member(pair):
    """Members whose boxes' f32 bounds hold rows: counts and grids add each
    member's exact band correction; stats batches refuse (their serial
    scans run on the host), as the reference's."""
    j, p = pair["flat"]
    boxes = BANDED + [(-60.0, -30.0, -30.0, 0.0)]
    queries = [_bbox_ecql(b, None) for b in boxes]
    plans, _ = p._batch_plans("pts", queries)
    corrected = p.count_batch("pts", queries)
    assert corrected == [p.count("pts", q) for q in queries] == j.count_batch("pts", queries)
    assert all(p._plan("pts", q).exec_path["band_rows"] > 0 for q in queries[:2])
    got = p.density_batch("pts", queries, bboxes=boxes, width=8, height=8)
    want = j.density_batch("pts", queries, bboxes=boxes, width=8, height=8)
    for q, b, g, jg in zip(queries, boxes, got, want):
        assert np.array_equal(g, jg)
        assert np.array_equal(g, p.density("pts", q, bbox=b, width=8, height=8))
    assert p.stats_batch("pts", "Count()", queries) is None
    assert j.stats_batch("pts", "Count()", queries) is None
    assert p.stats_batch("pts", "Count()", queries[2:]) is not None


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
def test_empty_and_disjoint_members(pair, kind):
    j, p = pair[kind]
    during = "" if kind == "flat" else " AND dtg DURING 2024-01-03T00:00:00Z/2024-01-12T00:00:00Z"
    queries = [_bbox_ecql((-9.5, -9.5, 9.5, 9.5), None) + during,
               _bbox_ecql((160, 80, 170, 85), None) + during]
    boxes = [(-9.5, -9.5, 9.5, 9.5), (160, 80, 170, 85)]
    got = p.count_batch("pts", queries)
    assert got == [p.count("pts", q) for q in queries] == j.count_batch("pts", queries)
    assert got[1] == 0 < got[0]
    grids = p.density_batch("pts", queries, bboxes=boxes, width=8, height=8)
    jgrids = j.density_batch("pts", queries, bboxes=boxes, width=8, height=8)
    for g, jg in zip(grids, jgrids):
        assert np.array_equal(g, jg)
    assert not grids[1].any()
    spec = "Count();MinMax(speed);Histogram(speed,4,0,100)"
    s = [x.to_json() for x in p.stats_batch("pts", spec, queries)]
    assert s == [p.stats("pts", spec, q).to_json() for q in queries]
    if kind == "flat":
        assert s == [x.to_json() for x in j.stats_batch("pts", spec, queries)]
    # every member empty: zeros, no scan
    nothing = [_bbox_ecql((160, 80, 170, 85), None) + during,
               _bbox_ecql((150, 70, 170, 85), None) + during]
    assert p.count_batch("pts", nothing) == [0, 0] == j.count_batch("pts", nothing)
    assert not any(g.any() for g in p.density_batch("pts", nothing, width=4, height=4))


DURING = " AND dtg DURING 2024-01-10T00:00:00Z/2024-02-20T00:00:00Z"


def test_minority_replanned_onto_majority_index(pair):
    j, p = pair["flat"]
    queries = [_bbox_ecql(b) + DURING for b in _rand_boxes(np.random.default_rng(9), 3)]
    forced = [Query(queries[0], index="z2"), Query(queries[1], index="z2"),
              Query(queries[2], index="z3")]
    plans, spec = p._batch_plans("pts", forced)
    assert spec is not None and {pl.index_name for pl in plans} == {"z2"}
    got = p.count_batch("pts", forced)
    assert got == [p.count("pts", q) for q in queries] == \
        j.count_batch("pts", [_jq(q) for q in forced])


def test_replan_an_index_cannot_serve_gives_none(pair, monkeypatch):
    """A minority member the majority's index cannot serve: None in both
    packages (the planner's refusal is simulated on both sides)."""
    j, p = pair["flat"]
    queries = [_bbox_ecql(b) + DURING for b in _rand_boxes(np.random.default_rng(10), 3)]
    forced = [Query(queries[0], index="z2"), Query(queries[1], index="z2"),
              Query(queries[2], index="z3")]
    real_p, real_j = GeoDataset._fresh_plan, JGeoDataset._plan

    def refuse_p(self, name, q, *a, **kw):
        if isinstance(q, Query) and q.ecql == queries[2] and q.index == "z2":
            raise ValueError("index 'z2' cannot serve this query")
        return real_p(self, name, q, *a, **kw)

    def refuse_j(self, name, q, *a, **kw):
        if isinstance(q, JQuery) and q.ecql == queries[2] and q.index == "z2":
            raise ValueError("index 'z2' cannot serve this query")
        return real_j(self, name, q, *a, **kw)

    monkeypatch.setattr(GeoDataset, "_fresh_plan", refuse_p)
    monkeypatch.setattr(JGeoDataset, "_plan", refuse_j)
    assert p.count_batch("pts", forced) is None
    assert j.count_batch("pts", [_jq(q) for q in forced]) is None


NONE_CASES = {
    "structure": lambda qs: ([qs[0], qs[1].replace("speed > 20", "speed > 30")], {}),
    "sampling": lambda qs: ([qs[0], Query(qs[1], sampling=2)], {}),
    "host_refinement": lambda qs: ([q.replace("speed > 20", "code > 500000000000")
                                    for q in qs], {}),
    "estimate": lambda qs: (qs, {"exact": False}),
}


@pytest.mark.parametrize("case", sorted(NONE_CASES))
def test_none_cases_equal_jax(pair, case):
    j, p = pair["flat"]
    qs = [_bbox_ecql(b) for b in _rand_boxes(np.random.default_rng(12), 2)]
    queries, kw = NONE_CASES[case](qs)
    assert p.count_batch("pts", queries, **kw) is None
    assert j.count_batch("pts", [_jq(q) for q in queries], **kw) is None
    if kw:
        return
    assert p.density_batch("pts", queries, width=8, height=8) is None
    assert j.density_batch("pts", [_jq(q) for q in queries], width=8, height=8) is None
    assert p.stats_batch("pts", "Count()", queries) is None
    assert j.stats_batch("pts", "Count()", [_jq(q) for q in queries]) is None


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("spec", ["DescriptiveStats(speed)", "Count();DescriptiveStats(speed)"])
def test_descriptive_stats_batch_is_none(pair, kind, spec):
    j, p = pair[kind]
    queries, _ = _queries(kind, 3, 19)
    assert p.stats_batch("pts", spec, queries) is None
    assert j.stats_batch("pts", spec, queries) is None


def test_batch_arguments(pair):
    j, p = pair["flat"]
    q = _bbox_ecql((-10, -10, 10, 10))
    for ds in (j, p):
        assert ds.count_batch("pts", []) == []
        assert ds.density_batch("pts", []) == []
        assert ds.stats_batch("pts", "Count()", []) == []
        with pytest.raises(ValueError, match="align"):
            ds.count_batch("pts", [q], members=[{}, {}])
        with pytest.raises(ValueError, match="align"):
            ds.density_batch("pts", [q], bboxes=[None, None])
        with pytest.raises(ValueError, match="align"):
            ds.stats_batch("pts", "Count()", [q], members=[])
    assert p.count_batch("pts", [q], members=[{"user": "u"}]) == [p.count("pts", q)]
    with pytest.raises(NotImplementedError, match="host layers"):
        p.count_batch("pts", [Query(q, auths=["a"])])
