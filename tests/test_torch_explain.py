"""PyTorch port vs the JAX package: ``explain``, guards and interceptors.

Both packages hold the same seeded rows in a flat and a time-partitioned
store (the JAX side with its Pallas kernels in interpret mode, compaction
forced and ``geomesa.mesh.devices`` 1).

``GeoDataset.explain`` prints the same text line for line, plain and
``analyze=True``, flat and partitioned, with and without a ``region=``,
with tracing off and on, the Warm path section's kernel registry lines
and the registry's Execution path notes (``kernel``, ``shape_bucket``)
included. Masked: numbers on timing lines (the device coarse kernel's ms,
the achieved bandwidth and the Cost section's ``device_ms.<id>``), trace
id values, and the route of a ``kernel:<name>`` note (the reference's
Pallas ``pallas``, the port's ``cuda`` or, on CPU tensors, ``plain``). A partitioned call's
Execution path compares on its ``lake`` lines: the port's holds the last
partition's notes and each partition's under ``partitions``.

The guards (``geomesa.scan.block-full-table``,
``geomesa.guard.temporal.max.days``) raise the same ``ValueError`` on the
same queries, also for a plan cached before the knob flipped, and a
refused count dispatches nothing. A test interceptor's rewrite and its
veto act alike in both packages.
"""

import re

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.filter import ir as jir
from geomesa_tpu.filter import parse_ecql as jparse
from geomesa_tpu.planning import interceptors as jinterceptors
from geomesa_tpu_torch import GeoDataset, config, metrics, tracing
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.ecql import parse_ecql, parse_iso_ms
from geomesa_tpu_torch.planning import interceptors

SPEC = "name:String:index=true,weight:Double,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 4000
BOX = ("BBOX(geom, -110, 28, -75, 48) AND "
       "dtg DURING 2020-01-03T00:00:00Z/2020-01-20T00:00:00Z")
PBOX = ("BBOX(geom, -100, 30, -96, 34) AND "
        "dtg DURING 2020-01-03T00:00:00Z/2020-01-20T00:00:00Z")
TRI = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
#: a region that meets PBOX
PTRI = "POLYGON((-101 29, -95 29, -98 35, -101 29))"


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
    """(JAX, port): a flat schema ``t`` and a partitioned ``pt`` spilled to
    lake files."""
    data = _data()
    fids = np.arange(N).astype(str)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        mp.setenv("GEOMESA_LAKE_ROWGROUP_ROWS", "256")
        jconfig.COMPACT_MIN_ROWS.set(1)
        jconfig.COMPACT_FRACTION.set(2.0)
        jconfig.MESH_DEVICES.set(1)
        try:
            out = []
            for ds, tag in ((JGeoDataset(n_shards=4), "j"),
                            (GeoDataset(n_shards=4, device="cpu", compact_min_rows=1,
                                        compact_fraction=2.0), "p")):
                ds.create_schema("t", SPEC)
                ds.insert("t", data, fids=fids)
                ds.create_schema("pt", PSPEC)
                st = ds._store("pt")
                st.max_resident = 2
                st._spill_dir = str(tmp_path_factory.mktemp(f"{tag}spill"))
                ds.insert("pt", data, fids=fids)
                ds.flush("t")
                ds.flush("pt")
                st.spill_all()
                out.append(ds)
            yield out
        finally:
            jconfig.COMPACT_MIN_ROWS.set(None)
            jconfig.COMPACT_FRACTION.set(None)
            jconfig.MESH_DEVICES.set(None)


def _sections(text):
    """[(header, [lines])] of an explain text: each unindented line opens
    a section."""
    out = []
    for line in text.splitlines():
        if not line.startswith(" "):
            out.append((line, []))
        else:
            out[-1][1].append(line)
    return out


def _mask(line):
    line = re.sub(r"(trace_id \(this explain call\)): \w+", r"\1: <id>", line)
    line = re.sub(r"^(\s*Device coarse kernel:) [\d.]+ ms", r"\1 <ms> ms", line)
    line = re.sub(r"^(\s*device_ms\.\d+:) .*$", r"\1 <ms>", line)
    line = re.sub(r"^(\s*kernel:\w+:) .*$", r"\1 <route>", line)
    return re.sub(r"^(\s*achieved scan bandwidth:) [\d.]+ GB/s", r"\1 <x> GB/s", line)


def normalize(text, reference, partitioned=False):
    """The comparable lines of an explain text (see the module docstring)."""
    lines = []
    for header, body in _sections(text):
        lines.append(header)
        if header == "Selectivity (analyze)":
            kept, in_path = [], False
            for ln in body:
                if ln.strip() == "Execution path":
                    in_path = True
                    kept.append(ln)
                    continue
                if in_path and ln.startswith("    "):
                    key = ln.strip().split(":", 1)[0]
                    if partitioned and key not in ("lake", "lake_fallback"):
                        continue
                else:
                    in_path = False
                kept.append(ln)
            if kept and kept[-1].strip() == "Execution path":
                kept.pop()  # nothing left to compare under it
            body = kept
        lines.extend(_mask(ln) for ln in body)
    return lines


def _explain(ds, *args, trace=False, **kw):
    cfg = config if isinstance(ds, GeoDataset) else jconfig
    with cfg.TRACE_ENABLED.scoped("true" if trace else "false"), \
            cfg.PIPELINE_PREFETCH.scoped("false"):
        return ds.explain(*args, **kw)


CASES = {
    "box": (BOX, None),
    "include": ("INCLUDE", None),
    "region": (BOX, TRI),
    "attr": ("name = 'actor1'", None),
    "polygon": (f"INTERSECTS(geom, {TRI})", None),
    "fid": ("IN ('1','2')", None),
    "dwithin": ("DWITHIN(geom, POINT(-90 40), 100, kilometers)", None),
    "disjoint": ("BBOX(geom, 10, 10, 11, 11) AND BBOX(geom, 20, 20, 21, 21)", None),
}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("analyze", [False, True], ids=["plain", "analyze"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_explain_text_equal_flat(pair, case, analyze, trace):
    j, p = pair
    q, region = CASES[case]
    jt = _explain(j, "t", q, analyze=analyze, region=region, trace=trace)
    pt = _explain(p, "t", q, analyze=analyze, region=region, trace=trace)
    assert normalize(pt, False) == normalize(jt, True)
    heads = [h for h, _ in _sections(pt)]
    assert heads[:1] == ["Planning 't' query"]
    assert heads[1:] == ["Aggregate cache", "Hierarchy", "Warm path", "Observability"] + (
        ["Selectivity (analyze)"] if analyze else []) + ["Cost"]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("analyze", [False, True], ids=["plain", "analyze"])
@pytest.mark.parametrize("case", ["box", "include", "region"])
def test_explain_text_equal_partitioned(pair, case, analyze, trace):
    j, p = pair
    q, region = CASES[case]
    q = PBOX if case != "include" else q
    region = PTRI if region else None
    jt = _explain(j, "pt", q, analyze=analyze, region=region, trace=trace)
    pt = _explain(p, "pt", q, analyze=analyze, region=region, trace=trace)
    assert normalize(pt, False, True) == normalize(jt, True, True)


def test_explain_analyze_matches_count_and_cost(pair):
    """Matched equals the count; traced, the Cost section reads the
    explain call's own ledger."""
    _, p = pair
    n = p.count("pt", PBOX)
    text = _explain(p, "pt", PBOX, analyze=True, trace=True)
    assert f"  Matched: {n}" in text.splitlines()
    cost = dict(ln.strip().split(": ", 1) for ln in _sections(text)[-1][1])
    assert float(cost["partitions_scanned"]) + float(cost["partitions_pruned"]) == len(
        p._store("pt").partition_bins())
    assert float(cost["lake_bytes_read"]) > 0
    assert tracing.last_trace().root.name == "explain"


def test_explain_with_the_cache_and_hierarchy(pair):
    """Cells resident after a cached count show in the Hierarchy section,
    as the reference's probe finds them."""
    from geomesa_tpu.cache import AggregateCache as JAggregateCache
    from geomesa_tpu_torch.cache import AggregateCache

    j, p = pair
    q = "BBOX(geom, -112.5, 22.5, -67.5, 45.0) AND name = 'actor1'"
    j.cache, p.cache = JAggregateCache(), AggregateCache()
    try:
        texts = []
        for ds, cfg in ((j, jconfig), (p, config)):
            with cfg.CACHE_ENABLED.scoped("true"), cfg.CACHE_CELLS_PER_AXIS.scoped("2"):
                ds.count("t", q)
                texts.append(ds.explain("t", q))
        assert normalize(texts[1], False) == normalize(texts[0], True)
        assert "  enabled: True" in texts[1].splitlines()
        assert any(ln.startswith("  levels hit: ") for ln in texts[1].splitlines())
    finally:
        j.cache, p.cache = JAggregateCache(), AggregateCache()


def test_explain_plan_is_not_cached(pair):
    _, p = pair
    n = len(p._plans)
    p.explain("t", "BBOX(geom, -101, 31, -99, 33)")
    assert len(p._plans) == n


# -- guards ------------------------------------------------------------------------
def _err(ds, fn):
    with pytest.raises(ValueError) as ei:
        fn(ds)
    return str(ei.value)


@pytest.mark.parametrize("q", ["INCLUDE", "weight > 5", "name = 'actor1'", BOX])
def test_full_table_scan_guard(pair, q):
    j, p = pair
    outs = []
    for ds, cfg in ((j, jconfig), (p, config)):
        with cfg.BLOCK_FULL_TABLE_SCANS.scoped("true"):
            try:
                outs.append(("ok", ds.count("t", q)))
            except ValueError as e:
                outs.append(("err", str(e)))
    assert outs[1] == outs[0]
    assert (outs[1][0] == "err") == (q in ("INCLUDE", "weight > 5"))


def test_guard_rechecked_on_a_cached_plan(pair):
    """A plan cached with the guard off is refused once the guard flips
    on, before any dispatch."""
    j, p = pair
    for ds in (j, p):
        ds.count("t", "INCLUDE")
    d0 = metrics.registry().counter(metrics.EXEC_DEVICE_DISPATCH).value
    msgs = []
    for ds, cfg in ((j, jconfig), (p, config)):
        with cfg.BLOCK_FULL_TABLE_SCANS.scoped("true"):
            msgs.append(_err(ds, lambda d: d.count("t", "INCLUDE")))
            msgs.append(_err(ds, lambda d: d.explain("t", "INCLUDE")))
    assert msgs[2:] == msgs[:2]
    assert msgs[0].startswith("full-table scan blocked")
    assert metrics.registry().counter(metrics.EXEC_DEVICE_DISPATCH).value == d0
    assert p.count("t", "INCLUDE") == N


@pytest.mark.parametrize("q", ["BBOX(geom, -110, 28, -75, 48)", BOX,
                               "dtg DURING 2020-01-03T00:00:00Z/2020-01-08T00:00:00Z",
                               "IN ('1','2')"])
def test_temporal_guard(pair, q):
    j, p = pair
    outs = []
    for ds, cfg in ((j, jconfig), (p, config)):
        with cfg.TEMPORAL_GUARD_MAX_DAYS.scoped("7"):
            for name in ("t", "pt"):
                try:
                    outs.append(("ok", ds.count(name, q)))
                except ValueError as e:
                    outs.append(("err", str(e)))
    assert outs[2:] == outs[:2]
    assert (outs[0][0] == "err") == (q != "dtg DURING 2020-01-03T00:00:00Z/2020-01-08T00:00:00Z")


# -- interceptors ---------------------------------------------------------------
class OnlyActor(object):
    """Rewrites every query to one actor's rows; vetoes fid lookups."""

    def __init__(self, irmod, parse):
        self.irmod, self.parse = irmod, parse

    def rewrite(self, f, ft):
        return self.irmod.And((f, self.parse("name = 'actor2'")))

    def guard(self, plan):
        if plan.index_name == "id":
            raise ValueError("fid lookups are not allowed on " + plan.schema)


@pytest.fixture()
def intercepted(pair):
    jinterceptors.register("t", OnlyActor(jir, jparse))
    interceptors.register("t", OnlyActor(ir, parse_ecql))
    try:
        yield pair
    finally:
        jinterceptors.clear("t")
        interceptors.clear("t")


def test_interceptor_rewrite_and_veto(intercepted):
    j, p = intercepted
    want = p.count("pt", BOX + " AND name = 'actor2'")
    v0 = interceptors.version()
    for ds in (j, p):
        assert ds.count("t", BOX) == want
        assert ds.count("t", f"INTERSECTS(geom, {TRI})") == ds.count(
            "pt", f"INTERSECTS(geom, {TRI}) AND name = 'actor2'")
    jt, pt = j.explain("t", BOX), p.explain("t", BOX)
    assert normalize(pt, False) == normalize(jt, True)
    assert "  Filter rewritten by interceptor" in pt.splitlines()
    msgs = [_err(ds, lambda d: d.count("t", "IN ('1','2')")) for ds in (j, p)]
    assert msgs[1] == msgs[0] == "fid lookups are not allowed on t"
    assert interceptors.version() == v0


def test_interceptors_key_the_plan_cache(pair):
    """Registering an interceptor changes what a cached query plans to."""
    j, p = pair
    n = p.count("t", BOX)
    interceptors.register("t", OnlyActor(ir, parse_ecql))
    try:
        assert p.count("t", BOX) < n
    finally:
        interceptors.clear("t")
    assert p.count("t", BOX) == n


def test_interceptor_from_user_data_typo_does_not_brick_the_schema(pair):
    _, p = pair
    ft = p.get_schema("t")
    ft.user_data[interceptors.USER_DATA_KEY] = "no.such.module.Interceptor"
    try:
        assert interceptors.for_schema(ft) == []
        assert p.count("t", BOX) > 0
    finally:
        ft.user_data.pop(interceptors.USER_DATA_KEY)
        interceptors.clear()
