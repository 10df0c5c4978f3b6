"""Aggregate-cache persistence in the PyTorch port (``lake/persist.py``,
``GeoDataset.persist_cache`` / ``restore_cache``), and cache files
interchanged with the JAX package.

After ``tests/test_lake.py``'s restart scenario: warm the four quadrant
counts of a zoom-out at two cells an axis, checkpoint and persist the
cache, ``GeoDataset.load`` the checkpoint and restore the cache into it;
the domain count then assembles from the restored cells with no device
launch (``exec.device.dispatch`` unchanged) and equals the live
answer. The guards (row count, schema spec, missing schema) skip a
section, a stale epoch is not written, a corrupt file raises
``LakeCorruptError``, and a file written by either package restores in
the other with the same entry count and a zoom-out that launches nothing.
"""

import contextlib

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu_torch import GeoDataset, config, metrics
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.lake.format import LakeCorruptError, LakeWriter

SPEC = "name:String,weight:Double,dtg:Date,*geom:Point"
#: the domain-spanning zoom-out: at two cells an axis each quadrant warms
#: four level-2 cells, and the domain's level-1 cells assemble from them
#: with no strips
WORLD_WARM = ["BBOX(geom, -180, -90, 0, 0)", "BBOX(geom, 0, -90, 180, 0)",
              "BBOX(geom, -180, 0, 0, 90)", "BBOX(geom, 0, 0, 180, 90)"]
WORLD = "BBOX(geom, -180, -90, 180, 90)"
ZOOM = "BBOX(geom, -90, -45, 90, 45)"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_data(n=4_000):
    r = np.random.default_rng(5)
    return {
        "name": ["a"] * n,
        "weight": r.uniform(0, 2, n),
        "dtg": np.full(n, parse_iso_ms("2020-01-01")).astype("datetime64[ms]"),
        "geom__x": r.uniform(-170, 170, n),
        "geom__y": r.uniform(-80, 80, n),
    }, np.arange(n).astype(str)


@contextlib.contextmanager
def cache_on(cfg):
    with cfg.CACHE_ENABLED.scoped("true"), cfg.CACHE_CELLS_PER_AXIS.scoped("2"):
        yield


def dispatches(met=metrics):
    return met.registry().counter(met.EXEC_DEVICE_DISPATCH).value


def warmed(ds, cfg, tmp_path, tag):
    """Fill ``ds`` (either package), warm the quadrants, checkpoint and
    persist: (checkpoint root, cache file, the domain's count, persist
    summary)."""
    data, fids = make_data()
    ds.create_schema("pts", SPEC)
    ds.insert("pts", data, fids=fids)
    ds.flush()
    expect = ds.count("pts", WORLD)  # the cache is off: nothing stored
    with cache_on(cfg):
        for q in WORLD_WARM:
            ds.count("pts", q)
    ckpt, cpath = str(tmp_path / f"ckpt_{tag}"), str(tmp_path / f"cache_{tag}.lake")
    ds.save(ckpt)
    summary = ds.persist_cache(cpath)
    return ckpt, cpath, expect, summary


@pytest.fixture(scope="module")
def port_files(tmp_path_factory):
    ds = GeoDataset(n_shards=2, device="cpu")
    out = warmed(ds, config, tmp_path_factory.mktemp("port"), "port")
    return ds, out


def zoom_out(ds, met, cfg, expect):
    """The domain count on a restored dataset: every cell served from the
    restored entries (the quadrants' roll-ups), no launch, equal to
    ``expect``."""
    with cache_on(cfg):
        d0 = dispatches(met)
        p0 = met.registry().counter(met.CACHE_PARTIAL).value
        assert ds.count("pts", WORLD) == expect
        assert dispatches(met) == d0, "the warm zoom-out after restore launched"
        assert met.registry().counter(met.CACHE_PARTIAL).value == p0 + 1


def test_restart_restore_zero_dispatch_zoom_out(port_files):
    live, (ckpt, cpath, expect, summary) = port_files
    assert summary["pts"] == len(live.cache.store.export_uid(live._store("pts").uid)[1]) > 0
    ds2 = GeoDataset.load(ckpt, device="cpu")
    r0 = metrics.registry().counter(metrics.CACHE_PERSIST_RESTORED).value
    out = ds2.restore_cache(cpath)
    assert out == {"pts": {"restored": summary["pts"]}}
    assert metrics.registry().counter(metrics.CACHE_PERSIST_RESTORED).value == r0 + summary["pts"]
    zoom_out(ds2, metrics, config, expect)
    with config.CACHE_ENABLED.scoped("false"):
        assert ds2.count("pts", WORLD) == expect


def test_persisted_keys_round_trip(port_files):
    """Every live key is literal-evaluable, so the file holds all of them."""
    live, (ckpt, cpath, _expect, summary) = port_files
    ds2 = GeoDataset.load(ckpt, device="cpu")
    ds2.restore_cache(cpath)
    got = ds2.cache.store.export_uid(ds2._store("pts").uid)[1]
    want = live.cache.store.export_uid(live._store("pts").uid)[1]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert type(a) is type(b)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_guards_skip(port_files, tmp_path):
    _live, (ckpt, cpath, _expect, _summary) = port_files
    # the row count changed (no journal: the shared root stays as saved)
    with config.JOURNAL_ENABLED.scoped("false"):
        ds2 = GeoDataset.load(ckpt, device="cpu")
    ds2.insert("pts", {"name": ["x"], "weight": np.asarray([1.0]),
                       "dtg": np.asarray([parse_iso_ms("2020-01-02")]).astype("datetime64[ms]"),
                       "geom__x": np.asarray([1.0]), "geom__y": np.asarray([2.0])},
               fids=np.asarray(["zz"]))
    ds2.flush()
    assert ds2.restore_cache(cpath) == {"pts": {"skipped": "row count changed"}}
    assert ds2.cache.store.total_entries == 0
    # the schema changed (same name and rows, another spec)
    data, fids = make_data()
    ds3 = GeoDataset(n_shards=2, device="cpu")
    ds3.create_schema("pts", SPEC.replace("weight:Double", "weight:Float"))
    ds3.insert("pts", data, fids=fids)
    ds3.flush()
    assert ds3.restore_cache(cpath) == {"pts": {"skipped": "schema changed"}}
    # no such schema
    assert GeoDataset(device="cpu").restore_cache(cpath) == {"pts": {"skipped": "no such schema"}}


def test_stale_epoch_is_not_persisted(tmp_path):
    data, fids = make_data(500)
    ds = GeoDataset(n_shards=2, device="cpu")
    ds.create_schema("pts", SPEC)
    ds.insert("pts", data, fids=fids)
    ds.flush()
    with cache_on(config):
        ds.count("pts", ZOOM)
    ds.insert("pts", {k: v[:1] for k, v in data.items()}, fids=np.asarray(["new"]))
    ds.flush()  # the version moved past the cached entries
    assert ds.persist_cache(str(tmp_path / "c.lake")) == {"pts": 0}


def test_corrupt_file_raises(port_files, tmp_path):
    _live, (ckpt, cpath, _expect, _summary) = port_files
    raw = bytearray(open(cpath, "rb").read())
    bad = tmp_path / "bad.lake"
    raw[len(raw) // 3] ^= 0xFF  # a payload byte: its crc check fails
    bad.write_bytes(bytes(raw))
    ds2 = GeoDataset.load(ckpt, device="cpu")
    with pytest.raises(LakeCorruptError):
        ds2.restore_cache(str(bad))
    other = str(tmp_path / "other.lake")
    w = LakeWriter(other)
    w.finish({"kind": "partition"})
    with pytest.raises(LakeCorruptError):
        ds2.restore_cache(other)  # a lake file of another kind


def test_jax_file_restores_in_the_port(tmp_path):
    jconfig.MESH_DEVICES.set(1)
    try:
        jds = JGeoDataset(n_shards=2)
        ckpt, cpath, expect, summary = warmed(jds, jconfig, tmp_path, "jax")
    finally:
        jconfig.MESH_DEVICES.set(None)
    ds = GeoDataset.load(ckpt, device="cpu")
    out = ds.restore_cache(cpath)
    assert out == {"pts": {"restored": summary["pts"]}} and summary["pts"] > 0
    zoom_out(ds, metrics, config, expect)


def test_port_file_restores_in_jax(port_files):
    _live, (ckpt, cpath, expect, summary) = port_files
    jconfig.MESH_DEVICES.set(1)
    try:
        jds = JGeoDataset.load(ckpt)
        out = jds.restore_cache(cpath)
        assert out == {"pts": {"restored": summary["pts"]}}
        zoom_out(jds, jmetrics, jconfig, expect)
    finally:
        jconfig.MESH_DEVICES.set(None)
