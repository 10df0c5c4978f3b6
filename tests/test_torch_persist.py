"""PyTorch port vs the JAX package: durable datasets.

``GeoDataset.save`` / ``load`` / ``refresh_schema`` over flat chunk
checkpoints and partitioned snapshot checkpoints, with the journal:

* round trips on flat, resident-partitioned and spilled-partitioned
  stores (count, density, polygon count, stats, features, ``describe``);
* the store sketches' JSON string-equal to the reference's;
* an incremental chunk append, a full rewrite after ``delete_features``
  and ``update_schema`` (the mutation epoch), the orphan sweep, and a
  root of mixed-vintage chunks loading as the reference loads it;
* an incremental partition checkpoint touching only the dirty partition,
  and a checkpoint that never aliases the live store;
* a JAX root loaded by the port and a port root loaded by the JAX
  package, with equal answers and manifest entries equal apart from the
  chunk names and the random mutation epoch;
* a journal written by one package replayed by the other, every record
  kind replayed to the JAX package's state, the delete-schema tombstone
  before and after a checkpoint, and ``refresh_schema``'s four cases.

The JAX side runs its Pallas kernels in interpret mode with one mesh
device, the port on the CPU. No tolerance: every compared value is exact.
"""

import contextlib
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from geomesa_tpu import GeoDataset as JGeoDataset
from geomesa_tpu import config as jconfig
from geomesa_tpu.schema import columns as jcolumns
from geomesa_tpu_torch import GeoDataset, config, resilience
from geomesa_tpu_torch.filter.ecql import parse_iso_ms
from geomesa_tpu_torch.schema import columns

SPEC = "name:String:index=true,code:Long:index=true,weight:Float,dtg:Date,*geom:Point"
PSPEC = SPEC + ";geomesa.partition='time'"
N = 1000
BBOX = (-120.0, 25.0, -70.0, 50.0)
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-25T00:00:00Z"
POLY = "POLYGON((-95 32, -85 32, -90 40, -95 32))"
QUERIES = [
    "INCLUDE",
    f"BBOX(geom, -100, 30, -85, 42) AND {DURING}",
    "name = 'a3'",
    f"INTERSECTS(geom, {POLY})",
]
STATS = "Count();MinMax(weight);Enumeration(name)"
KINDS = ["flat", "partitioned", "spilled"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: its tensors are small, and under
    a parallel test runner OpenMP's spinning worker threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_setup():
    """Pallas in interpret mode and one mesh device on the JAX side; both
    sides scan padded (no compaction at these sizes), which the answers
    do not depend on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOMESA_PALLAS_INTERPRET", "1")
        jconfig.MESH_DEVICES.set(1)
        try:
            yield
        finally:
            jconfig.MESH_DEVICES.set(None)


_SPILL_BASE = []


@pytest.fixture(autouse=True)
def spill_dirs(tmp_path):
    """Each package's live partitioned stores spill under the test's
    directory; each loaded dataset gets a spill directory of its own
    (:func:`_spill_scope`), so a reload never writes over a live store's
    snapshots."""
    _SPILL_BASE[:] = [tmp_path]
    with config.SPILL_DIR.scoped(str(tmp_path / "spill_port")), \
            jconfig.SPILL_DIR.scoped(str(tmp_path / "spill_jax")):
        yield


@contextlib.contextmanager
def _spill_scope():
    d = tempfile.mkdtemp(prefix="spill_load_", dir=_SPILL_BASE[0])
    with config.SPILL_DIR.scoped(d + "/port"), jconfig.SPILL_DIR.scoped(d + "/jax"):
        yield


def _data(n=N, seed=7, extra=False):
    rng = np.random.default_rng(seed)
    lo, hi = parse_iso_ms("2020-01-01"), parse_iso_ms("2020-01-29")
    out = {
        "name": [f"a{i % 12}" for i in range(n)],
        "code": rng.integers(0, 1 << 40, n),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "dtg": rng.integers(lo, hi, n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
    }
    if extra:
        out["tag"] = [f"t{i % 3}" for i in range(n)]
        out["seen"] = out["dtg"]
    return out


def _fids(n, lo=0, prefix=""):
    return np.array([f"{prefix}{i}" for i in range(lo, lo + n)])


def _port():
    return GeoDataset(n_shards=2, device="cpu")


def _load_port(root):
    with _spill_scope():
        return GeoDataset.load(root, device="cpu")


def _load_jax(root):
    with _spill_scope():
        return JGeoDataset.load(root)


def _made(cls, kind, data=None, fids=None, spec=None):
    """A dataset of ``cls`` ("port" or "jax") holding schema "t"."""
    ds = _port() if cls == "port" else JGeoDataset(n_shards=2)
    ds.create_schema("t", spec or (SPEC if kind == "flat" else PSPEC))
    if kind != "flat":
        ds._store("t").max_resident = 2
    data = _data() if data is None else data
    n = len(next(iter(data.values())))
    ds.insert("t", data, fids=_fids(n) if fids is None else fids)
    ds.flush("t")
    if kind == "spilled":
        ds._store("t").spill_all()
    return ds


def _norm(v):
    if isinstance(v, np.ndarray):
        v = v.tolist()
    return [repr(x) for x in v]


def _stat_json(stat):
    """A sketch's JSON, a merged z3 histogram's bins and an enumeration's
    counts in key order: a partitioned store merges its resident
    partitions' sketches before its spilled ones', so their order follows
    residency (in both packages)."""
    j = json.loads(stat.to_json())
    if j.get("kind") == "z3histogram":
        j["bins"] = sorted(j["bins"], key=lambda b: b[0])
    if j.get("kind") == "enumeration":
        j["counts"] = sorted(j["counts"], key=lambda c: c[0])
    return j


def snapshot(ds, name="t", stats=True):
    """Comparable state of one schema: spec, count, rows by fid, sketches
    as JSON (``stats``), and the indices."""
    st = ds._store(name)
    d = ds.query(name, "INCLUDE").to_dict()
    fids = list(d.pop("__fid__", []))
    cols = {k: _norm(v) for k, v in d.items()}
    rows = {f: tuple(cols[k][i] for k in sorted(cols)) for i, f in enumerate(fids)}
    return {
        "spec": st.ft.spec(),
        "count": ds.count(name),
        "rows": rows,
        "stats": {k: _stat_json(v) for k, v in st.stats.items()} if stats else None,
        "indices": sorted(ks.name for ks in st.keyspaces),
    }


def answers(ds, name="t", queries=QUERIES):
    """Counts of ``queries``; the density grid and the stats of the bbox +
    time query."""
    out = [ds.count(name, q) for q in queries]
    out.append(ds.density(name, QUERIES[1], bbox=BBOX, width=32, height=24).tobytes())
    st = ds.stats(name, STATS, QUERIES[1])
    out.append(json.dumps([json.loads(s.to_json()) for s in st.stats], sort_keys=True))
    return out


def _manifest(root):
    with open(os.path.join(root, "manifest.json")) as fh:
        return json.load(fh)


def _entry_sans(entry):
    """A manifest entry without what cannot agree between two saves: the
    uuid chunk names, the random mutation epoch, the journal stamp, and
    the uuid suffix of the port's partition snapshot dirs."""
    out = {k: v for k, v in entry.items() if k not in ("chunks", "epoch", "journal_seq")}
    if "partitions" in out:
        out["partitions"] = {b: rel.split("-")[0] for b, rel in out["partitions"].items()}
    return out


# -- round trips -----------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(kind, tmp_path):
    ds = _made("port", kind)
    root = str(tmp_path / "root")
    ds.save(root)
    got = _load_port(root)
    st = got._store("t")
    if kind != "flat":  # every partition attached cold: only meta.json was read
        assert not st.partitions and sorted(st.spilled) == ds._store("t").partition_bins()
        assert all(os.path.dirname(d) == os.path.join(root, "t_parts")
                   for d in st.spilled.values())
    assert got.list_schemas() == ["t"] and got.describe("t") == ds.describe("t")
    assert snapshot(got) == snapshot(ds)
    assert answers(got) == answers(ds)
    if kind == "flat":
        # the key cache is seeded: the next flush appends without a rebuild
        assert set(st._key_cols) == set(ds._store("t")._key_cols)
        assert st.mutation_epoch == ds._store("t").mutation_epoch
        got.insert("t", _data(50, seed=2), fids=_fids(50, prefix="n"))
        ds.insert("t", _data(50, seed=2), fids=_fids(50, prefix="n"))
        assert answers(got) == answers(ds)


POINT_NO_DATE = "name:String,*geom:Point"
POLY_SPEC = "name:String:index=true,height:Double:index=true,dtg:Date,*geom:Polygon"


def _poly_data(n=300, seed=5):
    rng = np.random.default_rng(seed)
    wkts = []
    for cx, cy in rng.uniform(-10, 10, (n, 2)):
        r = rng.uniform(0.2, 1.0)
        wkts.append(f"POLYGON (({cx} {cy}, {cx + r} {cy}, {cx} {cy + r}, {cx} {cy}))")
    return {"name": [f"p{i % 5}" for i in range(n)], "height": rng.uniform(0, 50, n),
            "dtg": rng.integers(parse_iso_ms("2020-01-01"), parse_iso_ms("2020-02-01"), n)
            .astype("datetime64[ms]"), "geom": wkts}


@pytest.mark.parametrize("which", ["point", "point-no-date", "polygon", "partitioned"])
def test_sketches_json_equal_to_the_reference(which):
    """Every sketch a store keeps serializes string-equal to the
    reference's for the same rows, and round-trips through its JSON."""
    spec, data = {"point": (SPEC, _data()), "partitioned": (PSPEC, _data()),
                  "point-no-date": (POINT_NO_DATE, {k: v for k, v in _data().items()
                                                    if k in ("name", "geom__x", "geom__y")}),
                  "polygon": (POLY_SPEC, _poly_data())}[which]
    kind = "partitioned" if which == "partitioned" else "flat"
    stores = [_made(c, kind, data=data, spec=spec)._store("t") for c in ("port", "jax")]
    p, j = (s.stats for s in stores)
    assert list(p) == list(j) and len(p) >= 3
    for k in p:
        assert p[k].to_json() == j[k].to_json(), k
        assert type(p[k]).from_json(p[k].to_json()).to_json() == p[k].to_json(), k


# -- flat checkpoints --------------------------------------------------------------------------
def _chunk_files(root, name="t"):
    d = os.path.join(root, f"{name}_chunks")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _stat(root, rel):
    s = os.stat(os.path.join(root, rel))
    return (s.st_ino, s.st_mtime_ns, s.st_size)


def test_incremental_chunks_and_full_rewrites(tmp_path):
    root = str(tmp_path / "root")
    ds = _made("port", "flat")
    ds.save(root)
    first = _manifest(root)["schemas"]["t"]
    assert first["rows"] == N and len(first["chunks"]) == 1
    before = _stat(root, first["chunks"][0])
    # appends: ONE new chunk, the old file untouched
    ds.insert("t", _data(100, seed=3), fids=_fids(100, prefix="b"))
    ds.save(root)
    second = _manifest(root)["schemas"]["t"]
    assert second["chunks"][0] == first["chunks"][0] and len(second["chunks"]) == 2
    assert second["epoch"] == first["epoch"] and second["rows"] == N + 100
    assert _stat(root, first["chunks"][0]) == before
    assert f"-{N}-{N + 100}-" in second["chunks"][1]
    assert snapshot(_load_port(root)) == snapshot(ds)
    # a save with nothing new writes nothing
    ds.save(root)
    assert _manifest(root)["schemas"]["t"]["chunks"] == second["chunks"]
    # a delete rewrites the rows: a full rewrite, old chunks swept
    ds.delete_features("t", "name = 'a5'")
    ds.save(root)
    third = _manifest(root)["schemas"]["t"]
    assert third["epoch"] != second["epoch"] and len(third["chunks"]) == 1
    assert ["t_chunks/" + f for f in _chunk_files(root)] == third["chunks"]
    assert snapshot(_load_port(root)) == snapshot(ds)
    # so does a column add
    ds.update_schema("t", "tag:String,seen:Date")
    ds.save(root)
    fourth = _manifest(root)["schemas"]["t"]
    assert fourth["epoch"] != third["epoch"] and fourth["chunks"] != third["chunks"]
    ds.insert("t", _data(40, seed=4, extra=True), fids=_fids(40, prefix="c"))
    ds.save(root)
    assert len(_manifest(root)["schemas"]["t"]["chunks"]) == 2
    loaded = _load_port(root)
    assert snapshot(loaded) == snapshot(ds)
    assert answers(loaded, queries=QUERIES + ["tag = 't1'", "tag IS NULL"]) == \
        answers(ds, queries=QUERIES + ["tag = 't1'", "tag IS NULL"])


def test_orphan_sweep(tmp_path):
    root = str(tmp_path / "root")
    ds = _made("port", "flat")
    os.makedirs(os.path.join(root, "t_chunks"))
    os.makedirs(os.path.join(root, "t_chunks_old"))
    for rel in ("t_chunks/chunk-99999-0-1-deadbeef.npz", "t_chunks_old/x.npz", "t.npz",
                "other.npz"):
        with open(os.path.join(root, rel), "wb") as fh:
            fh.write(b"stale")
    ds.save(root)
    entry = _manifest(root)["schemas"]["t"]
    assert ["t_chunks/" + f for f in _chunk_files(root)] == entry["chunks"]
    assert not os.path.exists(os.path.join(root, "t_chunks_old"))
    # files that are no chunk of a version-2 root are not the sweep's
    assert os.path.exists(os.path.join(root, "t.npz"))
    assert os.path.exists(os.path.join(root, "other.npz"))
    # a save restricted to other names leaves t's files alone
    ds.create_schema("u", "name:String,*geom:Point")
    ds.save(root, names=["u"])
    assert _manifest(root)["schemas"]["t"] == entry
    assert ["t_chunks/" + f for f in _chunk_files(root)] == entry["chunks"]
    # a named schema that no longer exists leaves the manifest
    ds.delete_schema("u")
    ds.save(root, names=["u"])
    assert sorted(_manifest(root)["schemas"]) == ["t"]


def test_mixed_vintage_chunks_load_as_the_reference(tmp_path):
    """A root whose first chunk predates ``update_schema`` (no column for
    the added attributes): both packages null-fill it by the schema's
    convention, to the same state; ``ColumnBatch.concat`` with
    ``schema_null_fills`` agrees column for column."""
    root = str(tmp_path / "root")
    ds = _made("port", "flat", data=_data(300))
    ds.save(root)
    entry = _manifest(root)["schemas"]["t"]
    ds.update_schema("t", "tag:String,seen:Date,flag:Boolean,n:Integer,v:Double")
    extra = dict(_data(200, seed=9, extra=True), flag=np.arange(200) % 2 == 0,
                 n=np.arange(200, dtype=np.int32), v=np.linspace(0, 1, 200))
    ds.insert("t", extra, fids=_fids(200, prefix="x"))
    ds.flush("t")
    st = ds._store("t")
    cols = {k: (v[300:].astype("U") if v.dtype.kind == "O" else v[300:])
            for k, v in st._all.columns.items()}
    cols["__vis__"] = np.zeros(200, np.int32)
    rel = "t_chunks/chunk-00001-300-500-00000000.npz"
    np.savez_compressed(os.path.join(root, rel), **cols)
    meta = _manifest(root)
    meta["schemas"]["t"].update(
        spec=st.ft.spec(), chunks=entry["chunks"] + [rel], rows=500,
        dicts={**ds._manifest_dicts(st)}, stats={k: v.to_json() for k, v in st.stats.items()})
    with open(os.path.join(root, "manifest.json"), "w") as fh:
        json.dump(meta, fh)
    p, j = _load_port(root), _load_jax(root)
    pst, jst = p._store("t"), j._store("t")
    for k, v in jst._all.columns.items():
        if k == "__vis__":
            continue
        np.testing.assert_array_equal(pst._all.columns[k], v, err_msg=k)
    assert set(pst._all.columns) | {"__vis__"} == set(jst._all.columns)
    assert snapshot(p) == snapshot(j) == snapshot(ds)
    q = QUERIES + ["tag IS NULL", "flag = false", "n = 0", "v IS NULL", "seen < 2000-01-01T00:00:00Z"]
    assert answers(p, queries=q) == answers(j, queries=q)
    # the concat itself, on the loaded chunks
    ft_p, ft_j = pst.ft, jst.ft
    parts = []
    for r in meta["schemas"]["t"]["chunks"]:
        with np.load(os.path.join(root, r)) as z:
            parts.append({k: z[k] for k in z.files})
    mine = columns.ColumnBatch.concat([columns.ColumnBatch(c, len(c["__fid__"])) for c in parts],
                                      fills=columns.schema_null_fills(ft_p))
    ref = jcolumns.ColumnBatch.concat([jcolumns.ColumnBatch(c, len(c["__fid__"])) for c in parts],
                                      fills=jcolumns.schema_null_fills(ft_j))
    assert list(mine.columns) == list(ref.columns)
    for k in ref.columns:
        assert mine.columns[k].dtype == ref.columns[k].dtype, k
        np.testing.assert_array_equal(mine.columns[k], ref.columns[k], err_msg=k)


# -- partitioned checkpoints ----------------------------------------------------------------------
def _part_stamp(d):
    s = os.stat(os.path.join(d, "part.lake"))
    return (s.st_ino, s.st_mtime_ns)


def test_incremental_partition_checkpoint_touches_only_the_dirty_one(tmp_path):
    root = str(tmp_path / "root")
    ds = _made("port", "partitioned")
    st = ds._store("t")
    ds.save(root)
    parts = _manifest(root)["schemas"]["t"]["partitions"]
    assert sorted(int(b) for b in parts) == st.partition_bins()
    stamps = {b: _part_stamp(os.path.join(root, rel)) for b, rel in parts.items()}
    # one row into one partition (resident or not)
    b0 = st.partition_bins()[1]
    one = _data(1, seed=99)
    one["dtg"] = np.array([_bin_ms(st, b0)]).astype("datetime64[ms]")
    ds.insert("t", one, fids=np.array(["z1"]))
    ds.save(root)
    parts2 = _manifest(root)["schemas"]["t"]["partitions"]
    # the dirty partition went into a new dir, the published one was
    # never overwritten and is swept once the new manifest is durable
    assert [b for b in parts2 if parts2[b] != parts[b]] == [str(b0)]
    assert not os.path.exists(os.path.join(root, parts[str(b0)]))
    stamps2 = {b: _part_stamp(os.path.join(root, rel)) for b, rel in parts2.items()}
    assert [b for b in parts2 if stamps2[b] != stamps[b]] == [str(b0)]
    assert sorted(os.listdir(os.path.join(root, "t_parts"))) == \
        sorted(os.path.basename(rel) for rel in parts2.values())
    # a save with nothing new rewrites nothing
    ds.save(root)
    assert _manifest(root)["schemas"]["t"]["partitions"] == parts2
    assert {b: _part_stamp(os.path.join(root, rel)) for b, rel in parts2.items()} == stamps2
    want = snapshot(ds)
    assert snapshot(_load_port(root)) == want
    # the checkpoint never aliases live state: deleting it leaves the
    # live store whole
    shutil.rmtree(root)
    st.spill_all()
    assert snapshot(ds) == want


def _bin_ms(st, b):
    """A time inside partition ``b``: the first row of it."""
    return int(st.child(b)._all.columns["dtg"][0])


def test_attached_snapshot_upgrades_on_load(tmp_path):
    """A partition snapshot older than the schema (saved before
    ``update_schema``, not rewritten since) upgrades when it loads, as the
    reference's does."""
    root = str(tmp_path / "root")
    pair = [_made(c, "spilled") for c in ("port", "jax")]
    for ds in pair:
        ds.update_schema("t", "tag:String")
        ds.save(root + type(ds).__module__.split(".")[0])
    p = _load_port(root + "geomesa_tpu_torch")
    j = _load_jax(root + "geomesa_tpu")
    assert p.get_schema("t").spec() == j.get_schema("t").spec()
    assert snapshot(p) == snapshot(j)
    assert answers(p, queries=QUERIES[:2] + ["tag IS NULL"]) == \
        answers(j, queries=QUERIES[:2] + ["tag IS NULL"])


# -- across packages ----------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_roots_interchange_with_the_reference(kind, tmp_path):
    """Each package saves the same rows; each root loads in the other
    package with answers and state equal to the saving store's, and the
    manifest entries agree apart from chunk names and the epoch."""
    pair = {c: _made(c, kind) for c in ("port", "jax")}
    roots = {c: str(tmp_path / c) for c in pair}
    for c, ds in pair.items():
        ds.save(roots[c])
    mp, mj = (_manifest(roots[c]) for c in ("port", "jax"))
    assert mp["version"] == mj["version"] == 2
    assert _entry_sans(mp["schemas"]["t"]) == _entry_sans(mj["schemas"]["t"])
    want = snapshot(pair["jax"])
    assert snapshot(pair["port"]) == want
    port_of_jax = _load_port(roots["jax"])
    jax_of_port = _load_jax(roots["port"])
    assert snapshot(port_of_jax) == snapshot(jax_of_port) == want
    assert answers(port_of_jax) == answers(jax_of_port) == answers(pair["port"])
    assert port_of_jax.describe("t") == jax_of_port.describe("t")
    if kind == "flat":
        for d in (port_of_jax, jax_of_port):
            assert d._store("t").mutation_epoch == _manifest(
                roots["jax" if d is port_of_jax else "port"])["schemas"]["t"]["epoch"]
    # and each saves the other's root back: the two entries still agree
    # (a loaded partitioned store merges its z3 histogram in bin order, the
    # live one in residency order, in both packages)
    port_of_jax.save(roots["jax"])
    jax_of_port.save(roots["port"])
    mp2, mj2 = (_manifest(roots[c]) for c in ("port", "jax"))
    assert _entry_sans(mp2["schemas"]["t"]) == _entry_sans(mj2["schemas"]["t"])
    if kind == "flat":
        assert _entry_sans(mj2["schemas"]["t"]) == _entry_sans(mj["schemas"]["t"])


def _mutations(ds, name="t"):
    """Every lifecycle record kind, as one writer's session."""
    ds.insert(name, _data(300, seed=11), fids=_fids(300, prefix="i"))
    ds.update_schema(name, "tag:String,seen:Date")
    ds.insert(name, _data(200, seed=12, extra=True), fids=_fids(200, prefix="j"))
    ds.add_attribute_index(name, "weight")
    ds.delete_features(name, f"BBOX(geom, -100, 30, -90, 40) AND {DURING}")
    ds.remove_attribute_index(name, "code")
    ds.age_off(name, "2020-01-08T00:00:00Z")
    ds.insert(name, _data(100, seed=13, extra=True), fids=_fids(100, prefix="k"))


MUT_QUERIES = QUERIES + ["tag = 't1'", "weight > 0.9", "code > 500000000000"]


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_across_packages(writer, kind, tmp_path):
    """One package journals a session after its checkpoint; each package
    loads the root, replays, and holds the writer's state."""
    root = str(tmp_path / "root")
    w = _made(writer, kind)
    w.save(root)
    w.attach_journal(root)
    _mutations(w)
    w.create_schema("u", "name:String,dtg:Date,*geom:Point")
    w.insert("u", {k: v for k, v in _data(50, seed=14).items()
                   if k in ("name", "dtg", "geom__x", "geom__y")}, fids=_fids(50, prefix="u"))
    p, j = _load_port(root), _load_jax(root)
    assert p._journal_replayed == j._journal_replayed == 10
    assert p.list_schemas() == j.list_schemas() == ["t", "u"]
    assert snapshot(p) == snapshot(j)
    # a partitioned store's merged sketches follow its residency history
    # (after remove_attribute_index only spilled partitions keep that
    # index's sketch), so the writer is held to rows and answers
    stats = kind == "flat"
    assert snapshot(p, stats=stats) == snapshot(w, stats=stats)
    assert snapshot(p, "u") == snapshot(j, "u") == snapshot(w, "u")
    assert answers(p, queries=MUT_QUERIES) == answers(w, queries=MUT_QUERIES)


@pytest.mark.parametrize("kind", ["flat", "partitioned"])
def test_every_record_kind_replays_to_the_reference_state(kind, tmp_path):
    """A journal-only root (no checkpoint) of every record kind: the port
    and the JAX package replay it to the same state, equal to the live
    store; then a checkpoint truncates the journal and nothing replays."""
    root = str(tmp_path / "root")
    ds = _port()
    ds.attach_journal(root)
    ds.create_schema("t", SPEC if kind == "flat" else PSPEC)
    _mutations(ds)
    ds.create_schema("gone", "name:String,*geom:Point")
    ds.delete_schema("gone")
    recs = ds._journal.records()
    assert sorted({r["kind"] for r in recs}) == sorted(
        ["schema-create", "insert", "update-schema", "add-index", "delete-features",
         "remove-index", "age-off", "delete-schema"])
    p, j = _load_port(root), _load_jax(root)
    assert p._journal_replayed == j._journal_replayed == len(recs)
    assert p.list_schemas() == j.list_schemas() == ["t"]
    assert snapshot(p) == snapshot(j)
    assert snapshot(p, stats=kind == "flat") == snapshot(ds, stats=kind == "flat")
    assert answers(p, queries=MUT_QUERIES) == answers(j, queries=MUT_QUERIES) \
        == answers(ds, queries=MUT_QUERIES)
    ds.save(root)
    assert ds._journal.status()["records"] == 0
    again = _load_port(root)
    assert again._journal_replayed == 0
    assert snapshot(again, stats=kind == "flat") == snapshot(ds, stats=kind == "flat")


def test_insert_without_fids_replays_with_fresh_fids(tmp_path):
    """The reference records ``fids=None`` and the replay draws new ids:
    the rows come back, their ids do not (a quirk kept)."""
    root = str(tmp_path / "root")
    ds = _port()
    ds.attach_journal(root)
    ds.create_schema("t", SPEC)
    ds.insert("t", _data(100))
    rec = ds._journal.records()[-1]
    assert rec["kind"] == "insert" and rec["fids"] is None and rec["vis"] is None
    got = _load_port(root)
    assert answers(got) == answers(ds)
    assert set(got.query("t").fids).isdisjoint(ds.query("t").fids)


def test_poisoned_record_is_skipped(tmp_path):
    """A record that cannot apply (the reference's row visibilities) is
    skipped into the trail; the others replay."""
    root = str(tmp_path / "root")
    j = JGeoDataset(n_shards=2)
    j.attach_journal(root)
    j.create_schema("t", SPEC)
    j.insert("t", _data(50), fids=_fids(50), visibilities="admin")
    j.insert("t", _data(60, seed=3), fids=_fids(60, prefix="v"))
    resilience.skipped(clear=True)
    p = _load_port(root)
    assert p._journal_replayed == 2 and p.count("t") == 60
    (skip,) = resilience.skipped(clear=True)
    assert skip.source == "journal.replay" and skip.part == "t@2" and "visibilities" in skip.error


def test_visibility_codes_refused_on_load(tmp_path):
    root = str(tmp_path / "root")
    j = JGeoDataset(n_shards=2)
    j.create_schema("t", SPEC)
    j.insert("t", _data(50), fids=_fids(50), visibilities="admin")
    j.save(root)
    with pytest.raises(NotImplementedError, match="visibilities"):
        _load_port(root)


def test_save_elsewhere_neither_stamps_nor_truncates(tmp_path):
    root, other = str(tmp_path / "root"), str(tmp_path / "other")
    ds = _port()
    ds.attach_journal(root)
    ds.create_schema("t", SPEC)
    ds.insert("t", _data(100), fids=_fids(100))
    ds.save(other)
    assert "journal_seq" not in _manifest(other)["schemas"]["t"]
    assert not os.path.exists(os.path.join(other, "journal"))
    assert ds._journal.status()["records"] == 2
    ds.save(root)
    assert _manifest(root)["schemas"]["t"]["journal_seq"] == 2
    assert ds._journal.status()["records"] == 0


def test_load_without_manifest_or_journal_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _load_port(str(tmp_path))
    with config.JOURNAL_ENABLED.scoped("false"):
        ds = _made("port", "flat")
        ds.attach_journal(str(tmp_path / "r"))
        assert ds._journal is None
        ds.save(str(tmp_path / "r"))
        assert _load_port(str(tmp_path / "r"))._journal is None


# -- tombstones ---------------------------------------------------------------------------------
def test_delete_schema_tombstone_survives_replay(tmp_path):
    root = str(tmp_path)
    ds = _port()
    ds.attach_journal(root)
    ds.create_schema("t", SPEC)
    ds.insert("t", _data(8), fids=_fids(8))
    ds.delete_schema("t")
    assert "t" not in _load_port(root)._stores
    assert "t" not in _load_jax(root)._stores


def test_delete_schema_tombstone_after_checkpoint(tmp_path):
    root = str(tmp_path)
    ds = _port()
    ds.attach_journal(root)
    ds.create_schema("t", SPEC)
    ds.insert("t", _data(8), fids=_fids(8))
    ds.flush()
    ds.save(root)
    ds.delete_schema("t")  # journaled, not checkpointed yet
    ds2 = _load_port(root)
    assert "t" not in ds2._stores and "t" not in _load_jax(root)._stores
    ds2.save(root)  # the next checkpoint makes the drop durable alone
    assert "t" not in _load_port(root)._stores


# -- refresh_schema -------------------------------------------------------------------------------
def test_refresh_schema_cases(tmp_path):
    """A writer and a reader on one root: the journal-only catch-up applies
    exactly the records written since; a schema created remotely (in the
    journal alone) appears; a remote delete drops it; an entry rewritten
    out of band (a save without the journal) forces the full re-attach."""
    root = str(tmp_path / "root")
    w = _made("port", "flat")
    w.save(root)
    w.attach_journal(root)
    r = _load_port(root)
    assert r._journal is not None and r._applied_seq["t"] == 0
    # 1. incremental catch-up
    w.insert("t", _data(30, seed=21), fids=_fids(30, prefix="a"))
    w.delete_features("t", "name = 'a4'")
    replays = []
    real = r._apply_record
    r._apply_record = lambda rec: replays.append(rec["seq"]) or real(rec)
    assert r.refresh_schema("t", root) is True
    assert replays == [1, 2] and snapshot(r) == snapshot(w)
    assert r.refresh_schema("t", root) is False and replays == [1, 2]
    # 2. a remote create
    w.create_schema("u", "name:String,*geom:Point")
    w.insert("u", {"name": ["x", "y"], "geom__x": [1.0, 2.0], "geom__y": [3.0, 4.0]},
             fids=["u1", "u2"])
    assert r.refresh_schema("u", root) is True and r.count("u") == 2
    # 3. a remote delete
    w.delete_schema("u")
    assert r.refresh_schema("u", root) is True and "u" not in r._stores
    assert r.refresh_schema("u", root) is False
    # the writer's checkpoint moves the entry: the reader re-attaches it
    w.save(root)
    assert r.refresh_schema("t", root) is True and snapshot(r) == snapshot(w)
    # 4. an out-of-band rewrite: a save without the journal
    other = _port()
    other.create_schema("t", SPEC)
    other.insert("t", _data(77, seed=5), fids=_fids(77, prefix="o"))
    other.save(root)
    assert r.refresh_schema("t", root) is True
    assert snapshot(r) == snapshot(other) and r.count("t") == 77
    # the reference reads the same
    j = _load_jax(root)
    assert snapshot(j) == snapshot(r)


def test_refresh_schema_without_journal(tmp_path):
    root = str(tmp_path / "root")
    with config.JOURNAL_ENABLED.scoped("false"):
        w = _made("port", "partitioned")
        w.save(root)
        r = _load_port(root)
        w.insert("t", _data(20, seed=8), fids=_fids(20, prefix="q"))
        assert r.count("t") == N
        w.save(root)
        assert r.refresh_schema("t", root) is True and snapshot(r) == snapshot(w)
        w.delete_schema("t")
        w.save(root, names=["t"])
        assert r.refresh_schema("t", root) is True and r.list_schemas() == []


def test_acked_insert_after_a_truncating_checkpoint_survives_a_reload(tmp_path):
    """A save that truncates every journal segment, a reload, one acked
    insert, a second reload: the insert replays (its record sequences after
    the manifest's stamp). The reference's journal restarts its sequence at
    1 there, and its reload skips the record as checkpointed."""
    root = str(tmp_path / "root")
    ds = _port()
    ds.attach_journal(root)
    ds.create_schema("t", SPEC)
    ds.insert("t", _data(20), fids=_fids(20))
    ds.save(root)
    assert ds._journal.status()["segments"] == []
    a = _load_port(root)
    a.insert("t", _data(5, seed=2), fids=_fids(5, prefix="new"))
    assert a._journal.last_seq() == _manifest(root)["schemas"]["t"]["journal_seq"] + 1
    b = _load_port(root)
    assert b._journal_replayed == 1 and b.count("t") == 25
    assert b.count("t", "IN ('new0', 'new4')") == 2
