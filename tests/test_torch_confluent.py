"""PyTorch port vs the JAX package: the Avro codec and the Confluent ingest.

The same features go through both packages' Avro codec
(``io/avro_io.py``), schema registry and framed serializers: the bytes are
equal, each package decodes the other's, and schema evolution resolves the
same way in both directions. Framed records drive both packages'
``StreamingDataset`` (the port on ``device="cpu"``) through
``attach_confluent``: live caches, tombstones, quarantine counters of
poison records and injected faults, the lag gauges and the journaled
resume offset, which each package reads from the other's root. The
reference tests of ``tests/test_confluent.py`` and the Confluent tests of
``test_crash.py``, ``test_chaos.py`` and ``test_serving.py`` run through
both.
"""

import io
import struct
import time

import numpy as np
import pytest
import torch

import geomesa_tpu.io.avro_io as javro
import geomesa_tpu.stream.confluent as jconfluent
from geomesa_tpu import audit as jaudit
from geomesa_tpu import config as jconfig
from geomesa_tpu import metrics as jmetrics
from geomesa_tpu.resilience import inject_faults as jinject_faults
from geomesa_tpu.schema.feature_type import FeatureType as JFeatureType
from geomesa_tpu.stream import live as jlive
from geomesa_tpu.stream import messages as jmessages
from geomesa_tpu_torch import audit, config, metrics
from geomesa_tpu_torch.io import avro_io
from geomesa_tpu_torch.resilience import inject_faults
from geomesa_tpu_torch.schema.columns import ColumnBatch, encode_batch
from geomesa_tpu_torch.schema.feature_type import FeatureType
from geomesa_tpu_torch.stream import confluent, live, messages

SPEC = "name:String,speed:Double,dtg:Date,*geom:Point"
CSPEC = "name:String,weight:Double,dtg:Date,*geom:Point"
FULL = ("name:String,n:Integer,l:Long,f:Float,d:Double,b:Boolean,j:Json,dtg:Date,"
        "*geom:Point")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (OpenMP workers spin under a
    parallel test runner)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {
    "jax": (jconfluent, jlive, jmessages, JFeatureType),
    "port": (confluent, live, messages, FeatureType),
}


def _sds(pkg, **kw):
    if pkg is live:
        return live.StreamingDataset(device="cpu", **kw)
    return pkg.StreamingDataset(**kw)


def _record(i):
    return {"name": "even" if i % 2 == 0 else "odd", "speed": float(i),
            "dtg": 1578182400000 + i, "geom": f"POINT ({i} 1)"}


# -- the Avro codec -----------------------------------------------------------------------------

@pytest.mark.parametrize("v", [0, 1, -1, 63, -64, 64, 2 ** 31, -(2 ** 40), 2 ** 62])
def test_zigzag_varints_equal(v):
    a, b = io.BytesIO(), io.BytesIO()
    avro_io.write_long(a, v)
    javro.write_long(b, v)
    assert a.getvalue() == b.getvalue()
    assert avro_io.read_long(io.BytesIO(a.getvalue())) == v


def test_avro_schema_equal():
    for spec in (SPEC, FULL, "dtg:Date,*geom:Polygon"):
        ft, jft = FeatureType.from_spec("s", spec), JFeatureType.from_spec("s", spec)
        assert avro_io.avro_schema(ft) == javro.avro_schema(jft)
        assert avro_io.avro_schema(ft, ["name"]) == javro.avro_schema(jft, ["name"])


def _full_batch(n=40, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "name": [None if i % 7 == 0 else f"s{i % 4}" for i in range(n)],
        "n": rng.integers(-1000, 1000, n).astype(np.int32),
        "l": rng.integers(-2 ** 40, 2 ** 40, n),
        "f": rng.uniform(-5, 5, n).astype(np.float32),
        "d": np.where(np.arange(n) % 5 == 0, np.nan, rng.uniform(-5, 5, n)),
        "b": rng.integers(0, 2, n).astype(bool),
        "j": [None if i % 3 == 0 else {"k": i, "s": [i, "x"]} for i in range(n)],
        "dtg": 1578182400000 + rng.integers(0, 10 ** 9, n),
        "geom__x": rng.uniform(-180, 180, n),
        "geom__y": rng.uniform(-90, 90, n),
    }


def test_avro_container_file_round_trip_and_bytes(tmp_path):
    from geomesa_tpu.schema.columns import encode_batch as jencode_batch

    ft, jft = FeatureType.from_spec("s", FULL), JFeatureType.from_spec("s", FULL)
    data = _full_batch()
    fids = [f"f{i}" for i in range(40)]
    d, jd = {}, {}
    b = encode_batch(ft, data, d, fids)
    jb = jencode_batch(jft, data, jd, fids)
    sync = bytes(range(16))
    out, jout = io.BytesIO(), io.BytesIO()
    avro_io.write_avro(out, ft, b, d, sync=sync)
    javro.write_avro(jout, jft, jb, jd, sync=sync)
    assert out.getvalue() == jout.getvalue()
    path = str(tmp_path / "f.avro")
    avro_io.write_avro(path, ft, b, d, sync=sync)
    schema, recs = avro_io.read_avro(path)
    jschema, jrecs = javro.read_avro(io.BytesIO(jout.getvalue()))
    assert schema == jschema and len(recs) == 40
    for r, jr in zip(recs, jrecs):
        assert r.keys() == jr.keys()
        for k in r:
            if isinstance(jr[k], float) and np.isnan(jr[k]):
                assert np.isnan(r[k])
            else:
                assert r[k] == jr[k], k
    # a projected batch writes the reduced schema
    proj = ColumnBatch({k: v for k, v in b.columns.items()
                        if k in ("name", "__fid__", "geom__x", "geom__y")}, b.n)
    buf = io.BytesIO()
    avro_io.write_avro(buf, ft, proj, d, sync=sync)
    s2, _ = avro_io.read_avro(io.BytesIO(buf.getvalue()))
    assert [f["name"] for f in s2["fields"]] == ["__fid__", "name", "geom"]
    with pytest.raises(ValueError, match="not an Avro"):
        avro_io.read_avro(io.BytesIO(b"nope" + bytes(20)))


# -- registry, frames, evolution ----------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_registry_ids_and_versions(pkg):
    cf, _, _, FT = PKGS[pkg]
    reg = cf.SchemaRegistry()
    ft1 = FT.from_spec("s", SPEC)
    ft2 = FT.from_spec("s", SPEC + ",extra:Integer")
    s1 = cf.ConfluentSerializer(reg, "s-value", ft1)
    s2 = cf.ConfluentSerializer(reg, "s-value", ft2)
    assert s1.schema_id != s2.schema_id
    assert reg.versions("s-value") == [s1.schema_id, s2.schema_id]
    assert reg.latest("s-value")[0] == s2.schema_id
    assert cf.ConfluentSerializer(reg, "other", ft1).schema_id == s1.schema_id
    with pytest.raises(KeyError):
        reg.by_id(999)
    with pytest.raises(KeyError):
        reg.latest("missing")


def test_registries_assign_the_same_ids():
    reg, jreg = confluent.SchemaRegistry(), jconfluent.SchemaRegistry()
    for i, extra in enumerate(("", ",rank:Integer", "", ",rank:Integer,tag:String")):
        spec = SPEC + extra
        a = confluent.ConfluentSerializer(reg, f"s{i % 2}", FeatureType.from_spec("s", spec))
        b = jconfluent.ConfluentSerializer(jreg, f"s{i % 2}", JFeatureType.from_spec("s", spec))
        assert a.schema_id == b.schema_id and a.schema == b.schema
    assert reg._subjects == jreg._subjects
    assert {k: reg.by_id(k) for k in reg._by_id} == {k: jreg.by_id(k) for k in jreg._by_id}


def test_wire_format_and_round_trip():
    reg, jreg = confluent.SchemaRegistry(), jconfluent.SchemaRegistry()
    ft, jft = FeatureType.from_spec("s", SPEC), JFeatureType.from_spec("s", SPEC)
    ser = confluent.ConfluentSerializer(reg, "s-value", ft)
    jser = jconfluent.ConfluentSerializer(jreg, "s-value", jft)
    feat = {"name": "alice", "speed": 12.5, "dtg": 1578182400000, "geom": "POINT (10 20)"}
    data = ser.serialize("f1", feat)
    assert data == jser.serialize("f1", feat)
    assert data[0] == 0 and struct.unpack(">I", data[1:5])[0] == ser.schema_id
    de = confluent.ConfluentDeserializer(reg, ft)
    fid, attrs = de.deserialize(data)
    assert (fid, attrs) == jconfluent.ConfluentDeserializer(jreg, jft).deserialize(data)
    assert fid == "f1" and attrs["name"] == "alice" and attrs["speed"] == 12.5
    assert attrs["dtg"] == 1578182400000 and attrs["geom"] == "POINT (10 20)"
    with pytest.raises(ValueError, match="magic"):
        de.deserialize(b"\x01junk")
    # nulls and NaN ride the union's null branch in both
    nul = {"name": None, "speed": float("nan"), "dtg": None, "geom": None}
    assert ser.serialize("f2", nul) == jser.serialize("f2", nul)
    assert de.deserialize(ser.serialize("f2", nul))[1] == \
        {"name": None, "speed": None, "dtg": None, "geom": None}


def test_schema_evolution_both_directions():
    """Old writer -> new reader fills defaults; new writer -> old reader
    drops the unknown field; each package reads the other's frames."""
    out = {}
    for pkg in ("jax", "port"):
        cf, _, _, FT = PKGS[pkg]
        reg = cf.SchemaRegistry()
        v1, v2 = FT.from_spec("s", SPEC), FT.from_spec("s", SPEC + ",rank:Integer")
        s1, s2 = cf.ConfluentSerializer(reg, "s-value", v1), cf.ConfluentSerializer(reg, "s-value", v2)
        old = s1.serialize("a", {"name": "x", "speed": 1.0, "dtg": 0, "geom": "POINT (0 0)"})
        new = s2.serialize("b", {"name": "y", "speed": 2.0, "dtg": 0, "geom": "POINT (1 1)",
                                 "rank": 7})
        de_new, de_old = cf.ConfluentDeserializer(reg, v2), cf.ConfluentDeserializer(reg, v1)
        _, a = de_new.deserialize(old)
        assert a["rank"] is None
        _, b = de_new.deserialize(new)
        assert b["rank"] == 7
        _, c = de_old.deserialize(new)
        assert "rank" not in c and c["name"] == "y"
        out[pkg] = (old, new, a, b, c, reg)
    assert out["port"][:5] == out["jax"][:5]
    # the port's deserializers read frames the JAX package's registry holds
    jreg = out["jax"][5]
    preg = confluent.SchemaRegistry()
    preg._by_id, preg._subjects = dict(jreg._by_id), dict(jreg._subjects)
    de = confluent.ConfluentDeserializer(preg, FeatureType.from_spec("s", SPEC + ",rank:Integer"))
    assert de.deserialize(out["jax"][0])[1] == out["jax"][2]
    assert de.deserialize(out["jax"][1])[1] == out["jax"][3]


# -- ingest into the live window -----------------------------------------------------------------

def _ingest_pair(name="t", spec=SPEC, **kw):
    out = []
    for pkg in ("jax", "port"):
        cf, lv, _, _ = PKGS[pkg]
        sds = _sds(lv, **kw)
        sds.create_schema(name, spec)
        reg = cf.SchemaRegistry()
        ser, ingest = cf.attach_confluent(sds, name, reg)
        out.append((sds, reg, ser, ingest, cf))
    return out


def _same_cache(jsds, psds, name):
    """The same features with the same columns. A record without
    ``ts_ms`` (and a tombstone) takes the wall clock as its event time, and
    ``poll`` orders by it, so rows (and first-seen dictionary codes)
    compare by fid and decoded value."""
    from geomesa_tpu_torch.schema.columns import fid_strs

    jb, pb = jsds.cache(name).batch(), psds.cache(name).batch()
    assert pb.n == jb.n and set(pb.columns) == set(jb.columns)
    jf, pf = fid_strs(jb.columns["__fid__"]), fid_strs(pb.columns["__fid__"])
    jo, po = np.argsort(jf, kind="stable"), np.argsort(pf, kind="stable")
    assert pf[po].tolist() == jf[jo].tolist()
    jd, pd = jsds.cache(name).dicts, psds.cache(name).dicts
    for k, a in jb.columns.items():
        if k == "__fid__":
            continue
        got, want = pb.columns[k][po], a[jo]
        if k in jd:
            got, want = pd[k].decode(got), jd[k].decode(want)
            assert got == want, k
        elif want.dtype == object:
            assert list(got) == list(want), k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_streaming_ingest_and_tombstone():
    sides = _ingest_pair()
    for sds, reg, ser, ingest, cf in sides:
        for i in range(20):
            assert ingest(ser.serialize(f"f{i}", _record(i))) == f"f{i}"
        sds.poll("t")
        assert len(sds.cache("t")) == 20 and sds.query("t", "speed > 15.5").n == 4
        FT = JFeatureType if cf is jconfluent else FeatureType
        ser2 = cf.ConfluentSerializer(reg, "t-value", FT.from_spec("t", SPEC + ",rank:Integer"))
        ingest(ser2.serialize("f99", {"name": "new", "speed": 50.0, "dtg": 1578182500000,
                                      "geom": "POINT (5 5)", "rank": 1}))
        sds.poll("t")
        assert len(sds.cache("t")) == 21
        assert ingest(None, fid="f0") == "f0"
        sds.poll("t")
        assert len(sds.cache("t")) == 20 and sds.query("t", "name = 'even'").n == 9
    _same_cache(sides[0][0], sides[1][0], "t")


def test_ingest_all_attribute_types():
    """Every type the codec carries through ``attach_confluent``: nulls
    take the edge's fills (NaN, "", 0, the record time) in both."""
    sides = _ingest_pair(spec=FULL)
    recs = [
        {"name": "a", "n": 3, "l": 2 ** 40, "f": 1.5, "d": -2.25, "b": True,
         "j": '{"k": 1}', "dtg": 1578182400000, "geom": "POINT (1.5 -2)"},
        {"name": None, "n": None, "l": None, "f": None, "d": None, "b": None,
         "j": None, "dtg": None, "geom": "POINT (3 4)"},
    ]
    for sds, reg, ser, ingest, cf in sides:
        for i, r in enumerate(recs):
            assert ingest(ser.serialize(f"r{i}", r), ts_ms=1578182400000 + i) == f"r{i}"
        sds.poll("t")
    _same_cache(sides[0][0], sides[1][0], "t")


def _ctr(reg, name):
    return reg.counter(name).value


def test_confluent_poison_record_quarantines():
    sides = _ingest_pair("c", CSPEC)
    for (sds, reg, ser, ingest, cf), mreg, trail in zip(
            sides, (jmetrics.registry(), metrics.registry()), (jaudit, audit)):
        before = (_ctr(mreg, "stream.confluent.quarantined"),
                  _ctr(mreg, "stream.confluent.quarantined.c"))
        trail.degradations.clear()
        assert ingest(b"\x01not-a-frame") == ""
        assert ingest(None) == ""
        assert ingest(b"\x00\x00\x00\x03\xe7junk") == ""  # unknown schema id
        assert _ctr(mreg, "stream.confluent.quarantined") == before[0] + 3
        assert _ctr(mreg, "stream.confluent.quarantined.c") == before[1] + 3
        assert sum(e.source == "stream.confluent.ingest"
                   for e in trail.degradations.recent()) == 3
        ingest(ser.serialize("f1", {"name": "ok", "weight": 1.0, "dtg": 1578182400000,
                                    "geom": "POINT (1 2)"}))
        sds.poll("c")
        assert len(sds.cache("c")) == 1
    _same_cache(sides[0][0], sides[1][0], "c")


def test_confluent_injected_fault_quarantines():
    sides = _ingest_pair("c", CSPEC)
    good = [s[2].serialize("f1", {"name": "ok", "weight": 1.0, "dtg": 1578182400000,
                                  "geom": "POINT (1 2)"}) for s in sides]
    assert good[0] == good[1]
    for (sds, reg, ser, ingest, cf), g, cfg, inj_of, mreg in zip(
            sides, good, (jconfig, config), (jinject_faults, inject_faults),
            (jmetrics.registry(), metrics.registry())):
        before = _ctr(mreg, "stream.confluent.quarantined.c")
        with cfg.FAULT_INJECTION.scoped("true"), inj_of(seed=6) as inj:
            inj.fail("stream.confluent.ingest", ValueError("decoder blew up"), times=1)
            assert ingest(g) == ""
            assert ingest(g) == "f1"
        assert _ctr(mreg, "stream.confluent.quarantined.c") == before + 1
        sds.poll("c")
        assert len(sds.cache("c")) == 1


def test_confluent_apply_lag():
    past = int(time.time() * 1000) - 3_000
    for pkg, mreg in (("jax", jmetrics.registry()), ("port", metrics.registry())):
        cf, lv, _, _ = PKGS[pkg]
        sds = _sds(lv)
        sds.create_schema("c", "a:Integer,dtg:Date,*geom:Point")
        ser, ingest = cf.attach_confluent(sds, "c", cf.SchemaRegistry())
        n0 = mreg.timer(metrics.STREAM_APPLY).count
        ingest(ser.serialize("f1", {"a": 1, "dtg": past, "geom": "POINT(1 2)"}), ts_ms=past)
        assert mreg.gauge("stream.lag.c").value >= 3_000
        assert mreg.gauge(metrics.STREAM_LAG).value >= 3_000
        assert mreg.timer(metrics.STREAM_APPLY).count == n0 + 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_confluent_offset_resume(tmp_path, writer):
    """The reference's resume test; the root then reads in both packages:
    the same resume offset and the same live cache."""
    root = str(tmp_path)
    cf, lv, msg, _ = PKGS[writer]
    bus = msg.MessageBus()
    sds = _sds(lv, bus=bus, partitions=1)
    sds.attach_journal(root)
    sds.create_schema("t", CSPEC)
    ser, ingest = cf.attach_confluent(sds, "t", cf.SchemaRegistry())
    for off in range(3):
        payload = ser.serialize(f"f{off}", {"name": f"n{off}", "weight": 1.0,
                                            "dtg": 1577836800000 + off, "geom": "POINT (0 0)"})
        assert ingest(payload, ts_ms=1577836800000 + off, offset=off)
    # a quarantined record journals no offset
    assert ingest(b"\x05bad", offset=3) == ""
    assert cf.confluent_resume_offset(sds, "t") == 2
    sds.poll("t")
    want = sds.cache("t").batch()
    sds._journal.close()
    for pkg in ("jax", "port"):
        rcf, rlv, rmsg, _ = PKGS[pkg]
        rbus = rmsg.MessageBus()
        rbus.create("geomesa-t", 1)._logs = [list(log) for log in bus.topic("geomesa-t")._logs]
        sds2 = _sds(rlv, bus=rbus, partitions=1)
        sds2.attach_journal(root)
        sds2.recover()
        assert rcf.confluent_resume_offset(sds2, "t") == 2
        assert sds2.poll("t") == 0
        np.testing.assert_array_equal(sds2.cache("t").batch().columns["dtg"], want.columns["dtg"])
        sds2._journal.close()
    assert confluent.confluent_resume_offset(live.StreamingDataset(device="cpu"), "t") == -1
