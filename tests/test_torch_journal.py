"""PyTorch port vs the JAX package: the write-ahead mutation journal.

The port's ``fs/journal.py`` against ``geomesa_tpu/fs/journal.py``: the
segment files (frames, magic, names) of the same records are byte-equal;
``enc_value`` / ``dec_value`` round-trip every value kind bit for bit in
both directions; each package reads the other's segments; concurrent
writers group-commit with every acked sequence number present once after
a reopen; a torn tail truncates at the last valid frame; a corrupt crc
stops the replay there; segments roll at the size threshold; and a
checkpoint deletes only the segments it covers. Modelled on
``tests/test_crash.py``'s journal tests.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu.fs import journal as jjournal
from geomesa_tpu_torch import config, resilience
from geomesa_tpu_torch.fs import journal
from geomesa_tpu_torch.fs.journal import MutationJournal


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (tests of the port pin it under a
    parallel test runner)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segs(root):
    d = os.path.join(root, journal.JOURNAL_DIR)
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".gmj")]


def _columns(n=64, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "name": [f"n{i % 5}" if i % 7 else None for i in range(n)],
        "weight": rng.uniform(0, 1, n).astype(np.float32),
        "code": rng.integers(-(1 << 40), 1 << 40, n),
        "dtg": rng.integers(1577836800000, 1583020800000, n).astype("datetime64[ms]"),
        "geom__x": rng.uniform(-120, -70, n),
        "geom__y": rng.uniform(25, 50, n),
        "ok": rng.integers(0, 2, n).astype(bool),
    }


def _records():
    """(record, blob sink) pairs of every kind the dataset journals."""
    out = []
    sink = []
    cols = _columns()
    out.append(({"kind": "insert", "schema": "t", "data": journal.enc_columns(cols, sink),
                 "fids": journal.enc_value(np.arange(64).astype(str), sink), "vis": None},
                sink))
    out.append(({"kind": "schema-create", "schema": "t",
                 "spec": "name:String,weight:Float,dtg:Date,*geom:Point", "n_shards": 2}, None))
    out.append(({"kind": "delete-features", "schema": "t", "ecql": "weight > 0.5",
                 "auths": None}, None))
    out.append(({"kind": "update-schema", "schema": "t", "add_spec": "extra:Integer"}, None))
    out.append(({"kind": "age-off", "schema": "t", "older_than_ms": 1578787200000}, None))
    out.append(({"kind": "add-index", "schema": "t", "attr": "name"}, None))
    out.append(({"kind": "remove-index", "schema": "t", "attr": "name"}, None))
    out.append(({"kind": "delete-schema", "schema": "t"}, None))
    return out


# -- frames ---------------------------------------------------------------------------------
def test_segments_byte_equal_to_the_reference(tmp_path):
    """The same records appended in the same order give the same segment
    file, name and bytes (one process, so the pid in the name agrees)."""
    roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for root, mod in zip(roots, (journal, jjournal)):
        j = mod.MutationJournal(root)
        for rec, blobs in _records():
            j.append(rec, blobs=blobs)
        j.close()
    ps, js = _segs(roots[0]), _segs(roots[1])
    assert [os.path.basename(p) for p in ps] == [os.path.basename(p) for p in js]
    for p, q in zip(ps, js):
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()


def test_frame_of_each_record(tmp_path):
    """``frame`` (the bytes ``append`` writes for a record at its seq)
    equals the reference's frame read back from its segment."""
    j = jjournal.MutationJournal(str(tmp_path))
    recs = _records()
    for rec, blobs in recs:
        j.append(rec, blobs=blobs)
    j.close()
    with open(_segs(str(tmp_path))[0], "rb") as fh:
        buf = fh.read()
    assert buf[:4] == b"GMJ2"
    off = 4
    for seq, (rec, blobs) in enumerate(recs, start=1):
        want = journal.frame(dict(rec, seq=seq), b"".join(blobs or []))
        assert buf[off:off + len(want)] == want, rec["kind"]
        off += len(want)
    assert off == len(buf)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_segments(writer, tmp_path):
    root = str(tmp_path)
    wmod, rmod = (journal, jjournal) if writer == "port" else (jjournal, journal)
    j = wmod.MutationJournal(root)
    for rec, blobs in _records():
        j.append(rec, blobs=blobs)
    j.close()
    r = rmod.MutationJournal(root)
    got = r.records()
    assert [g["kind"] for g in got] == [rec["kind"] for rec, _ in _records()]
    assert [int(g["seq"]) for g in got] == list(range(1, 9))
    cols = rmod.dec_columns(got[0]["data"])
    want = _columns()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert cols[k].dtype == v.dtype and cols[k].tobytes() == v.tobytes(), k
        else:
            assert cols[k] == v, k
    assert rmod.dec_value(got[0]["fids"]) == [str(i) for i in range(64)]
    assert r.append({"kind": "noop", "schema": "t"}) == 9  # sequence continues
    r.close()


# -- the value codec -------------------------------------------------------------------------
VALUES = {
    "none": None,
    "bool": True,
    "int": -(1 << 53) + 1,
    "float": 0.1,
    "nan": float("nan"),
    "str": "é–x",
    "dt64": np.datetime64("2020-01-02T03:04:05.678", "ms"),
    "dt64_s": np.datetime64("2020-01-02T03:04:05", "s"),
    "np_f32": np.float32(1.25),
    "np_i64": np.int64(-7),
    "np_bool": np.bool_(True),
    "f32": np.array([0.1, -0.0, np.inf, np.nan], np.float32),
    "f64": np.linspace(-1, 1, 7),
    "i32": np.array([-1, 0, 2 ** 31 - 1], np.int32),
    "i64": np.array([-(1 << 62), 1 << 40], np.int64),
    "u64": np.array([1 << 63], np.uint64),
    "bool_arr": np.array([True, False]),
    "dt_arr": np.array(["2020-01-01", "2021-06-30"], "datetime64[ms]"),
    "dt_arr_s": np.array(["2020-01-01T00:00:01"], "datetime64[s]"),
    "big_endian": np.array([1.5, 2.5], ">f8"),
    "matrix": np.arange(6, dtype=np.int16).reshape(2, 3),
    "str_arr": np.array(["a", "bc"]),
    "obj_arr": np.array(["a", None, "POINT (1 2)"], object),
    "tuple": (1.5, -2.5),
    "plist": [1, 2.5, "x", None, True],
    "list_mixed": [(0.0, 1.0), np.int32(4), [1, 2]],
    "bytes": b"\x00\xff\x10",
    "map": {"a": (1.0, 2.0), "b": [np.datetime64(0, "ms")], "c": None},
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("sink", [True, False], ids=["blob", "base64"])
@pytest.mark.parametrize("kind", sorted(VALUES))
def test_value_codec_round_trips_both_ways(kind, sink, tmp_path):
    """The port encodes exactly as the reference does, and each package
    decodes the other's encoding to the same value, bits included."""
    v = VALUES[kind]
    ps, js = ([] if sink else None), ([] if sink else None)
    pe, je = journal.enc_value(v, ps), jjournal.enc_value(v, js)
    assert pe == je or kind == "nan" and repr(pe) == repr(je)
    assert ps == js
    # through a segment, so blob markers are re-attached as on replay
    outs = []
    for mod, dec, enc, blobs in ((journal, jjournal, pe, ps), (jjournal, journal, je, js)):
        root = str(tmp_path / mod.__name__.split(".")[0])
        j = mod.MutationJournal(root)
        j.append({"kind": "noop", "schema": "t", "v": enc}, blobs=blobs)
        j.close()
        outs.append(dec.dec_value(dec.MutationJournal(root).records()[0]["v"]))
    want = jjournal.dec_value(jjournal.MutationJournal(str(tmp_path / "geomesa_tpu"))
                              .records()[0]["v"])
    for got in outs:
        assert _same(got, want), (kind, got, want)


# -- group commit -------------------------------------------------------------------------------
def test_group_commit_concurrent_appends_all_durable(tmp_path):
    """Eight writer threads: every acked seq is present after a reopen,
    exactly once, and groups held more than one record."""
    root = str(tmp_path)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches inside append
    try:
        with config.JOURNAL_GROUP_MS.scoped("5"):
            j = MutationJournal(root)
            acked = []
            lock = threading.Lock()

            def writer(t):
                for i in range(25):
                    seq = j.append({"kind": "noop", "schema": "t", "writer": t, "i": i})
                    with lock:
                        acked.append(seq)

            threads = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            j.close()
    finally:
        sys.setswitchinterval(interval)
    assert len(acked) == 200 and len(set(acked)) == 200
    c = j.counters()
    assert c["appends"] == 200 and sum(k * v for k, v in c["groups"].items()) == 200
    assert c["fsyncs"] == sum(c["groups"].values()) < 200 and c["max_group"] > 1
    j2 = MutationJournal(root)
    assert sorted(int(r["seq"]) for r in j2.records()) == sorted(acked)
    st = j2.status()
    assert st["records"] == 200 and st["last_seq"] == 200 and st["pending"] == 0
    j2.close()


# -- injected faults ----------------------------------------------------------------------------
def test_injected_fsync_failure_is_never_acked(tmp_path):
    """A failed group fsync raises ``JournalError`` in the appender (the
    mutation is not acked) and rolls to a fresh segment; later appends
    commit, and the reopened journal holds what was acked. Injection needs
    ``geomesa.fault.injection``."""
    root = str(tmp_path)
    with pytest.raises(RuntimeError, match="geomesa.fault.injection"):
        with resilience.inject_faults():
            pass
    j = MutationJournal(root)
    assert j.append({"kind": "noop", "schema": "t", "i": 0}) == 1
    with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults() as inj:
        inj.fail("journal.fsync", OSError("disk gone"), times=1)
        inj.fail("journal.append", where=lambda ctx: ctx.get("schema") == "u", times=None)
        with pytest.raises(journal.JournalError, match="disk gone"):
            j.append({"kind": "noop", "schema": "t", "i": 1})
        for _ in range(2):
            with pytest.raises(resilience.InjectedFault):
                j.append({"kind": "noop", "schema": "u"})
        assert j.append({"kind": "noop", "schema": "t", "i": 2}) == 3
        assert [site for site, _ in inj.fired] == ["journal.fsync", "journal.append",
                                                   "journal.append"]
    resilience.fault_point("journal.fsync")  # inert again
    j.close()
    assert len(j.status()["segments"]) == 2  # the failed commit rolled the segment
    # the unacked frame was written before its fsync failed: it replays as
    # a durable but unacked tail; every acked record is there
    got = [int(r["i"]) for r in MutationJournal(root).records()]
    assert got[0] == 0 and got[-1] == 2 and set(got) <= {0, 1, 2}


# -- torn tails and corruption -----------------------------------------------------------------
def test_torn_tail_truncates_cleanly(tmp_path):
    root = str(tmp_path)
    j = MutationJournal(root)
    for i in range(5):
        j.append({"kind": "noop", "schema": "t", "i": i})
    j.close()
    seg = _segs(root)[-1]
    size = os.path.getsize(seg)
    with open(seg, "r+b") as fh:  # the last frame went down partially
        fh.truncate(size - 7)
    j2 = MutationJournal(root)
    recs = j2.records()
    assert [int(r["i"]) for r in recs] == [0, 1, 2, 3]
    c = j2.counters()
    assert c["torn_tails"] == 1 and c["truncated_bytes"] > 0
    assert j2.status()["segments"][0]["torn_bytes"] == 0  # repaired on disk
    # the reference's reader agrees with the repaired file
    assert [int(r["i"]) for r in jjournal.MutationJournal(root).records()] == [0, 1, 2, 3]
    seq = j2.append({"kind": "noop", "schema": "t", "i": 99})
    assert seq == max(int(r["seq"]) for r in recs) + 1
    j2.close()


def test_corrupt_frame_crc_stops_replay_at_last_valid(tmp_path):
    root = str(tmp_path)
    j = MutationJournal(root)
    for i in range(3):
        j.append({"kind": "noop", "schema": "t", "i": i})
    j.close()
    seg = _segs(root)[-1]
    with open(seg, "r+b") as fh:  # flip a payload byte of the last frame
        fh.seek(-3, os.SEEK_END)
        b = fh.read(1)
        fh.seek(-3, os.SEEK_END)
        fh.write(bytes([b[0] ^ 0xFF]))
    status = MutationJournal(root, create=False)
    assert [int(r["i"]) for r in status.records()] == [0, 1]
    assert status.counters()["torn_tails"] == 1


# -- segments and checkpoints ------------------------------------------------------------------
def test_segment_roll_and_checkpoint_truncation(tmp_path):
    """A 64 KiB threshold rolls segments as records accumulate; a
    checkpoint deletes exactly the segments whose every record it covers,
    and what stays replays in order."""
    root = str(tmp_path)
    blob = np.arange(2500, dtype=np.float64)  # 20 kB a record
    with config.JOURNAL_SEGMENT_BYTES.scoped(1 << 16):
        j = MutationJournal(root)
        for i in range(12):
            sink = []
            j.append({"kind": "noop", "schema": "t", "i": i,
                      "v": journal.enc_value(blob + i, sink)}, blobs=sink)
    segs = j.status()["segments"]
    assert len(segs) >= 4 and all(s["bytes"] <= (1 << 16) + 20100 for s in segs)
    assert [s["seq_lo"] for s in segs] == sorted(s["seq_lo"] for s in segs)
    cut = segs[1]["seq_hi"] + 1  # inside the third segment
    freed = j.checkpoint(cut)
    left = j.status()["segments"]
    assert freed == sum(s["bytes"] for s in segs[:2]) and freed > 0
    assert [s["file"] for s in left] == [s["file"] for s in segs[2:]]
    recs = j.records()
    assert [int(r["i"]) for r in recs] == list(range(segs[2]["seq_lo"] - 1, 12))
    np.testing.assert_array_equal(journal.dec_value(recs[-1]["v"]), blob + 11)
    # appends go on after the checkpoint closed the active segment
    assert j.append({"kind": "noop", "schema": "t", "i": 12}) == 13
    assert j.checkpoint(13) > 0 and j.records() == []
    j.close()
    assert journal.journal_exists(root) is False
    assert MutationJournal(root).last_seq() == 0  # nothing durable remains


def test_journal_exists_and_closed(tmp_path):
    root = str(tmp_path)
    assert not journal.journal_exists(root)
    j = MutationJournal(root)
    assert not journal.journal_exists(root)  # a dir without segments
    j.append({"kind": "noop", "schema": None})
    assert journal.journal_exists(root) and jjournal.journal_exists(root)
    j.close()
    with pytest.raises(journal.JournalError):
        j.append({"kind": "noop", "schema": None})


def test_knob_defaults_match(tmp_path):
    j = MutationJournal(str(tmp_path))
    assert j.group_ms == float(jconfig.JOURNAL_GROUP_MS.get()) == 2.0
    assert j.segment_bytes == int(jconfig.JOURNAL_SEGMENT_BYTES.get()) == 8 << 20
    j.close()
