"""Crash consistency of the port's journal and checkpoints (ack = durable).

The reference's op script (``tests/test_crash.py``'s ``_CHILD``: create,
inserts, a save, an insert, a delete, a column add, an insert, a save)
runs through the port in a child process on the CPU:

* recorded, its ``journal.*`` / ``fs.*`` fault-point hits equal the JAX
  package's run of the same script, site for site and count for count;
* killed by SIGKILL at a recorded hit, the root recovers (``load``) to the
  state of a never-crashed run of some op prefix that covers every op the
  child acked: a durable but unacked tail is allowed, an acked op lost is
  the failure. The smoke cases (one kill inside a journal fsync, one
  inside the checkpoint's manifest publish) run here, each under its own
  time limit; the walk over every recorded hit is marked slow, as the
  reference's is;
* a script of the port's own on a time-partitioned schema, killed inside
  its second checkpoint (the manifest publish, and the journal truncation
  after it), recovers the same way: a partition rewritten by that
  checkpoint never overwrites the snapshot the published manifest names.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import GeoDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "name:String,weight:Double,dtg:Date,*geom:Point"

#: seconds each smoke test may take, child processes included
LIMIT_S = 150

#: the op script, shared by the child and the in-process controls; the
#: same ops, data and fids as the reference's ``_CHILD``
_OPS = r'''
def make_ops(ds, np, SPEC, root):
    def _data(n, seed, tag="op"):
        rng = np.random.default_rng(seed)
        return {
            "name": [f"{tag}{seed}_{i}" for i in range(n)],
            "weight": rng.uniform(0, 10, n),
            "dtg": rng.integers(1577836800000, 1583020800000, n).astype("datetime64[ms]"),
            "geom__x": rng.uniform(-120, -70, n),
            "geom__y": rng.uniform(25, 50, n),
        }

    return [
        lambda: ds.create_schema("t", SPEC),
        lambda: ds.insert("t", _data(8, 1), fids=[f"a{i}" for i in range(8)]),
        lambda: ds.insert("t", _data(8, 2), fids=[f"b{i}" for i in range(8)]),
        lambda: (ds.flush(), ds.save(root)),
        lambda: ds.insert("t", _data(8, 3), fids=[f"c{i}" for i in range(8)]),
        lambda: ds.delete_features("t", "weight > 9"),
        lambda: ds.update_schema("t", "extra:Integer"),
        lambda: ds.insert("t", dict(_data(8, 4), extra=np.arange(8, dtype=np.int64)),
                          fids=[f"d{i}" for i in range(8)]),
        lambda: (ds.flush(), ds.save(root)),
    ]


def make_part_ops(ds, np, SPEC, root):
    """A time-partitioned schema over two months (weekly partitions, at
    most 2 resident): two saves around an insert and a delete."""
    def _data(n, seed):
        rng = np.random.default_rng(seed)
        return {
            "name": [f"p{seed}_{i}" for i in range(n)],
            "weight": rng.uniform(0, 10, n),
            "dtg": rng.integers(1577836800000, 1583020800000, n).astype("datetime64[ms]"),
            "geom__x": rng.uniform(-120, -70, n),
            "geom__y": rng.uniform(25, 50, n),
        }

    def create():
        ds.create_schema("t", SPEC + ";geomesa.partition='time'")
        ds._store("t").max_resident = 2

    return [
        create,
        lambda: ds.insert("t", _data(64, 1), fids=[f"a{i}" for i in range(64)]),
        lambda: (ds.flush(), ds.save(root)),
        lambda: ds.insert("t", _data(8, 3), fids=[f"c{i}" for i in range(8)]),
        lambda: ds.delete_features("t", "weight > 9"),
        lambda: (ds.flush(), ds.save(root)),
    ]
'''

_CHILD = r'''
import json, os, signal, sys
args = json.loads(sys.argv[1])
sys.path.insert(0, args["repo"])
import numpy as np
import torch
torch.set_num_threads(1)
from geomesa_tpu_torch import GeoDataset, resilience

root, mode = args["root"], args["mode"]
kill_site, kill_hit = args["kill_site"], args["kill_hit"]
hits = {}
_real = resilience.fault_point

def hooked(site, **ctx):
    if site.startswith("journal.") or site.startswith("fs."):
        hits[site] = hits.get(site, 0) + 1
        if mode == "kill" and site == kill_site and hits[site] == kill_hit:
            os.kill(os.getpid(), signal.SIGKILL)
    return _real(site, **ctx)

resilience.fault_point = hooked
ack_fh = open(os.path.join(root, "acked.log"), "a")

def ack(i):
    ack_fh.write(f"{i}\n")
    ack_fh.flush()
    os.fsync(ack_fh.fileno())
''' + _OPS + r'''
ds = GeoDataset(device="cpu")
ds.attach_journal(root)
ops = (make_part_ops if args["ops"] == "part" else make_ops)(ds, np, args["spec"], root)
for i, op in enumerate(ops):
    op()
    ack(i)
if mode == "record":
    with open(os.path.join(root, "hits.json"), "w") as fh:
        json.dump(hits, fh)
print("DONE")
'''


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_child(root, mode, kill_site="", kill_hit=0, timeout=300, ops="flat"):
    args = dict(repo=REPO, root=root, mode=mode, kill_site=kill_site, kill_hit=kill_hit,
                spec=SPEC, ops=ops)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", _CHILD, json.dumps(args)], env=env,
                          capture_output=True, text=True, timeout=timeout)


def _state(ds):
    """Comparable state of schema "t" (None when absent): spec, count and
    the decoded names."""
    if "t" not in ds._stores:
        return None
    d = ds.query("t").to_dict()
    return {"spec": ds.get_schema("t").spec(), "count": int(ds.count("t")),
            "names": sorted("" if v is None else str(v) for v in d.get("name", []))}


def _loaded_state(root):
    try:
        return _state(GeoDataset.load(root, device="cpu"))
    except FileNotFoundError:
        return None


def _make_ops(ops, ds, root):
    ns = {}
    exec(_OPS, ns)
    return ns["make_part_ops" if ops == "part" else "make_ops"](ds, np, SPEC, root)


def _control(root, p, ops="flat"):
    """The state a never-crashed run of the first ``p`` ops leaves,
    recovered through ``load`` as the crashed roots are."""
    ds = GeoDataset(device="cpu")
    ds.attach_journal(root)
    for op in _make_ops(ops, ds, root)[:p]:
        op()
    return _loaded_state(root)


def _acked(root):
    try:
        with open(os.path.join(root, "acked.log")) as fh:
            return [int(x) for x in fh.read().split()]
    except FileNotFoundError:
        return []


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The port child's fault-point hits, recorded once."""
    root = str(tmp_path_factory.mktemp("record"))
    r = _run_child(root, "record", timeout=LIMIT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(root, "hits.json")) as fh:
        hits = json.load(fh)
    return hits, root


def _points(hits):
    return [(site, h) for site, n in sorted(hits.items()) for h in range(1, n + 1)]


def _walk(tmp_path, points, deadline, ops="flat"):
    controls = {}
    lost = []
    killed = 0
    n_ops = len(_make_ops(ops, None, ""))
    for k, (site, hit) in enumerate(points):
        root = str(tmp_path / f"kill{k}")
        os.makedirs(root)
        left = deadline - time.monotonic()
        assert left > 0, "time limit reached"
        r = _run_child(root, "kill", kill_site=site, kill_hit=hit, timeout=left, ops=ops)
        if r.returncode == 0:
            continue  # the walk raced past the point
        assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
        killed += 1
        n_acked = len(_acked(root))
        got = _loaded_state(root)
        ok = False
        for p in range(n_acked, n_ops + 1):
            if p not in controls:
                croot = str(tmp_path / f"control{p}")
                os.makedirs(croot)
                controls[p] = _control(croot, p, ops)
            if got == controls[p]:
                ok = True
                break
        if not ok:
            lost.append((site, hit, n_acked, got))
    assert not lost, f"acked mutations lost at kill points: {lost}"
    return killed


def test_fault_point_hits_equal_the_reference(recorded, tmp_path):
    """The same op script through the JAX package (``tests/test_crash.py``'s
    own child) records the same sites the same number of times."""
    hits, root = recorded
    spec = importlib.util.spec_from_file_location(
        "_reference_test_crash", os.path.join(REPO, "tests", "test_crash.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jroot = str(tmp_path / "jax")
    os.makedirs(jroot)
    r = ref._run_child(tmp_path, jroot, "record")
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(jroot, "hits.json")) as fh:
        want = json.load(fh)
    assert hits == want
    assert {"journal.append", "journal.fsync", "fs.save.chunk", "fs.save.manifest",
            "journal.checkpoint"} <= set(hits)
    # and the recorded run's root recovers to the full script's state
    assert _loaded_state(root) == _control(str(tmp_path / "control"), 9)


@pytest.mark.parametrize("site", ["journal.fsync", "fs.save.manifest"])
def test_kill_point_smoke(site, recorded, tmp_path):
    """One kill inside a journal fsync, one inside the checkpoint's
    manifest publish: the two windows where a naive design loses acked
    data. Each under its own time limit."""
    deadline = time.monotonic() + LIMIT_S
    points = [pt for pt in _points(recorded[0]) if pt[0] == site]
    assert points, recorded[0]
    _walk(tmp_path, [points[len(points) // 2]], deadline)
    assert time.monotonic() < deadline


@pytest.mark.slow
def test_kill_point_walk_full(recorded, tmp_path):
    """SIGKILL at every recorded ``journal.*`` / ``fs.*`` hit: no acked
    mutation lost."""
    _walk(tmp_path, _points(recorded[0]), time.monotonic() + 3600)


@pytest.mark.parametrize("site", ["fs.save.manifest", "journal.checkpoint"])
def test_kill_in_partitioned_checkpoint(site, tmp_path):
    """Killed in the second save of a time-partitioned schema, after it
    wrote the dirty partitions' snapshots (before the manifest publish, or
    after it and before the journal truncation): no acked mutation lost,
    none applied twice."""
    deadline = time.monotonic() + LIMIT_S
    assert _walk(tmp_path, [(site, 2)], deadline, ops="part") == 1
    assert time.monotonic() < deadline
