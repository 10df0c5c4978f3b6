"""Time and device memory of the density ladder's rungs on two stores, on the card.

The stores:

- ``flat``: slice 10's store of ``chip_smoke.py`` (2,000,000 ``make_data``
  points, seed 17, 8 shards) and its main density (``QUERY_BBOX``,
  ``DURING``, 512x512), whose grouped schedule declines over
  ``geomesa.density.pallas.max.dup``;
- ``partitioned``: the store of ``tests/test_torch_gpu.py``'s memory-bound
  test (1 Mi points over nine weekly partitions, two resident) and its nine
  whole-week scans, each called after ``spill_all`` as the test calls it.

For each store and ladder (``default``; ``scatter``, which is
``geomesa.density.mxu=false``: the scatter wherever the grouped rung
declines), one JSON line: the rungs the scans took, the cold and the warm
p50 wall time (CUDA-synchronized) of the unweighted and the weighted
density, and the peak device bytes above the call's baseline (cuBLAS's
workspace is allocated before, and reported apart); on the flat store the
einsum rung's schedule (pairs, compacted rows, slices). The ladders' grids are
checked equal (weighted within rtol 1e-4). ``--package-root`` imports
``geomesa_tpu_torch`` from another checkout; a commit without the knob runs
its own ladder only, as ``default``. To compare two commits in one call::

    git archive <parent> | tar -x -C _chip/parent
    python tools/density_rungs.py --package-root _chip/parent --label parent
    python tools/density_rungs.py --label change
"""

import argparse
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SPEC = "weight:Float,dtg:Date,*geom:Point"
WEEKS = "dtg DURING 2020-01-01T00:00:00Z/2020-02-26T00:00:00Z"
P_ROWS = 1 << 20
P_BBOX = (-100.0, 30.0, -80.0, 45.0)


def _flat(GeoDataset, cs):
    ds = GeoDataset(n_shards=8)
    ds.create_schema("gdelt10", SPEC)
    ds.insert("gdelt10", cs.make_data(2_000_000, 17))
    ds.flush("gdelt10")
    q = f"BBOX(geom, {', '.join(str(v) for v in cs.QUERY_BBOX)}) AND {cs.DURING}"
    return ds, "gdelt10", q, cs.QUERY_BBOX, None


def _partitioned(GeoDataset, parse_iso_ms, spill: Path):
    """The memory-bound test's store (``tests/test_torch_gpu.py::_partitioned``)."""
    rng = np.random.default_rng(17)
    lo = parse_iso_ms("2020-01-01")
    data = {
        "geom__x": rng.uniform(-120, -70, P_ROWS),
        "geom__y": rng.uniform(25, 50, P_ROWS),
        "dtg": rng.integers(lo, parse_iso_ms("2020-02-26"), P_ROWS).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, P_ROWS).astype(np.float32),
    }
    ds = GeoDataset(n_shards=4, compact_min_rows=1, compact_fraction=2.0)
    ds.create_schema("t", SPEC + ";geomesa.partition='time'")
    st = ds._store("t")
    st.max_resident = 2
    st._spill_dir = str(spill)
    ds.insert("t", data, fids=np.arange(P_ROWS).astype(str))
    ds.flush("t")
    return ds, "t", WEEKS, P_BBOX, st


def _rungs(ds, name, q):
    path = ds._plan(name, q).exec_path
    if "partitions" in path:
        return sorted({p.get("density_kernel") for p in path["partitions"].values()})
    return [path.get("density_kernel")]


def _schedule(ds, name, q, bbox):
    """The einsum rung's schedule on a flat store: pairs, the compacted
    rows' shape, the rows masked in and the slices it runs (None where the
    package has no einsum rung or the scan takes another)."""
    ex, plan = ds._executor(name), ds._plan(name, q)
    if not hasattr(ex, "_pair_schedule"):
        return None
    from geomesa_tpu_torch.kernels import density_mxu as kmxu

    cols_all = ["geom__x", "geom__y"]
    setup = ex._scan_setup(plan, cols_all)
    ex._maybe_compact(plan, setup)
    cols, m = ex._fused(plan, setup, cols_all)
    sched = ex._pair_schedule(plan, setup, bbox, 512, 512)
    if sched is None:
        return None
    x = cols["geom__x"]
    rows = max(kmxu._SLICE_MIN_ROWS, x.numel() // kmxu._SLICE_SHARE)
    step = max(1, min(sched["PB"], rows // x.shape[-1]))
    return {"n_pairs": sched["n_pairs"], "compact_shape": list(x.shape),
            "rows_masked_in": int(m.sum()), "pairs_per_slice": step,
            "slices": -(-sched["n_pairs"] // step), "TY": sched["TY"], "TX": sched["TX"]}


def _measure(torch, ds, name, q, bbox, st, reps):
    """{weight: (grid, cold s, warm p50 s, peak B, rungs)}."""
    out = {}
    for weight in (None, "weight"):
        def call():
            if st is not None:
                st.spill_all()
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            g = ds.density(name, q, bbox=bbox, width=512, height=512, weight=weight)
            torch.cuda.synchronize()
            return g, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

        grid, cold, peak = call()
        warm = []
        for _ in range(reps):
            _, s, p = call()
            warm.append(s)
            peak = max(peak, p)
        out[weight] = (grid, cold, statistics.median(warm), peak, _rungs(ds, name, q))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(REPO))
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("density_rungs: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import chip_smoke as cs
    from geomesa_tpu_torch import GeoDataset, config
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms

    dev = torch.device("cuda")
    ws0 = torch.cuda.memory_allocated()
    torch.mm(torch.ones(1, 1, device=dev), torch.ones(1, 1, device=dev))
    torch.cuda.synchronize()
    workspace = torch.cuda.memory_allocated() - ws0
    mxu = getattr(config, "DENSITY_MXU", None)
    ladders = {"default": None} if mxu is None else {"default": None, "scatter": "false"}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()
    spill = Path(tempfile.mkdtemp())
    for store in ("flat", "partitioned"):
        ds, name, q, bbox, st = (_flat(GeoDataset, cs) if store == "flat" else
                                 _partitioned(GeoDataset, parse_iso_ms, spill))
        res = {}
        for ladder, val in ladders.items():
            if val is None:
                res[ladder] = _measure(torch, ds, name, q, bbox, st, args.reps)
            else:
                with mxu.scoped(val):
                    res[ladder] = _measure(torch, ds, name, q, bbox, st, args.reps)
        ref = res["default"]
        for ladder, r in res.items():
            if not np.array_equal(r[None][0], ref[None][0]):
                raise AssertionError(f"{store}: the {ladder} ladder's grid differs")
            np.testing.assert_allclose(r["weight"][0], ref["weight"][0], rtol=1e-4, atol=1e-3)
            line = {"label": args.label, "store": store, "ladder": ladder,
                    "card": card, "cublas_workspace_B": workspace}
            for weight, key in ((None, "unweighted"), ("weight", "weighted")):
                _, cold, warm, peak, rungs = r[weight]
                line[key] = {"rungs": rungs, "cold_ms": cold * 1e3, "warm_p50_ms": warm * 1e3,
                             "peak_B": int(peak), "reps": args.reps}
            if store == "flat" and ladder == "default":
                line["einsum_schedule"] = _schedule(ds, name, q, bbox)
            print(json.dumps(line), flush=True)
        del ds, st
    return 0


if __name__ == "__main__":
    sys.exit(main())
