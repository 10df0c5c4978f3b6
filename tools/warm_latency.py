"""Warm latency of the port's main path, for comparing two trees on one card.

    python3 tools/warm_latency.py --root DIR [--label NAME] [--rows N] [--reps R]

Imports ``geomesa_tpu_torch`` from ``DIR`` (a checkout of any commit of the
port that has span tracing), ingests ``chip_smoke.py``'s slice-1 store
(``make_data``: uniform points over CONUS, one month of ``dtg``, seed 7,
8 shards) and times, each call ending synchronized:

* the main path's four calls (the bbox count, the plain and the weighted
  512x512 density, the polygon count): one cold call each, then ``R``
  rounds of the four in turn, and each call's warm p50;
* the bbox count untraced against traced (``geomesa.trace.enabled``), in
  turns (off, on, on, off), ``R`` calls each, before any profiler runs.

It prints the card's ``nvidia-smi`` name and power limit, then one JSON
line. To compare a parent and a change, run it in turns on one card, in
one job: parent, change, change, parent. It needs a CUDA device and
exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _smoke():
    """``chip_smoke.py`` beside this script's folder, loaded by path (its
    data generator and the main path's queries)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_data", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the tree whose geomesa_tpu_torch runs")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("warm_latency: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import geomesa_tpu_torch
    from geomesa_tpu_torch import GeoDataset, config
    from geomesa_tpu_torch.kernels import _build

    if not Path(geomesa_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"warm_latency: imported {geomesa_tpu_torch.__file__}, not {root}")
    cs = _smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build()

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    ds = GeoDataset(n_shards=8)
    ds.create_schema("gdelt", "weight:Float,dtg:Date,*geom:Point")
    ds.insert("gdelt", cs.make_data(args.rows, args.seed))
    ds.flush("gdelt")
    q_bbox = f"BBOX(geom, {', '.join(str(v) for v in cs.QUERY_BBOX)}) AND {cs.DURING}"
    q_poly = f"INTERSECTS(geom, {cs.polygon_wkt()}) AND {cs.DURING}"
    calls = {
        "count_bbox": lambda: ds.count("gdelt", q_bbox),
        "density": lambda: ds.density("gdelt", q_bbox, bbox=cs.QUERY_BBOX,
                                      width=cs.WIDTH, height=cs.HEIGHT),
        "density_weighted": lambda: ds.density("gdelt", q_bbox, bbox=cs.QUERY_BBOX,
                                               width=cs.WIDTH, height=cs.HEIGHT,
                                               weight="weight"),
        "count_polygon": lambda: ds.count("gdelt", q_poly),
    }
    cold = {k: timed(fn) for k, fn in calls.items()}
    warm = {k: [] for k in calls}
    for _ in range(args.reps):
        for k, fn in calls.items():
            warm[k].append(timed(fn))
    traced = {False: [], True: []}
    for _ in range(args.reps // 2):
        for on in (False, True, True, False):
            with config.TRACE_ENABLED.scoped("true" if on else "false"):
                traced[on].append(timed(calls["count_bbox"]))
    untraced_p50, traced_p50 = (float(np.median(traced[k])) for k in (False, True))
    print(json.dumps({
        "label": args.label or str(root), "card": smi, "rows": args.rows, "reps": args.reps,
        "cold_ms": cold,
        "warm_p50_ms": {k: float(np.median(v)) for k, v in warm.items()},
        "count_untraced_p50_ms": untraced_p50, "count_traced_p50_ms": traced_p50,
        "trace_overhead_pct": (traced_p50 / untraced_p50 - 1) * 100,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
