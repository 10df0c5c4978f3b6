#!/usr/bin/env python3
"""On-card smoke test of geomesa_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py [--rows N] [--seed S] [--reps R] [--part-rows N5]
                          [--poly-rows N6] [--line-rows L6]

1. Device: the card's name and power limit; builds the CUDA kernels from
   ``geomesa_tpu_torch/csrc`` with nvcc (in parallel) and prints the build
   time and the ``-Xptxas -v`` report.
2. Main path through ``GeoDataset``, at the bench's deployment: N (default
   20,000,000) GDELT-like points uniform over CONUS, one month of ``dtg``, a
   ``weight`` Float, made from a NumPy seed; 8 shards. ``count`` and
   512x512 ``density`` (unweighted and weighted) of a bbox + 10-day query,
   and ``count`` of a 64-edge polygon with a hole under the same interval.
   The kernels' launch counters are zeroed just before and read just after,
   and each must be > 0. Cold and warm p50 latencies, ingest time, peak
   device memory and each query's ``exec_path`` are printed, then a
   ``torch.profiler`` window over warm calls gives each query's device-busy
   time and idle share (traces under ``chiprun_out/chip_smoke/``).
3. Each kernel against its plain PyTorch version on the card, on the
   operands the main path gives it (PIP exact; density unweighted exact,
   weighted rtol 1e-4 / atol 1e-3), with CUDA-event timings (launches queued
   behind a sleeping stream, so host launch overhead is not counted) of the
   kernel and the plain version taken in turns (plain, kernel, kernel,
   plain), and
   (density) ``torch.bincount`` as the library yardstick, beside the least
   time the card could take. The bound counts the work this run's data
   needs (PIP: only the crossing tests whose edge y-span holds the point;
   density: the mask byte of every row, x, y and weight only of masked-in
   rows); the first kernels' counts are logged beside it.
4. The answers against NumPy oracles: bbox count exact (f64 predicate);
   unweighted grid exact and weighted grid within rtol 1e-4 against the
   reference's pixel mapping (f32 op by op, f64 for the f32-band rows the
   host corrects); polygon count exact against an f32 even-odd oracle over
   the same packed edge table.
5. Slice 3, on a second schema of the same ``GeoDataset``
   (``name:String:index=true,code:Long,weight:Float,dtg:Date,*geom:Point``):
   the same N points, ``dtg`` and ``weight``, ``name`` Zipf(1.1)-skewed over
   256 values (GDELT actor-code skew), ``code`` uniform in [0, 2^40), fids
   ``e<row>``. Queries without a time bound (z2 plans, full scan), a rare
   and a frequent name (attribute vs z2), a fid lookup (host), a Long bound
   beyond 2^24 (device coarse mask + host refinement), a name / weight /
   bbox / time conjunction (z3), LIKE + DWITHIN, and a polygon; 512x512
   densities of the bbox (unweighted and weighted) and of the conjunction
   (weighted). Each runs cold once and ``--reps`` times warm, with its
   index, ``exec_path``, answer and NumPy oracle (counts exact against an
   f64 predicate; DWITHIN between the f64 disk rows inside the reference's
   plan box and all f64 disk rows, each up to the rows within 10 m of the
   radius; grids as in 4), its profile, per-table ingest seconds and device bytes. The
   kernels' counters are zeroed before the phase and must both be > 0
   after; both kernels are held against their plain versions on the z2
   plans' operands.
6. Slice 4, on slice 3's schema (no new ingest): ``query`` of the bbox +
   time filter B, of a weight bound + time (no f32 band row, so the
   features come from the device mask) and of the polygon, sorted queries (weight descending
   with ``max_features`` 10 and 1000, name then weight, a sorted
   projection; weight descending with 10 and 1000 and per-name sampling
   again on the band-free filter, so the device top-k and sampling run),
   ``sampling=10`` overall and per name, ``stats`` of B and of the
   band-free filter (count, min / max, 64-bin histogram, enumeration,
   top-k, descriptive) and of the polygon, ``Frequency(name,256)`` (host path), and ``knn``
   (k 10, and k 100 under a name filter). Each runs cold once and warm
   (``--reps``, a quarter of it for the calls that return or sort over a
   million rows), with its ``exec_path``, rows, cold and warm p50, D2H
   bytes and device busy / idle share per warm call; the calls with host
   work over the matches also print a cProfile of one warm call. Each answer is held
   against a NumPy oracle: rows and columns of the f64 predicate (f32
   even-odd for the polygon) in table order; sorted results against a
   ``lexsort`` of the matches; samples against the 1-in-10 counter over
   the matches in table order, overall and per name; stats exact
   (descriptive within rtol 1e-5 of f64 sums); the count-min grid
   against a NumPy hash; kNN distance sets against the f64 brute force
   (rtol 1e-9; rows within 1e-6 of the k-th distance may trade places,
   and the boundary pairs are counted). The PIP counter is zeroed before
   the phase and must be > 0 after.
7. Slice 6, extent geometries, on two more schemas of the same
   ``GeoDataset``: N6 (default 1,100,000, about the count of NYC Open Data's
   "Building Footprints" layer) footprint polygons
   (``name:String,height:Float,dtg:Date,*geom:Polygon``: star-convex rings
   of 4-8 vertices, radius 5-30 m, centres uniform over NYC's box, one in
   50 a 2-part MultiPolygon, one in 50 with a hole; ``dtg`` uniform over a
   month, ``name`` Zipf over 256 values) and L6 (default 200,000) street
   polylines (``dtg:Date,*geom:LineString``, 3-6 vertices), both with the
   default indices xz3, xz2 and id, generated from the seed. Calls: an exact
   BBOX of a 0.06 x 0.05 degree viewport V over 10 days as count, ``query``
   (WKT out) and 512x512 density; the same under ``geomesa.loose.bbox`` as
   count and 256x256 density (the grouped kernel's rung); INTERSECTS and
   WITHIN of a 40-vertex borough-like polygon with a hole, CONTAINS of a
   point, DWITHIN 100 m of a 10-vertex line; ``height * 3 > 60`` and
   ``st_area(geom) > <about the median>`` with BBOX V; INTERSECTS and
   CROSSES of the streets against the borough; and on slice 3's points
   (no new ingest) ``INTERSECTS(polygon) AND weight * 2 > 1.2`` and the
   interval as count and density (the PIP kernel in the coarse mask, host
   refinement after). Each call runs cold once and warm (``--reps``, 3 for
   calls that refine more than 10k rows) and prints its index,
   ``exec_path`` (with the host refinement's rows and milliseconds), rows,
   cold and warm p50, and device busy / idle share; ``count_v`` prints a
   cProfile; per-table ingest seconds and device bytes follow. Oracles,
   independent of index, plan and coarse mask: an f64 envelope prefilter
   over every row, then the port's ``geofn`` predicate (held to the JAX
   package's on the CPU); loose BBOX the f32 envelope overlap; expressions
   f64 NumPy; grids from the oracle rows (host f64 pixels, or the device's
   f32 pixels for the loose grid); features the oracle's fids with WKT equal
   to the stored. The counters are zeroed before the phase; the grouped
   kernel must launch in the loose density and PIP in the points' call.
   Then both kernels are held against their plain versions on the phase's
   own operands (the loose density's xz chunks exact, the points'
   expression plan's rows exact) and timed in turns with them, beside the
   scatter rung on the same operands; and the loose density runs end to
   end on the scatter rung (``geomesa.density.pallas.max.dup`` 0, the
   reference's rung for xz) and the grouped rung in turns, with equal grids.
8. Slice 5, a time-partitioned store (``...;geomesa.partition='time'``) at
   BASELINE config #3's scale: N5 (default 100,000,000) points from the
   bench's generator (20M a month, so five months of ``dtg``; seed as
   above), ingested in the bench's 25M-row chunks with ``fids`` 0..N5-1;
   23 weekly partitions under the default budget of 4 resident, the rest
   spilled to ``chiprun_out/chip_smoke/spill`` (removed at the end). On B
   (the bbox + 10 days, 2 partitions): count, density, weighted density,
   the polygon count, weight descending with ``max_features`` 1000 (each
   partition's top-k candidates), stats and ``knn(-90, 40, 10)``; on the
   long window (the box over 2020-01-01/2020-06-01, every partition, spill
   reloads on each call): count and density. Each call prints partitions
   pruned and scanned, snapshot writes and reloads, the path each
   partition's scan took, cold (after ``spill_all()``) and warm p50, and a
   profile's device busy / idle share; the long window's warm calls run
   with the prefetch pipeline on and off in turns (answers equal to the
   cold call's), and kNN and the long count print a cProfile. Peak
   device memory over the long window is held to (budget + 1) x one
   partition's cold peak + the merge's grids, and spilling every partition
   must give the device memory back. Both kernels' counters are zeroed
   before the calls and must be > 0 after; both are timed against their
   plain versions at one partition's shapes. Answers against NumPy oracles
   as in 4 and 6 (the top 1000: the same weights and the same rows above
   the boundary weight).

Output: a ``{"kernels": [...]}`` JSON line, the card's ``nvidia-smi``
name/power-limit line, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero. Without a visible CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

QUERY_BBOX = (-100.0, 30.0, -80.0, 45.0)
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-15T00:00:00Z"
WIDTH = HEIGHT = 512

#: published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def polygon_wkt() -> str:
    """64 edges: a 48-vertex wavy shell and a 16-vertex hole, inside the
    query bbox."""
    def ring(n, cx, cy, rx, ry, wave):
        pts = []
        for k in range(n):
            a = 2 * math.pi * k / n
            r = 1 + wave * math.sin(5 * a)
            pts.append((round(cx + rx * r * math.cos(a), 4),
                        round(cy + ry * r * math.sin(a), 4)))
        pts.append(pts[0])
        return "(" + ", ".join(f"{x} {y}" for x, y in pts) + ")"

    return ("POLYGON(" + ring(48, -90.0, 37.5, 8.0, 6.0, 0.15) + ", "
            + ring(16, -90.0, 37.5, 3.0, 2.5, 0.0) + ")")


def log(*a):
    print(*a, flush=True)


def in_turns(torch, kernel, plain, reps: int, plain_reps: int):
    """(kernel ms, plain ms, the four timings): plain, kernel, kernel,
    plain on one card, each a :func:`cuda_ms` mean; the kernel's and the
    plain version's two means are averaged."""
    t = [cuda_ms(torch, plain, plain_reps), cuda_ms(torch, kernel, reps),
         cuda_ms(torch, kernel, reps), cuda_ms(torch, plain, plain_reps)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


#: GPU clock cycles the stream sleeps before a timed run (a few ms): the
#: host queues the launches meanwhile, so the events time the card's work
#: and not the host's launch overhead
_QUEUE_CYCLES = 10_000_000


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` launches,
    after one warm-up, by CUDA events recorded around launches queued
    behind a sleeping stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(torch, fn):
    """(result, host seconds) of one call that ends synchronized."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_warm(torch, fn, reps: int, trace_path: Path, warmup: bool = True):
    """Profile ``reps`` warm calls (after one more unless ``warmup`` is
    False): (wall ms per call, device-busy ms per call or None when the
    trace holds no device activity, top device kernels by total time,
    device-to-host bytes per call or None when the trace records no copy
    sizes). Busy time is the union of the kernel, memcpy and memset
    intervals of the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    d2h = [e.get("args", {}).get("bytes") for e in dev
           if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]]
    d2h = sum(d2h) / reps if d2h and None not in d2h else None
    if not dev:
        return wall / reps * 1e3, None, [], d2h
    busy, end = 0.0, -math.inf
    for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in dev):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    totals = {}
    for ev in dev:
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"]
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:3]
    return (wall / reps * 1e3, busy / reps / 1e3,
            [(name[:60], dur / reps / 1e3) for name, dur in top], d2h)


def host_profile(torch, fn, top: int = 6):
    """One warm call under cProfile: its ``top`` functions by own time, as
    (name (file:line), ms). Time inside NumPy and torch calls counts as
    the calling built-in's own."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [(f"{f[2]} ({Path(f[0]).name}:{f[1]})", round(v[2] * 1e3, 3)) for f, v in rows]


def pip_work(kpip, py, packed, n_edges):
    """(bytes, f32 operations, crossing tests) the PIP kernel needs on these
    points: x and y read, the verdict written, the edge table read once,
    and 6 operations for each crossing test whose edge y-span holds the
    point (the kernel's culling skips the rest exactly)."""
    spans = kpip.span_pairs(py.cpu().numpy(), packed, n_edges)
    return 9 * py.numel() + packed.nbytes, 6 * spans, spans


def density_work(o, width: int = None, height: int = None):
    """(bytes, f32 operations, masked-in rows) the density kernel needs on
    its operands ``o``: every scheduled row's mask byte, x and y only where
    the mask is true, the schedule once, and the grid (default 512x512)
    written."""
    rows = o["x"].numel()
    live = int(o["mask"].sum())
    sched_bytes = sum(o["sched"][k].nbytes for k in ("chunks", "seg_tile", "seg_begin", "seg_end"))
    cells = (width or WIDTH) * (height or HEIGHT)
    return rows + 8 * live + sched_bytes + 4 * cells, 8 * live, live


def bound(nbytes: int, nops: int):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = nops / PEAK_F32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def make_data(n: int, seed: int):
    """The bench's generator (bench.py:1086-1105): uniform over CONUS at
    20M points a month of ``dtg`` (never less than one month)."""
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms

    rng = np.random.default_rng(seed)
    lo = parse_iso_ms("2020-01-01")
    span = int((parse_iso_ms("2020-02-01") - lo) * max(n / 20_000_000, 1.0))
    return {
        "geom__x": rng.uniform(-125, -66, n),
        "geom__y": rng.uniform(24, 49, n),
        "dtg": rng.integers(lo, lo + span, n).astype("datetime64[ms]"),
        "weight": rng.uniform(0, 1, n).astype(np.float32),
    }


def time_mask(data, lo="2020-01-05T00:00:00", hi="2020-01-15T00:00:00"):
    """Rows whose ``dtg`` lies in [lo, hi] (DURING's closed interval)."""
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms

    t = data["dtg"].astype(np.int64)
    return (t >= parse_iso_ms(lo)) & (t <= parse_iso_ms(hi))


def density_oracles(data, tm):
    """(unweighted, weighted) f64 grids of the bbox rows that the row mask
    ``tm`` keeps, with the reference's semantics:
    exact f64 membership; pixel cells computed in f32 op by op, except for
    rows colliding with an f32 bound (the band), which the host corrects
    from f64 values."""
    x, y = data["geom__x"], data["geom__y"]
    xmin, ymin, xmax, ymax = QUERY_BBOX
    m = tm & (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    x, y, w = x[m], y[m], data["weight"][m]
    f = np.float32
    x32, y32 = x.astype(f), y.astype(f)
    band = np.isin(x32, [f(xmin), f(xmax)]) | np.isin(y32, [f(ymin), f(ymax)])
    px = ((x32 - f(xmin)) / f(xmax - xmin) * f(WIDTH)).astype(np.int32)
    py = ((y32 - f(ymin)) / f(ymax - ymin) * f(HEIGHT)).astype(np.int32)
    px = np.where(band, ((x - xmin) / (xmax - xmin) * WIDTH).astype(np.int32), px)
    py = np.where(band, ((y - ymin) / (ymax - ymin) * HEIGHT).astype(np.int32), py)
    idx = np.clip(py, 0, HEIGHT - 1) * WIDTH + np.clip(px, 0, WIDTH - 1)
    g = np.bincount(idx, minlength=WIDTH * HEIGHT).astype(np.float64)
    gw = np.bincount(idx, weights=w.astype(np.float64), minlength=WIDTH * HEIGHT)
    # the f64-pixel oracle (tests/test_density_pallas.py) for the record
    px64 = np.clip(((x - xmin) / (xmax - xmin) * WIDTH).astype(np.int64), 0, WIDTH - 1)
    py64 = np.clip(((y - ymin) / (ymax - ymin) * HEIGHT).astype(np.int64), 0, HEIGHT - 1)
    g64 = np.bincount(py64 * WIDTH + px64, minlength=WIDTH * HEIGHT)
    return (g.reshape(HEIGHT, WIDTH), gw.reshape(HEIGHT, WIDTH),
            g64.reshape(HEIGHT, WIDTH), int(m.sum()))


def polygon_rows(data, tm, packed, n_edges) -> np.ndarray:
    """f32 even-odd membership over the packed edge table, NumPy (no FMA):
    the rows of ``tm`` inside."""
    x1, y1, y2, slope = (packed[i, :n_edges] for i in range(4))
    x32 = data["geom__x"].astype(np.float32)
    y32 = data["geom__y"].astype(np.float32)
    # rows far outside the polygon's bounds have even parity: skip them
    pad = np.float32(1e-3)
    cand = np.flatnonzero(tm & (x32 >= x1.min() - pad) & (x32 <= x1.max() + pad)
                          & (y32 >= y1.min() - pad) & (y32 <= y1.max() + pad))
    inside = np.zeros(len(tm), bool)
    for lo in range(0, len(cand), 1 << 18):
        rows = cand[lo:lo + (1 << 18)]
        xb, yb = x32[rows, None], y32[rows, None]
        cond = (y1 > yb) != (y2 > yb)
        xint = x1 + (yb - y1) * slope
        inside[rows] = (cond & (xb < xint)).sum(axis=1) % 2 == 1
    return inside


def polygon_oracle(data, tm, packed, n_edges) -> int:
    """f32 even-odd count over the packed edge table."""
    return int(polygon_rows(data, tm, packed, n_edges).sum())


SPEC3 = "name:String:index=true,code:Long,weight:Float,dtg:Date,*geom:Point"
BOX = "BBOX(geom, -100.0, 30.0, -80.0, 45.0)"
RARE, FREQUENT, NAME_SET = "c007", "c000", ("c003", "c010", "c042")
DWITHIN_KM = 500.0


def make_data3(n: int, seed: int):
    """Slice 3's extra columns: Zipf(1.1) names over 256 values, Long
    codes in [0, 2^40) and the fids ``e<row>`` (bytes)."""
    rng = np.random.default_rng(seed + 1)
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    names = np.array([f"c{i:03d}" for i in range(256)])[
        rng.choice(256, n, p=zipf / zipf.sum())]
    return {"name": names, "code": rng.integers(0, 1 << 40, n)}, \
        np.char.add(b"e", np.arange(n).astype("S8"))


def haversine_m(x, y, px, py):
    """Great-circle metres, f64."""
    rx1, ry1, rx2, ry2 = (np.radians(np.asarray(v, np.float64)) for v in (x, y, px, py))
    a = (np.sin((ry2 - ry1) / 2) ** 2
         + np.cos(ry1) * np.cos(ry2) * np.sin((rx2 - rx1) / 2) ** 2)
    return 2 * 6_371_008.8 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def slice3(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped):
    """The slice-3 phase (see the module docstring, 5). Returns the
    launches of both kernels in the phase, and the schema's extra columns
    and fids."""
    n = len(data["dtg"])
    extra, fids = make_data3(n, args.seed)
    data3 = {**data, **extra}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds.create_schema("gdelt3", SPEC3)
    ds.insert("gdelt3", data3, fids=fids)
    encode_s = time.perf_counter() - t0
    ds.flush("gdelt3")
    st = ds._store("gdelt3")
    log(f"[slice3] ingest {n} rows: encode {encode_s:.3f} s, flush "
        f"{sum(st.flush_seconds.values()):.3f} s by stage "
        f"{ {k: round(v, 3) for k, v in st.flush_seconds.items()} }; tables {list(st.tables)}")

    queries = {
        "bbox": BOX,
        "include": "INCLUDE",
        "rare_name": f"name = '{RARE}' AND {BOX}",
        "frequent_name": f"name = '{FREQUENT}' AND {BOX}",
        "fids": "IN ('e17', 'e4242')",
        "long_code": f"code > 500000000000 AND {BOX} AND {DURING}",
        "names_weights": (f"name IN ({', '.join(repr(v) for v in NAME_SET)}) AND "
                          f"weight BETWEEN 0.25 AND 0.75 AND {BOX} AND {DURING}"),
        "like_dwithin": (f"name LIKE 'c01%' AND DWITHIN(geom, POINT(-90 40), "
                         f"{DWITHIN_KM}, kilometers)"),
        "polygon": f"INTERSECTS(geom, {wkt})",
    }
    calls = {k: (lambda q=q: ds.count("gdelt3", q)) for k, q in queries.items()}
    for key, q, w in (("bbox_density", queries["bbox"], None),
                      ("bbox_density_weighted", queries["bbox"], "weight"),
                      ("names_weights_density_weighted", queries["names_weights"], "weight")):
        calls[key] = (lambda q=q, w=w: ds.density(
            "gdelt3", q, bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT, weight=w))
    query_of = {k: queries[k.split("_density")[0]] for k in calls}

    kpip.launches = 0
    kgrouped.launches = 0
    results, latency, paths, index = {}, {}, {}, {}
    for key, fn in calls.items():
        results[key], cold = timed(torch, fn)
        warm = [timed(torch, fn)[1] for _ in range(args.reps)]
        latency[key] = (cold * 1e3, float(np.median(warm)) * 1e3)
        plan = ds._plan("gdelt3", query_of[key])
        paths[key] = dict(plan.__dict__.get("exec_path", {}))
        index[key] = plan.index_name
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    peak = torch.cuda.max_memory_allocated()
    for key in calls:
        ans = results[key]
        shown = ans if isinstance(ans, int) else f"grid sum {float(ans.sum())}"
        log(f"[slice3] {key}: index {index[key]}, exec_path {paths[key]}, answer {shown}, "
            f"cold {latency[key][0]:.3f} ms, warm p50 {latency[key][1]:.3f} ms")
    log(f"[slice3] launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in slice 3's phase: {launches}")
    for key in ("bbox", "polygon", "bbox_density"):
        if index[key] != "z2":
            raise AssertionError(f"{key} took the {index[key]} index, not z2")
    dev_bytes = {name: sum(t.nbytes for t in tbl._device_cache.values())
                 for name, tbl in st.tables.items()}
    ex = ds._executor("gdelt3")
    gathered = sum(t.nbytes for t in ex._gathered.values())
    log(f"[slice3] peak device memory {peak} B; [S, L] column bytes by table "
        f"{dev_bytes}; gathered [C, B] slabs {gathered} B; columns by table "
        f"{ {k: sorted(t._device_cache) for k, t in st.tables.items()} }")
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    for key, fn in calls.items():
        wall, busy, top, _ = profile_warm(torch, fn, args.reps,
                                          out_dir / f"slice3_{key}.json")
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        log(f"[profile] slice3 {key}: wall {wall:.4f} ms/call, device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms/call'}, "
            f"idle share {share}, top device work (ms/call) {top}")

    # both kernels against their plain versions on the z2 plans' operands
    bbox_plan = ds._plan("gdelt3", queries["bbox"])
    for w in (None, "weight"):
        o = ex.density_inputs(bbox_plan, QUERY_BBOX, WIDTH, HEIGHT, w)
        if o is None:
            raise AssertionError("the z2 bbox plan did not take the grouped rung")
        a = (o["x"], o["y"], o["mask"], o["weight"], QUERY_BBOX, WIDTH, HEIGHT, o["sched"])
        g_k, g_p = kgrouped.density_grouped(*a), kgrouped.density_grouped_plain(*a)
        torch.cuda.synchronize()
        ok = torch.equal(g_k, g_p) if w is None else torch.allclose(
            g_k, g_p, rtol=1e-4, atol=1e-3)
        log(f"[slice3] density_grouped ({w or 'unweighted'}) on the z2 plan's "
            f"{tuple(o['x'].shape)} rows, {o['sched']['chunks'].numel()} pairs: "
            f"max abs err {float((g_k - g_p).abs().max())}")
        if not ok:
            raise AssertionError("density kernel disagrees with its plain version on z2")
    cols = ex.scan_columns(ds._plan("gdelt3", queries["polygon"]), ["geom__x", "geom__y"])
    edges = torch.from_numpy(packed).cuda()
    px, py = cols["geom__x"], cols["geom__y"]
    bad = int((kpip.pip_mask(px, py, edges, n_edges)
               != kpip.pip_mask_plain(px, py, edges, n_edges)).sum())
    log(f"[slice3] pip on the z2 plan's {tuple(px.shape)} points: {bad} mismatches")
    if bad:
        raise AssertionError("pip kernel disagrees with its plain version on z2")

    # the answers against NumPy oracles
    x, y = data["geom__x"], data["geom__y"]
    names, code, w = extra["name"], extra["code"], data["weight"]
    tm = time_mask(data)
    box = (x >= -100) & (x <= -80) & (y >= 30) & (y <= 45)
    in_set = np.isin(names, NAME_SET) & (w >= 0.25) & (w <= 0.75) & tm
    like = np.char.startswith(names, "c01")
    d64 = haversine_m(x, y, -90.0, 40.0)
    # the reference's key plan scans the box it widens the point by
    # (distance over 111,319.49 m a degree, longitude by the centre's
    # cosine); that box is smaller than the great-circle disk, so disk rows
    # outside it may go unscanned, in the port as in the reference
    d_deg = DWITHIN_KM * 1000 / 111_319.49079327358
    dx = d_deg / math.cos(math.radians(40.0))
    plan_box = (np.abs(x + 90.0) <= dx) & (np.abs(y - 40.0) <= d_deg)
    disk = like & (d64 <= DWITHIN_KM * 1000)
    want = {
        "bbox": int(box.sum()),
        "include": n,
        "rare_name": int(((names == RARE) & box).sum()),
        "frequent_name": int(((names == FREQUENT) & box).sum()),
        "fids": int(np.isin(fids, [b"e17", b"e4242"]).sum()),
        "long_code": int(((code > 500000000000) & box & tm).sum()),
        "names_weights": int((in_set & box).sum()),
        "like_dwithin": int(disk.sum()),
        "polygon": polygon_oracle(data, np.ones(n, bool), packed, n_edges),
    }
    near = int((like & (np.abs(d64 - DWITHIN_KM * 1000) < 10.0)).sum())
    for key, v in want.items():
        got = results[key]
        if key == "like_dwithin":
            lo = int((disk & plan_box).sum())
            if not lo - near <= got <= v + near:
                raise AssertionError(f"{key}: {got} outside [{lo}, {v}] (f64 disk "
                                     f"rows in the plan box, all f64 disk rows) by "
                                     f"more than the {near} rows within 10 m of the radius")
            log(f"[check] slice3 {key}: {got}; f64 disk rows {v}, of them {v - lo} "
                f"outside the reference's plan box; {near} rows within 10 m of "
                "the radius")
        elif got != v:
            raise AssertionError(f"{key}: {got} != oracle {v}")
    for key, keep in (("bbox_density", np.ones(n, bool)),
                      ("names_weights_density_weighted", in_set)):
        g_u, g_w, _, cnt = density_oracles(data, keep)
        grids = ([(results[key], g_u, "unweighted")] if key == "bbox_density" else []) \
            + [(results["bbox_density_weighted" if key == "bbox_density" else key],
                g_w, "weighted")]
        for grid, oracle, kind in grids:
            if grid.shape != (HEIGHT, WIDTH) or not np.isfinite(grid).all():
                raise AssertionError(f"{key} {kind}: wrong shape or non-finite cells")
            if kind == "unweighted" and not np.array_equal(grid.astype(np.float64), oracle):
                raise AssertionError(f"{key}: unweighted grid differs from the oracle")
            if kind == "weighted" and not np.allclose(grid, oracle, rtol=1e-4, atol=1e-3):
                raise AssertionError(f"{key}: weighted grid outside rtol 1e-4")
    log(f"[check] slice3: every count exact against its f64 oracle (DWITHIN as "
        f"above), grids match (unweighted exact, weighted within rtol 1e-4)")
    return launches, extra, fids


STATS_SPEC = ("Count();MinMax(weight);Histogram(weight,64,0,1);Enumeration(name);"
              "TopK(name,10);DescriptiveStats(weight)")
KNN_NAME = "c007"


def count_min_grid(codes: np.ndarray, width: int) -> np.ndarray:
    """The count-min grid of int codes: 4 multiplicative hashes (the
    reference's constants), bucket ``(a * x mod 2^64) >> 33 mod width``."""
    a = np.array([0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                  0x27D4EB2F165667C5], dtype=np.uint64)
    x = codes.astype(np.int64).view(np.uint64)
    b = ((a[:, None] * x[None, :]) >> np.uint64(33)) % np.uint64(width)
    return np.stack([np.bincount(r.astype(np.int64), minlength=width) for r in b])


def knn_check(got_xy, x, y, keep, qx, qy, k):
    """Distance set of the answer against the f64 brute force over the
    rows ``keep`` selects: rtol 1e-9, except rows within 1e-6 (relative)
    of the k-th distance, which may trade places. Returns (k-th metres,
    boundary pairs, rows within 1e-6 of the k-th)."""
    d_all = haversine_m(x[keep], y[keep], qx, qy)
    want = np.sort(d_all)[:k]
    got = np.sort(haversine_m(got_xy[0], got_xy[1], qx, qy))
    if len(got) != len(want):
        raise AssertionError(f"knn returned {len(got)} rows, want {len(want)}")
    off = ~np.isclose(got, want, rtol=1e-9)
    kth = want[-1]
    if not (np.allclose(got[off], kth, rtol=1e-6) and np.allclose(want[off], kth, rtol=1e-6)):
        raise AssertionError("knn distance set differs from the f64 brute force")
    return float(kth), int(off.sum()), int(np.isclose(d_all, kth, rtol=1e-6).sum())


def slice4(args, torch, ds, data, extra, fids, wkt, packed, n_edges, kpip):
    """The slice-4 phase (see the module docstring, 6)."""
    from geomesa_tpu_torch.api.dataset import Query

    n = len(data["dtg"])
    q_b = f"{BOX} AND {DURING}"
    q_poly = f"INTERSECTS(geom, {wkt})"
    #: band-free (a Float bound and the interval): its calls stay on the device
    q_wt = f"weight < 0.1 AND {DURING}"
    queries = {
        "query_bbox": q_b,
        "query_weight_time": q_wt,
        "query_polygon": q_poly,
        "sort_weight_desc_10": Query(q_b, sort_by=[("weight", True)], max_features=10),
        "sort_weight_desc_1000": Query(q_b, sort_by=[("weight", True)], max_features=1000),
        "sort_name_weight_100": Query(q_b, sort_by=[("name", False), ("weight", True)],
                                      max_features=100),
        "projection_sorted_1000": Query(q_b, properties=["name", "weight"],
                                        sort_by=[("weight", False)], max_features=1000),
        "sample_10": Query(q_b, sampling=10),
        "sample_10_by_name": Query(q_b, sampling=10, sample_by="name"),
        # band-free: the device top-k routes and the device sampling counter
        "wt_sort_desc_10": Query(q_wt, sort_by=[("weight", True)], max_features=10),
        "wt_sort_desc_1000": Query(q_wt, sort_by=[("weight", True)], max_features=1000),
        "wt_sample_10_by_name": Query(q_wt, sampling=10, sample_by="name"),
    }
    calls = {k: (lambda q=q: ds.query("gdelt3", q)) for k, q in queries.items()}
    calls["stats_bbox"] = lambda: ds.stats("gdelt3", STATS_SPEC, q_b)
    calls["wt_stats"] = lambda: ds.stats("gdelt3", STATS_SPEC, q_wt)
    calls["stats_polygon"] = lambda: ds.stats("gdelt3", "Count();MinMax(weight)", q_poly)
    calls["frequency_name"] = lambda: ds.stats("gdelt3", "Frequency(name,256)", q_b)
    calls["knn_10"] = lambda: ds.knn("gdelt3", -90.0, 40.0, 10)
    calls["knn_100_name"] = lambda: ds.knn("gdelt3", -90.0, 40.0, 100, f"name = '{KNN_NAME}'")
    query_of = {**queries, "stats_bbox": q_b, "wt_stats": q_wt, "stats_polygon": q_poly,
                "frequency_name": q_b}
    #: calls that gather or sort over a million rows run a quarter of the reps
    heavy = {"query_bbox", "query_weight_time", "query_polygon", "sort_name_weight_100",
             "frequency_name"}

    # the kNN plans are the search's own: record their paths as they run
    ex = ds._executor("gdelt3")
    knn_paths = []
    real_knn = ex.knn

    def traced_knn(plan, *a, **kw):
        out = real_knn(plan, *a, **kw)
        knn_paths.append(dict(plan.exec_path))
        return out

    ex.knn = traced_knn
    t_phase = time.perf_counter()
    kpip.launches = 0
    results, latency, paths = {}, {}, {}
    for key, fn in calls.items():
        reps = max(3, args.reps // 4) if key in heavy else args.reps
        knn_paths.clear()
        results[key], cold = timed(torch, fn)
        warm = [timed(torch, fn)[1] for _ in range(reps)]
        latency[key] = (cold * 1e3, float(np.median(warm)) * 1e3, reps)
        paths[key] = (dict(ds._plan("gdelt3", query_of[key]).exec_path) if key in query_of
                      else {"attempts": len(knn_paths) // (reps + 1),
                            "last": knn_paths[-1]})
    launches = kpip.launches
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    for key, fn in calls.items():
        ans = results[key]
        rows = len(ans) if hasattr(ans, "columns") else (
            ans.stats[0].count if hasattr(ans, "stats") else int(ans.counts[0].sum()))
        cold, warm, reps = latency[key]
        wall, busy, _, d2h = profile_warm(torch, fn, reps, out_dir / f"slice4_{key}.json")
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        log(f"[slice4] {key}: exec_path {paths[key]}, rows {rows}, cold {cold:.3f} ms, "
            f"warm p50 {warm:.3f} ms ({reps} reps), D2H "
            f"{'not measured' if d2h is None else f'{d2h:.0f} B'}/call, device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms'}/call, idle share "
            f"{share} (profiled wall {wall:.3f} ms/call)")
        if key in heavy or key.startswith(("sort", "sample", "stats_bbox", "wt_")):
            log(f"[slice4] {key} host profile, top own times (ms): "
                f"{host_profile(torch, fn)}")
    ex.knn = real_knn
    log(f"[slice4] pip launches {launches}; the phase's calls, profiles included, "
        f"took {time.perf_counter() - t_phase:.3f} s")
    if launches <= 0:
        raise AssertionError("the pip kernel never launched in slice 4's phase")

    # -- the answers against NumPy oracles --------------------------------------
    st = ds._store("gdelt3")
    x, y, w = data["geom__x"], data["geom__y"], data["weight"]
    names, code = extra["name"], extra["code"]
    tm = time_mask(data)
    m_b = (x >= -100) & (x <= -80) & (y >= 30) & (y <= 45) & tm
    m_poly = polygon_rows(data, np.ones(n, bool), packed, n_edges)
    vocab = np.array(st.dicts["name"].values)
    fid_row = {}

    def rows_of(fc):
        col = fc.columns["__fid__"]
        key = id(col)
        if key not in fid_row:
            fid_row[key] = np.char.lstrip(col, b"e").astype(np.int64)
        return fid_row[key]

    def table_pos(index):
        order = st.tables[index].order
        pos = np.empty(len(order), np.int64)
        pos[order] = np.arange(len(order))
        return pos

    def check_rows(key, fc, want_rows, cols=("weight", "geom__x", "geom__y", "name", "code",
                                             "dtg")):
        got = rows_of(fc)
        if not np.array_equal(got, want_rows):
            raise AssertionError(f"{key}: rows differ from the oracle ({len(got)} vs "
                                 f"{len(want_rows)})")
        ref = {"weight": w, "geom__x": x, "geom__y": y, "code": code,
               "dtg": data["dtg"].astype(np.int64)}
        for c in cols:
            if c not in fc.columns:
                continue
            v = vocab[fc.columns[c]] if c == "name" else fc.columns[c]
            want = names[want_rows] if c == "name" else ref[c][want_rows]
            if not np.array_equal(v, want):
                raise AssertionError(f"{key}: column {c} differs from the oracle")

    pos_b = table_pos(ds._plan("gdelt3", q_b).index_name)
    rows_b = np.flatnonzero(m_b)
    rows_b = rows_b[np.argsort(pos_b[rows_b])]  # table order
    check_rows("query_bbox", results["query_bbox"], rows_b)
    pos_wt = table_pos(ds._plan("gdelt3", q_wt).index_name)
    rows_wt = np.flatnonzero((w < np.float32(0.1)) & tm)
    check_rows("query_weight_time", results["query_weight_time"],
               rows_wt[np.argsort(pos_wt[rows_wt])])
    pos_p = table_pos(ds._plan("gdelt3", q_poly).index_name)
    rows_p = np.flatnonzero(m_poly)
    check_rows("query_polygon", results["query_polygon"], rows_p[np.argsort(pos_p[rows_p])])
    mb = np.flatnonzero(m_b)
    pb = pos_b[mb]
    pw = pos_wt[rows_wt]
    want_sorted = {
        "sort_weight_desc_10": mb[np.lexsort((pb, -w[mb]))][:10],
        "sort_weight_desc_1000": mb[np.lexsort((pb, -w[mb]))][:1000],
        "sort_name_weight_100": mb[np.lexsort((pb, -w[mb], names[mb]))][:100],
        "projection_sorted_1000": mb[np.lexsort((pb, w[mb]))][:1000],
        "wt_sort_desc_10": rows_wt[np.lexsort((pw, -w[rows_wt]))][:10],
        "wt_sort_desc_1000": rows_wt[np.lexsort((pw, -w[rows_wt]))][:1000],
    }
    #: (exec_path sort, exec_path scan) each sorted call must take: a band
    #: row in B sends its top-k to the host twin, as in the reference
    b_scan = "host+device-coarse" if paths["query_bbox"]["band_rows"] else "device-padded"
    device_sort = {"sort_weight_desc_10": ("device-topk(k=10)", b_scan),
                   "sort_weight_desc_1000": ("device-topk(k=1000)", b_scan),
                   "sort_name_weight_100": (None, None),
                   "projection_sorted_1000": ("device-topk(k=1000)", b_scan),
                   "wt_sort_desc_10": ("device-topk(k=10)", "device-padded"),
                   "wt_sort_desc_1000": ("device-topk(k=1000)", "device-padded")}
    for key, want_rows in want_sorted.items():
        check_rows(key, results[key], want_rows)
        got_path = (paths[key].get("sort"), paths[key].get("scan"))
        if got_path != device_sort[key]:
            raise AssertionError(f"{key}: sort / scan path {got_path}, want {device_sort[key]}")
    if sorted(results["projection_sorted_1000"].columns) != ["__fid__", "name", "weight"]:
        raise AssertionError("the projection kept other columns")
    check_rows("sample_10", results["sample_10"], rows_b[::10])
    for key, rows_in_order in (("sample_10_by_name", rows_b),
                               ("wt_sample_10_by_name", rows_wt[np.argsort(pw)])):
        keys = names[rows_in_order]
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        start = np.maximum.accumulate(np.where(
            np.concatenate(([True], ks[1:] != ks[:-1])), np.arange(len(ks)), 0))
        keep = np.zeros(len(ks), bool)
        keep[order] = (np.arange(len(ks)) - start) % 10 == 0
        check_rows(key, results[key], rows_in_order[keep])
        got_k, got_c = np.unique(names[rows_of(results[key])], return_counts=True)
        all_k, all_c = np.unique(keys, return_counts=True)
        if not (np.array_equal(got_k, all_k) and np.array_equal(got_c, -(-all_c // 10))):
            raise AssertionError(f"{key}: a key's count is not ceil(matches / 10)")
    if paths["wt_sample_10_by_name"].get("feature_scan") != "device-compact":
        raise AssertionError("wt_sample_10_by_name did not sample in the device mask")

    for key, m in (("stats_bbox", m_b), ("wt_stats", (w < np.float32(0.1)) & tm)):
        leaves = results[key].stats
        wb = w[m]
        hist = np.bincount(np.clip(np.floor(wb * np.float32(64)), 0, 63).astype(np.int64),
                           minlength=64)
        en_k, en_c = np.unique(names[m], return_counts=True)
        enum = dict(zip(en_k.tolist(), en_c.tolist()))
        topk = sorted(enum.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
        exact = [
            (leaves[0].value(), int(m.sum())),
            (leaves[1].value(), {"min": float(wb.min()), "max": float(wb.max()),
                                 "cardinality": len(wb)}),
            (leaves[2].value()["counts"], hist.tolist()),
            (leaves[3].value(), enum),
            (leaves[4].value(), topk),
            (leaves[5].count, len(wb)),
        ]
        for i, (got, want) in enumerate(exact):
            if got != want:
                raise AssertionError(f"{key} leaf {i}: {got} != {want}")
        w64 = wb.astype(np.float64)
        if not (np.allclose(leaves[5].s1, [w64.sum()], rtol=1e-5)
                and np.allclose(leaves[5].s2, [[(w64 * w64).sum()]], rtol=1e-5)):
            raise AssertionError(f"{key}: descriptive sums outside rtol 1e-5")
    if paths["wt_stats"].get("scan") != "device-compact":
        raise AssertionError("wt_stats did not reduce on the device")
    m_b_names = names[m_b]
    en_k = np.unique(m_b_names)
    wp = w[m_poly]
    st_p = results["stats_polygon"].stats
    if (st_p[0].value(), st_p[1].value()) != (int(m_poly.sum()), {
            "min": float(wp.min()), "max": float(wp.max()), "cardinality": len(wp)}):
        raise AssertionError("stats_polygon differs from the f32 even-odd oracle")
    codes = np.array([st.dicts["name"].code_of(v) for v in en_k])[
        np.unique(m_b_names, return_inverse=True)[1]]
    if not np.array_equal(results["frequency_name"].counts, count_min_grid(codes, 256)):
        raise AssertionError("frequency_name: count-min grid differs from NumPy's")
    for key, keep_rows, k in (("knn_10", np.ones(n, bool), 10),
                              ("knn_100_name", names == KNN_NAME, 100)):
        fc = results[key]
        kth, pairs, near = knn_check((fc.columns["geom__x"], fc.columns["geom__y"]),
                                     x, y, keep_rows, -90.0, 40.0, k)
        log(f"[check] slice4 {key}: k-th distance {kth:.3f} m, boundary pairs {pairs}, "
            f"rows within 1e-6 of the k-th distance {near}")
    log(f"[check] slice4: query rows and columns equal the f64 (polygon: f32 even-odd) "
        f"oracle in table order ({len(rows_b)} and {len(rows_p)} rows); sorted, projected "
        f"and sampled results equal their NumPy lexsort / counters; stats exact "
        f"(descriptive within rtol 1e-5); count-min grid equal; kNN distance sets equal")
    return launches


POLY_SPEC6 = "name:String,height:Float,dtg:Date,*geom:Polygon"
LINE_SPEC6 = "dtg:Date,*geom:LineString"
#: about the count of NYC Open Data's "Building Footprints" layer
POLY_ROWS = 1_100_000
#: the order of NYC's street centreline layer
LINE_ROWS = 200_000
NYC = (-74.26, 40.49, -73.70, 40.92)
#: the viewport: 0.06 x 0.05 degrees over Midtown to Downtown Brooklyn
VIEW = (-73.99, 40.70, -73.93, 40.75)
#: the loose-BBOX density's grid: an xz3 chunk's rows spread over a whole
#: depth-12 cell (0.088 x 0.044 degrees, wider than the viewport), so at
#: 512 x 512 every chunk pairs with all 16 tiles (over the duplication
#: budget of 4) and the grouped rung declines; at 256 x 256 it pairs with
#: at most the 4 tiles there are
LOOSE_GRID = 256
M_PER_DEG = 111_319.49079327358


def make_polys(n: int, seed: int):
    """Building-footprint-like polygons over NYC's box: star-convex rings
    of 4-8 vertices of radius 5-30 m around uniform centres; one in 50 a
    2-part MultiPolygon (a 4-vertex annex 40 m east), one in 50 with a hole
    (the ring scaled by 0.3 toward its centre). Returns the Geometry
    objects and per-row f64 arrays: bounds, the shoelace area, centres."""
    from geomesa_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(seed + 6)
    K = 8
    cx, cy = rng.uniform(NYC[0], NYC[2], n), rng.uniform(NYC[1], NYC[3], n)
    k = rng.integers(4, K + 1, n)
    j = np.arange(K)
    ang = rng.uniform(0, 2 * np.pi, n)[:, None] + (
        j[None, :] + rng.uniform(0.1, 0.9, (n, K))) * (2 * np.pi / k[:, None])
    r = rng.uniform(5, 30, (n, K))
    mx = 1.0 / (M_PER_DEG * np.cos(np.radians(cy)))[:, None]
    vx = cx[:, None] + r * np.cos(ang) * mx
    vy = cy[:, None] + r * np.sin(ang) / M_PER_DEG
    used = j[None, :] < k[:, None]
    multi = np.arange(n) % 50 == 17
    holed = np.arange(n) % 50 == 33
    # the annex: a 4-vertex ring of radius 6 m, 40 m east of the centre
    aa = np.arange(4) * (np.pi / 2) + 0.3
    ax = cx[:, None] + (40 + 6 * np.cos(aa))[None, :] * mx
    ay = cy[:, None] + 6 * np.sin(aa)[None, :] / M_PER_DEG
    xmin = np.where(used, vx, np.inf).min(1)
    xmax = np.where(used, vx, -np.inf).max(1)
    ymin = np.where(used, vy, np.inf).min(1)
    ymax = np.where(used, vy, -np.inf).max(1)
    xmin = np.where(multi, np.minimum(xmin, ax.min(1)), xmin)
    xmax = np.where(multi, np.maximum(xmax, ax.max(1)), xmax)
    ymin = np.where(multi, np.minimum(ymin, ay.min(1)), ymin)
    ymax = np.where(multi, np.maximum(ymax, ay.max(1)), ymax)

    def shoelace(x, y, m):  # |ring area|, rows of x / y padded past m
        x2 = np.where(m, x, x[:, :1])
        y2 = np.where(m, y, y[:, :1])
        return 0.5 * np.abs((x2 * np.roll(y2, -1, 1) - np.roll(x2, -1, 1) * y2).sum(1))

    area = shoelace(vx, vy, used)
    area = np.where(holed, area * (1 - 0.3 ** 2), area)
    area = np.where(multi, area + shoelace(ax, ay, np.ones_like(ax, bool)), area)
    xs, ys, axs, ays = vx.tolist(), vy.tolist(), ax.tolist(), ay.tolist()
    geoms = []
    for i in range(n):
        ki = int(k[i])
        shell = tuple(zip(xs[i][:ki], ys[i][:ki]))
        shell += shell[:1]
        if holed[i]:
            hole = tuple((cx[i] + 0.3 * (x - cx[i]), cy[i] + 0.3 * (y - cy[i])) for x, y in shell)
            geoms.append(geo.Polygon(shell, (hole,)))
        elif multi[i]:
            annex = tuple(zip(axs[i], ays[i]))
            geoms.append(geo.MultiPolygon((geo.Polygon(shell), geo.Polygon(annex + annex[:1]))))
        else:
            geoms.append(geo.Polygon(shell))
    return geoms, {"xmin": xmin, "ymin": ymin, "xmax": xmax, "ymax": ymax,
                   "area": area, "cx": cx, "cy": cy, "holed": holed}


def make_lines(n: int, seed: int):
    """Street-segment-like polylines: 3-6 vertices, steps of 30-150 m in
    random directions from a uniform start over NYC's box. Returns the
    LineStrings and their f64 bounds."""
    from geomesa_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(seed + 7)
    K = 6
    k = rng.integers(3, K + 1, n)
    x0, y0 = rng.uniform(NYC[0], NYC[2], n), rng.uniform(NYC[1], NYC[3], n)
    step = rng.uniform(30, 150, (n, K - 1)) / M_PER_DEG
    th = rng.uniform(0, 2 * np.pi, (n, K - 1))
    coslat = np.cos(np.radians(y0))[:, None]
    vx = np.concatenate([x0[:, None], x0[:, None] + np.cumsum(step * np.cos(th) / coslat, 1)], 1)
    vy = np.concatenate([y0[:, None], y0[:, None] + np.cumsum(step * np.sin(th), 1)], 1)
    used = np.arange(K)[None, :] < k[:, None]
    xs, ys = vx.tolist(), vy.tolist()
    lines = [geo.LineString(tuple(zip(xs[i][:int(k[i])], ys[i][:int(k[i])])))
             for i in range(n)]
    return lines, {"xmin": np.where(used, vx, np.inf).min(1),
                   "xmax": np.where(used, vx, -np.inf).max(1),
                   "ymin": np.where(used, vy, np.inf).min(1),
                   "ymax": np.where(used, vy, -np.inf).max(1)}


def borough_wkt() -> str:
    """A borough-like polygon, neighbourhood-sized so the host refinement
    stays in the phase's budget: a 40-vertex wavy shell about 1.6 km across
    with an 8-vertex hole (a park)."""
    def ring(n, rx, ry, wave, ph):
        pts = []
        for i in range(n):
            a = 2 * math.pi * i / n + ph
            r = 1 + wave * math.sin(3 * a)
            pts.append((round(-73.955 + rx * r * math.cos(a), 6),
                        round(40.685 + ry * r * math.sin(a), 6)))
        pts.append(pts[0])
        return "(" + ", ".join(f"{x} {y}" for x, y in pts) + ")"

    return f"POLYGON ({ring(40, 0.0105, 0.008, 0.2, 0.0)}, {ring(8, 0.003, 0.0022, 0.0, 0.1)})"


LINE_LIT = ("LINESTRING (" + ", ".join(
    f"{-73.975 + 0.0035 * i} {40.72 + 0.002 * math.sin(i)}" for i in range(10)) + ")")


def env_overlap(b, box):
    """f64 envelope overlap of per-row bounds ``b`` with ``box``."""
    return ((b["xmin"] <= box[2]) & (b["xmax"] >= box[0])
            & (b["ymin"] <= box[3]) & (b["ymax"] >= box[1]))


def host_grid(x, y, bbox, w, h):
    """The host path's grid of exact f64 rows: f64 pixels, edge-clipped."""
    xmin, ymin, xmax, ymax = bbox
    px = np.clip(((x - xmin) / (xmax - xmin) * w).astype(np.int32), 0, w - 1)
    py = np.clip(((y - ymin) / (ymax - ymin) * h).astype(np.int32), 0, h - 1)
    return np.bincount(py * w + px, minlength=w * h).reshape(h, w)


def device_grid(x, y, bbox, w, h):
    """The device's grid of f32 rows: the reference's f32 pixel mapping
    (origin and span rounded to f32), edge-clipped."""
    f = np.float32
    xmin, ymin, xmax, ymax = bbox
    x32, y32 = x.astype(f), y.astype(f)
    px = np.clip(((x32 - f(xmin)) / f(xmax - xmin) * f(w)).astype(np.int32), 0, w - 1)
    py = np.clip(((y32 - f(ymin)) / f(ymax - ymin) * f(h)).astype(np.int32), 0, h - 1)
    return np.bincount(py * w + px, minlength=w * h).reshape(h, w)


def slice6(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped):
    """The slice-6 phase (see the module docstring, 7). Returns its
    launches of both kernels."""
    from geomesa_tpu_torch import config, geofn
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms
    from geomesa_tpu_torch.utils import geometry as geo

    t_phase = time.perf_counter()
    n, n_lines = args.poly_rows, args.line_rows
    if n != POLY_ROWS or n_lines != LINE_ROWS:
        log(f"[slice6] cut: {n} polygons, {n_lines} lines instead of {POLY_ROWS}, {LINE_ROWS}")
    t0 = time.perf_counter()
    geoms, pb = make_polys(n, args.seed)
    lines, lb = make_lines(n_lines, args.seed)
    rng = np.random.default_rng(args.seed + 8)
    zipf = 1.0 / np.arange(1, 257) ** 1.1
    lo = parse_iso_ms("2020-01-01")
    month = parse_iso_ms("2020-02-01") - lo
    pdata = {"name": np.array([f"n{i:03d}" for i in range(256)])[
                 rng.choice(256, n, p=zipf / zipf.sum())],
             "height": rng.uniform(2, 50, n).astype(np.float32),
             "dtg": rng.integers(lo, lo + month, n).astype("datetime64[ms]"),
             "geom": geoms}
    ldata = {"dtg": rng.integers(lo, lo + month, n_lines).astype("datetime64[ms]"),
             "geom": lines}
    gen_s = time.perf_counter() - t0
    ingest = {}
    for schema, spec, d, rows in (("nyc_buildings", POLY_SPEC6, pdata, n),
                                  ("nyc_streets", LINE_SPEC6, ldata, n_lines)):
        t0 = time.perf_counter()
        ds.create_schema(schema, spec)
        ds.insert(schema, d, fids=np.arange(rows).astype(str))
        encode_s = time.perf_counter() - t0
        ds.flush(schema)
        st = ds._store(schema)
        ingest[schema] = (encode_s, dict(st.flush_seconds))
        log(f"[slice6] ingest {schema}: {rows} rows, encode {encode_s:.3f} s, flush "
            f"{sum(st.flush_seconds.values()):.3f} s by stage "
            f"{ {k: round(v, 3) for k, v in st.flush_seconds.items()} }; tables {list(st.tables)}")
    log(f"[slice6] generated {n} polygons and {n_lines} lines in {gen_s:.3f} s")

    view = ", ".join(str(v) for v in VIEW)
    borough = borough_wkt()
    bpoly = geo.parse_wkt(borough)
    q_v = f"BBOX(geom, {view}) AND {DURING}"
    # a point inside a footprint with no hole
    i_pt = next(i for i in range(12345, n) if not pb["holed"][i])
    pt = (float(pb["cx"][i_pt]), float(pb["cy"][i_pt]))
    areas = np.sort(pb["area"][env_overlap(pb, VIEW)])
    a_cut = float((areas[len(areas) // 2 - 1] + areas[len(areas) // 2]) / 2)
    pts_q = f"INTERSECTS(geom, {wkt}) AND weight * 2 > 1.2 AND {DURING}"
    grid = dict(bbox=VIEW, width=WIDTH, height=HEIGHT)
    lgrid = dict(bbox=VIEW, width=LOOSE_GRID, height=LOOSE_GRID)

    def loose(fn):
        def run():
            with config.LOOSE_BBOX.scoped(True):
                return fn()
        return run

    #: key -> (schema, query, call)
    calls = {
        "count_v": ("nyc_buildings", q_v, lambda: ds.count("nyc_buildings", q_v)),
        "query_v": ("nyc_buildings", q_v, lambda: ds.query("nyc_buildings", q_v)),
        "density_v": ("nyc_buildings", q_v,
                      lambda: ds.density("nyc_buildings", q_v, **grid)),
        "loose_count_v": ("nyc_buildings", q_v,
                          loose(lambda: ds.count("nyc_buildings", q_v))),
        "loose_density_v": ("nyc_buildings", q_v,
                            loose(lambda: ds.density("nyc_buildings", q_v, **lgrid))),
        "intersects_borough": ("nyc_buildings", f"INTERSECTS(geom, {borough}) AND {DURING}",
                               None),
        "within_borough": ("nyc_buildings", f"WITHIN(geom, {borough}) AND {DURING}", None),
        "contains_point": ("nyc_buildings", f"CONTAINS(geom, POINT ({pt[0]} {pt[1]}))",
                           "query"),
        "dwithin_line": ("nyc_buildings",
                         f"DWITHIN(geom, {LINE_LIT}, 100, meters) AND {DURING}", None),
        "expr_height": ("nyc_buildings", f"height * 3 > 60 AND BBOX(geom, {view})", None),
        "expr_area": ("nyc_buildings", f"st_area(geom) > {a_cut!r} AND BBOX(geom, {view})",
                      None),
        "streets_intersects": ("nyc_streets", f"INTERSECTS(geom, {borough})", None),
        "streets_crosses": ("nyc_streets", f"CROSSES(geom, {borough})", None),
        "points_expr_count": ("gdelt3", pts_q, None),
        "points_expr_density": ("gdelt3", pts_q, lambda: ds.density(
            "gdelt3", pts_q, bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)),
    }
    for key, (schema, q, fn) in list(calls.items()):
        if fn is None:
            fn = lambda schema=schema, q=q: ds.count(schema, q)  # noqa: E731
        elif fn == "query":
            fn = lambda schema=schema, q=q: ds.query(schema, q)  # noqa: E731
        calls[key] = (schema, q, fn)

    kpip.launches = 0
    kgrouped.launches = 0
    results, rec, at = {}, {}, {}
    for key, (schema, q, fn) in calls.items():
        results[key], cold = timed(torch, fn)
        at[key] = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
        if key.startswith("loose"):
            with config.LOOSE_BBOX.scoped(True):
                plan = ds._plan(schema, q)
        else:
            plan = ds._plan(schema, q)
        path = dict(plan.exec_path)
        reps = 3 if path.get("refined_rows", 0) > 10_000 else args.reps
        warm = [timed(torch, fn)[1] for _ in range(reps)]
        ans = results[key]
        rows = (ans if isinstance(ans, int) else len(ans) if hasattr(ans, "columns")
                else int(ans.sum()))
        rec[key] = {"index": plan.index_name, "path": path, "rows": rows,
                    "cold_ms": cold * 1e3, "warm_ms": float(np.median(warm)) * 1e3,
                    "reps": reps}
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    for key, (schema, q, fn) in calls.items():
        r = rec[key]
        # a host-bound call's share is read off one call
        prof_reps = 1 if r["path"].get("refined_rows") else min(r["reps"], 3)
        wall, busy, top, _ = profile_warm(torch, fn, prof_reps,
                                          out_dir / f"slice6_{key}.json")
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        ref = r["path"].get("refined_rows")
        per_row = (f", host refine {r['path']['refine_ms'] / ref * 1e3:.2f} us/row over "
                   f"{ref} rows" if ref else "")
        log(f"[slice6] {key}: index {r['index']}, exec_path {r['path']}, rows {r['rows']}, "
            f"cold {r['cold_ms']:.3f} ms, warm p50 {r['warm_ms']:.3f} ms ({r['reps']} reps)"
            f"{per_row}; device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms'}/call, idle share "
            f"{share} (profiled wall {wall:.3f} ms/call), top device work (ms/call) {top}")
    log(f"[slice6] count_v host profile, top own times (ms): "
        f"{host_profile(torch, calls['count_v'][2], top=8)}")
    for schema in ("nyc_buildings", "nyc_streets"):
        st = ds._store(schema)
        log(f"[slice6] {schema}: encode {ingest[schema][0]:.3f} s, flush "
            f"{ {k: round(v, 3) for k, v in ingest[schema][1].items()} } s; device bytes by "
            f"table { {name: t.device_bytes() for name, t in st.tables.items()} }")
    log(f"[slice6] launches {launches}; after loose_density_v "
        f"{at['loose_density_v']}, after points_expr_count {at['points_expr_count']}")
    if rec["loose_density_v"]["path"].get("density_kernel") != "grouped" \
            or at["loose_density_v"]["density_grouped"] <= at["loose_count_v"]["density_grouped"]:
        raise AssertionError("the loose-BBOX density did not run the grouped kernel: "
                             f"{rec['loose_density_v']['path']}, {at}")
    if at["points_expr_count"]["pip"] <= at["streets_crosses"]["pip"]:
        raise AssertionError(f"the expression on the points did not run the pip kernel: {at}")

    # both kernels against their plain versions on this phase's operands:
    # the loose density's xz chunks paired by centroid boxes, and the
    # points' expression plan's scanned rows
    from geomesa_tpu_torch.kernels.density import density_grid

    with config.LOOSE_BBOX.scoped(True):
        o = ds._executor("nyc_buildings").density_inputs(
            ds._plan("nyc_buildings", q_v), VIEW, LOOSE_GRID, LOOSE_GRID)
    if o is None:
        raise AssertionError("the loose-BBOX plan did not take the grouped rung")
    a = (o["x"], o["y"], o["mask"], o["weight"], VIEW, LOOSE_GRID, LOOSE_GRID, o["sched"])
    g_k, g_p = kgrouped.density_grouped(*a), kgrouped.density_grouped_plain(*a)
    torch.cuda.synchronize()
    d_err = float((g_k - g_p).abs().max())
    d_ms, d_plain, _ = in_turns(torch, lambda: kgrouped.density_grouped(*a),
                                lambda: kgrouped.density_grouped_plain(*a), 20, 3)
    # the scatter rung (the reference's for xz) on the same operands
    d_scatter = cuda_ms(torch, lambda: density_grid(o["x"], o["y"], o["mask"], VIEW,
                                                    LOOSE_GRID, LOOSE_GRID), 20)
    d_bound = bound(*density_work(o, LOOSE_GRID, LOOSE_GRID)[:2])
    log(f"[slice6] density_grouped on the loose density's {tuple(o['x'].shape)} rows, "
        f"{o['sched']['chunks'].numel()} pairs: max abs err {d_err}; {d_ms:.6f} ms (plain "
        f"{d_plain:.6f} ms, scatter rung {d_scatter:.6f} ms, bound {d_bound[0]:.6f} ms by "
        f"{d_bound[1]})")
    if d_err != 0.0:
        raise AssertionError("density kernel disagrees with its plain version on xz chunks")
    pc = ds._executor("gdelt3").scan_columns(ds._plan("gdelt3", pts_q), ["geom__x", "geom__y"])
    px, py = pc["geom__x"], pc["geom__y"]
    edges = torch.from_numpy(packed).cuda()
    bad = int((kpip.pip_mask(px, py, edges, n_edges)
               != kpip.pip_mask_plain(px, py, edges, n_edges)).sum())
    p_ms, p_plain, _ = in_turns(torch, lambda: kpip.pip_mask(px, py, edges, n_edges),
                                lambda: kpip.pip_mask_plain(px, py, edges, n_edges), 20, 3)
    log(f"[slice6] pip on the points' expression plan's {tuple(px.shape)} points: {bad} "
        f"mismatches; {p_ms:.6f} ms (plain {p_plain:.6f} ms)")
    if bad:
        raise AssertionError("pip kernel disagrees with its plain version on the expression plan")

    # the loose density end to end on each rung, in turns: scatter
    # (`geomesa.density.pallas.max.dup` 0, as the reference runs xz), grouped
    def rung(dup):
        def run():
            with config.LOOSE_BBOX.scoped(True), config.DENSITY_PALLAS_MAX_DUP.scoped(dup):
                return ds.density("nyc_buildings", q_v, **lgrid)
        return run

    scatter_run, grouped_run = rung(0.0), rung(config.DENSITY_PALLAS_MAX_DUP.to_float())
    g_scatter = scatter_run()
    with config.LOOSE_BBOX.scoped(True):
        kern = ds._plan("nyc_buildings", q_v).exec_path.get("density_kernel")
    if kern != "scatter" or not np.array_equal(g_scatter, results["loose_density_v"]):
        raise AssertionError(f"the scatter rung's loose density differs ({kern})")
    ab = {"scatter": [], "grouped": []}
    for name in ("scatter", "grouped", "grouped", "scatter"):
        fn = scatter_run if name == "scatter" else grouped_run
        ab[name] += [timed(torch, fn)[1] * 1e3 for _ in range(args.reps)]
    log(f"[slice6] loose density 256x256 warm p50, rungs in turns ({2 * args.reps} calls "
        f"each): scatter {float(np.median(ab['scatter'])):.3f} ms, grouped "
        f"{float(np.median(ab['grouped'])):.3f} ms")

    # -- the answers against oracles independent of index, plan and coarse mask
    tm = time_mask(pdata)

    def exact(b, box, keep, pred, objs):
        rows = np.flatnonzero(env_overlap(b, box) & keep)
        return rows[np.array([bool(pred(objs[i])) for i in rows], bool)] if len(rows) \
            else rows

    vpoly = geo.bbox_polygon(*VIEW)
    all_p, all_l = np.ones(n, bool), np.ones(n_lines, bool)
    rows_v = exact(pb, VIEW, tm, lambda g: geofn.st_intersects(g, vpoly), geoms)
    bb = bpoly.bounds()
    lb_ = geo.parse_wkt(LINE_LIT).bounds()
    pad = 2 * 100 / M_PER_DEG / math.cos(math.radians(40.92))
    h64 = pdata["height"].astype(np.float64)
    rows_vall = exact(pb, VIEW, all_p, lambda g: geofn.st_intersects(g, vpoly), geoms)
    want = {
        "count_v": len(rows_v),
        "intersects_borough": len(exact(pb, bb, tm, lambda g: geofn.st_intersects(g, bpoly),
                                        geoms)),
        "within_borough": len(exact(pb, bb, tm, lambda g: geofn.st_within(g, bpoly), geoms)),
        "dwithin_line": len(exact(
            pb, (lb_[0] - pad, lb_[1] - pad, lb_[2] + pad, lb_[3] + pad), tm,
            lambda g: geofn.st_distanceSphere(g, geo.parse_wkt(LINE_LIT)) <= 100.0, geoms)),
        "expr_height": int((h64[rows_vall] * 3 > 60).sum()),
        "expr_area": int((pb["area"][rows_vall] > a_cut).sum()),
        "streets_intersects": len(exact(lb, bb, all_l,
                                        lambda g: geofn.st_intersects(g, bpoly), lines)),
        "streets_crosses": len(exact(lb, bb, all_l,
                                     lambda g: geofn.st_crosses(g, bpoly), lines)),
    }
    f = np.float32
    loose_m = ((pb["xmin"].astype(f) <= f(VIEW[2])) & (pb["xmax"].astype(f) >= f(VIEW[0]))
               & (pb["ymin"].astype(f) <= f(VIEW[3])) & (pb["ymax"].astype(f) >= f(VIEW[1]))
               & tm)
    want["loose_count_v"] = int(loose_m.sum())
    # the points: the device's f32 even-odd coarse mask, then the exact f64
    # tree (ring membership, the expression in f64, the interval)
    x, y, w = data["geom__x"], data["geom__y"], data["weight"]
    tm3 = time_mask(data)
    coarse = np.flatnonzero(polygon_rows(data, tm3, packed, n_edges))
    keep = geo.parse_wkt(wkt).contains_points(x[coarse], y[coarse]) \
        & (w[coarse].astype(np.float64) * 2 > 1.2)
    pts_rows = coarse[keep]
    want["points_expr_count"] = len(pts_rows)
    for key, v in want.items():
        if results[key] != v:
            raise AssertionError(f"slice6 {key}: {results[key]} != oracle {v}")
    fc = results["query_v"]
    got_rows = np.asarray(fc.fids, np.int64)
    if sorted(got_rows.tolist()) != rows_v.tolist():
        raise AssertionError("query_v: fids differ from the oracle's")
    wkts = fc.to_dict()["geom"]
    if any(wk != geoms[i].wkt() for wk, i in zip(wkts, got_rows.tolist())):
        raise AssertionError("query_v: a WKT differs from the stored geometry's")
    fc = results["contains_point"]
    want_pt = exact(pb, (pt[0], pt[1], pt[0], pt[1]), all_p,
                    lambda g: geofn.st_contains(g, geo.Point(*pt)), geoms)
    if sorted(int(v) for v in fc.fids) != want_pt.tolist() or i_pt not in want_pt:
        raise AssertionError("contains_point: fids differ from the oracle's")
    # the stored reference point of an extent: its bounds' centre
    mx, my = (pb["xmin"] + pb["xmax"]) / 2, (pb["ymin"] + pb["ymax"]) / 2
    grids = {
        "density_v": host_grid(mx[rows_v], my[rows_v], VIEW, WIDTH, HEIGHT),
        "loose_density_v": device_grid(mx[loose_m], my[loose_m], VIEW, LOOSE_GRID,
                                       LOOSE_GRID),
        "points_expr_density": host_grid(x[pts_rows], y[pts_rows], QUERY_BBOX, WIDTH, HEIGHT),
    }
    for key, g in grids.items():
        got = results[key]
        if got.shape != g.shape or not np.array_equal(got.astype(np.float64), g):
            raise AssertionError(f"slice6 {key}: grid differs from the oracle "
                                 f"({int((got != g).sum())} cells)")
    log(f"[check] slice6: counts exact against envelope-prefiltered geofn oracles "
        f"{ {k: want[k] for k in sorted(want)} }; query_v fids and WKT equal the stored "
        f"geometries' ({len(rows_v)} rows); contains_point {want_pt.tolist()}; grids "
        f"equal (exact: host f64 pixels; loose: f32 pixels); the phase took "
        f"{time.perf_counter() - t_phase:.3f} s")
    return launches


PART_SPEC = "weight:Float,dtg:Date,*geom:Point;geomesa.partition='time'"
#: BASELINE config #3's scale; the JAX bench partitions from 50M rows on
#: (bench.py:1082), the least this phase may be cut to
PART_ROWS = 100_000_000
PART_MIN_ROWS = 50_000_000
#: the bench's ingest chunk (bench.py:1120)
PART_CHUNK = 25_000_000
LONG_LO, LONG_HI = "2020-01-01T00:00:00", "2020-06-01T00:00:00"
LONG = f"dtg DURING {LONG_LO}Z/{LONG_HI}Z"
PART_STATS = "Count();MinMax(weight);Histogram(weight,64,0,1);DescriptiveStats(weight)"
WEEK_MS = 7 * 86_400_000


def paths_by_partition(parts):
    """{per-partition exec_path: [bins]}: the partitions grouped by the path
    their scan took."""
    out = {}
    for b, p in parts.items():
        out.setdefault(json.dumps(p, sort_keys=True), []).append(b)
    return out


def slice5(args, torch, wkt, packed, n_edges, kpip, kgrouped):
    """The slice-5 phase (see the module docstring, 8). Returns its
    launches of both kernels."""
    import shutil

    from geomesa_tpu_torch import GeoDataset, Query, config

    n = args.part_rows
    if n != PART_ROWS:
        log(f"[slice5] cut: {n} rows instead of {PART_ROWS}"
            + ("" if n >= PART_MIN_ROWS else f", below the bench's {PART_MIN_ROWS}"))
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    spill = out_dir / "spill"
    shutil.rmtree(spill, ignore_errors=True)
    spill.mkdir(parents=True)
    try:
        with config.SPILL_DIR.scoped(str(spill)):
            return _slice5(args, torch, n, wkt, packed, n_edges, kpip, kgrouped,
                           GeoDataset, Query)
    finally:
        shutil.rmtree(spill, ignore_errors=True)


def _slice5(args, torch, n, wkt, packed, n_edges, kpip, kgrouped, GeoDataset, Query):
    from geomesa_tpu_torch.kernels.density import pixel_coords

    t0 = time.perf_counter()
    data = make_data(n, args.seed)
    gen_s = time.perf_counter() - t0
    ds = GeoDataset(n_shards=8)
    ds.create_schema("gdelt5", PART_SPEC)
    st = ds._store("gdelt5")
    t0 = time.perf_counter()
    for lo in range(0, n, PART_CHUNK):
        hi = min(lo + PART_CHUNK, n)
        ds.insert("gdelt5", {k: v[lo:hi] for k, v in data.items()},
                  fids=np.arange(lo, hi).astype(str))
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds.flush("gdelt5")
    flush_s = time.perf_counter() - t0
    bins = st.partition_bins()
    log(f"[slice5] ingest {n} rows: generate {gen_s:.3f} s, encode {encode_s:.3f} s, "
        f"route + index + spill {flush_s:.3f} s; {len(bins)} weekly partitions "
        f"{bins[0]}-{bins[-1]}, rows {min(st.part_counts.values())}-"
        f"{max(st.part_counts.values())}; resident {list(st.partitions)} (budget "
        f"{st.max_resident}), {len(st.spilled)} spilled, {st.spills} snapshot writes")

    q_b = f"{BOX} AND {DURING}"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    q_long = f"{BOX} AND {LONG}"
    grid = dict(bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
    calls = {
        "count_b": (q_b, lambda: ds.count("gdelt5", q_b)),
        "density_b": (q_b, lambda: ds.density("gdelt5", q_b, **grid)),
        "density_b_weighted": (q_b, lambda: ds.density("gdelt5", q_b, weight="weight", **grid)),
        "count_polygon_b": (q_poly, lambda: ds.count("gdelt5", q_poly)),
        "sort_weight_desc_1000_b": (
            Query(q_b, sort_by=[("weight", True)], max_features=1000),
            lambda: ds.query("gdelt5", Query(q_b, sort_by=[("weight", True)],
                                             max_features=1000))),
        "stats_b": (q_b, lambda: ds.stats("gdelt5", PART_STATS, q_b)),
        "knn_10_b": (None, lambda: ds.knn("gdelt5", -90.0, 40.0, 10, q_b)),
        "count_long": (q_long, lambda: ds.count("gdelt5", q_long)),
        "density_long": (q_long, lambda: ds.density("gdelt5", q_long, **grid)),
    }
    ex = ds._executor("gdelt5")
    knn_paths = []
    real_knn = ex.knn_features

    def traced_knn(plan, *a, **kw):
        got = real_knn(plan, *a, **kw)
        knn_paths.append(dict(plan.exec_path))
        return got

    ex.knn_features = traced_knn
    #: the long window's warm calls: prefetch on (True) and off, in turns
    turns = {"count_long": (True, False), "density_long": (True, False, False, True)}

    def reps_of(key):  # kNN's host work runs about a second a call
        return max(3, args.reps // 4) if key == "knn_10_b" else args.reps

    t_phase = time.perf_counter()
    kpip.launches = 0
    kgrouped.launches = 0
    results, rec, prefetch = {}, {}, {}
    peak = None
    for key, (q, fn) in calls.items():
        st.spill_all()
        s0, l0 = st.spills, st.loads
        knn_paths.clear()
        if key == "density_long":  # the streaming peak, from cold
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # settles frees deferred by record_stream
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        results[key], cold = timed(torch, fn)
        if key == "density_long":
            peak = torch.cuda.max_memory_allocated() - base
        cold_io = (st.spills - s0, st.loads - l0)
        s0, l0 = st.spills, st.loads
        if key in turns:
            walls = {True: [], False: []}
            for on in turns[key]:
                ex.prefetch = on
                try:
                    ans, sec = timed(torch, fn)
                finally:
                    ex.prefetch = True
                walls[on].append(sec * 1e3)
                if not np.array_equal(np.asarray(ans), np.asarray(results[key])):
                    raise AssertionError(f"{key}: prefetch {'on' if on else 'off'} "
                                         "disagrees with the cold call")
            prefetch[key] = walls
            warm = [w / 1e3 for w in walls[True]]
        else:
            warm = [timed(torch, fn)[1] for _ in range(reps_of(key))]
        n_warm = len(turns.get(key, warm))
        path = dict(ds._plan("gdelt5", q).exec_path) if q is not None else knn_paths[-1]
        rec[key] = {
            "cold_ms": cold * 1e3, "warm_p50_ms": float(np.median(warm)) * 1e3,
            "reps": len(warm), "cold_spills_loads": cold_io,
            "warm_spills_loads": ((st.spills - s0) / n_warm, (st.loads - l0) / n_warm),
            "pruned": path.get("partitions_pruned"), "scanned": path.get("partitions_scanned"),
            "paths": paths_by_partition(path.get("partitions", {})),
            "sort": path.get("sort"),
        }
    ex.knn_features = real_knn
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    for key, r in rec.items():
        log(f"[slice5] {key}: partitions pruned {r['pruned']}, scanned {r['scanned']}; "
            f"cold {r['cold_ms']:.3f} ms (after spill_all: {r['cold_spills_loads'][0]} "
            f"snapshot writes, {r['cold_spills_loads'][1]} reloads), warm p50 "
            f"{r['warm_p50_ms']:.3f} ms ({r['reps']} reps; per warm call "
            f"{r['warm_spills_loads'][0]:.2f} writes, {r['warm_spills_loads'][1]:.2f} "
            f"reloads){'; sort ' + r['sort'] if r['sort'] else ''}; exec_path by "
            f"partition {r['paths']}")
    for key, walls in prefetch.items():
        log(f"[slice5] {key} prefetch on {walls[True]} ms, off {walls[False]} ms (in turns "
            f"{['on' if t else 'off' for t in turns[key]]}): mean on "
            f"{np.mean(walls[True]):.3f} ms, off {np.mean(walls[False]):.3f} ms; answers "
            "equal to the cold call's")
    up = ex.uploader
    log(f"[slice5] launches {launches}; side-stream uploads {up.bytes} B, pinned buffers "
        f"allocated {up.pool.allocations}, pooled {up.pool.buffers()}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in slice 5's phase: {launches}")

    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    for key, (_, fn) in calls.items():
        # a long-window call reloads its partitions anyway: no warm-up call
        long = key in turns
        trace = out_dir / f"slice5_{key}.json"
        wall, busy, top, d2h = profile_warm(torch, fn, 1 if long else reps_of(key), trace,
                                            warmup=not long)
        trace.unlink(missing_ok=True)  # the long window's traces alone outgrow the output cap
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        log(f"[profile] slice5 {key}: wall {wall:.4f} ms/call, device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms/call'}, idle share "
            f"{share}, D2H {'not measured' if d2h is None else f'{d2h:.0f} B'}/call, "
            f"top device work (ms/call) {top}")
    for key in ("knn_10_b", "count_long"):
        log(f"[slice5] {key} host profile, top own times (ms): "
            f"{host_profile(torch, calls[key][1], top=8)}")

    # device residency: the long window's cold peak (above) against the
    # largest partition's own cold peak
    big = max(st.part_counts, key=st.part_counts.get)
    lo_ms = big * WEEK_MS + 3_600_000
    q_one = f"{BOX} AND dtg DURING {_iso(lo_ms)}/{_iso(lo_ms + WEEK_MS - 7_200_000)}"
    st.spill_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ds.density("gdelt5", q_one, **grid)
    torch.cuda.synchronize()
    one = torch.cuda.max_memory_allocated() - base
    if ds._plan("gdelt5", q_one).exec_path["partitions_scanned"] != 1:
        raise AssertionError("the one-partition query scanned another partition")
    child = st.partitions[big]
    cols = sum(t.device_bytes() for t in child.tables.values())
    slabs = sum(v.nbytes for v in child.device_state.get("gathered", {}).values())
    every = peak
    grids = (math.ceil(math.log2(len(bins))) + 1) * WIDTH * HEIGHT * 4
    limit = (st.max_resident + 1) * one + grids
    st.spill_all()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    log(f"[slice5] peak device memory: long window {every} B over {len(bins)} partitions "
        f"(budget {st.max_resident}); one partition (bin {big}, {st.part_counts[big]} "
        f"rows) {one} B, of it columns {cols} B and gathered slabs {slabs} B; bound "
        f"(budget + 1) x one + {grids} B of grids = {limit} B; after spill_all "
        f"{left} B above the baseline")
    if every > limit:
        raise AssertionError(f"streaming peak {every} B above the residency bound {limit} B")
    if left > 0:
        raise AssertionError(f"{left} B of device memory outlived spill_all")

    # both kernels at one partition's shapes, against their plain versions
    st.spill_all()
    calls["density_b"][1]()
    calls["count_polygon_b"][1]()
    plan_b, plan_p = ds._plan("gdelt5", q_b), ds._plan("gdelt5", q_poly)
    b0 = ex.prune(plan_b)[0]
    cex = ex._executor_for(b0, st.child(b0))
    o = cex.density_inputs(plan_b, QUERY_BBOX, WIDTH, HEIGHT)
    if o is None:
        raise AssertionError(f"partition {b0} did not take the grouped rung")
    a = (o["x"], o["y"], o["mask"], o["weight"], QUERY_BBOX, WIDTH, HEIGHT, o["sched"])
    if not torch.equal(kgrouped.density_grouped(*a), kgrouped.density_grouped_plain(*a)):
        raise AssertionError("density kernel disagrees with its plain version on a partition")
    d_ms, d_plain, _ = in_turns(torch, lambda: kgrouped.density_grouped(*a),
                                lambda: kgrouped.density_grouped_plain(*a), 20, 3)
    d_bound = bound(*density_work(o)[:2])
    # the library yardstick at these shapes, as at the main path's:
    # torch.bincount over precomputed cell ids, the mask as the weight
    cx, cy = pixel_coords(o["x"], o["y"], QUERY_BBOX, WIDTH, HEIGHT)
    flat = (cy.to(torch.int64) * WIDTH + cx).reshape(-1)
    wflat = o["mask"].reshape(-1).to(torch.float32)
    d_lib = cuda_ms(torch, lambda: torch.bincount(flat, weights=wflat,
                                                  minlength=WIDTH * HEIGHT), 20)
    pc = cex.scan_columns(plan_p, ["geom__x", "geom__y"])
    px, py = pc["geom__x"], pc["geom__y"]
    edges = torch.from_numpy(packed).cuda()
    bad = int((kpip.pip_mask(px, py, edges, n_edges)
               != kpip.pip_mask_plain(px, py, edges, n_edges)).sum())
    if bad:
        raise AssertionError(f"pip kernel disagrees with its plain version on {bad} points")
    p_ms, p_plain, _ = in_turns(torch, lambda: kpip.pip_mask(px, py, edges, n_edges),
                                lambda: kpip.pip_mask_plain(px, py, edges, n_edges), 20, 3)
    p_bound = bound(*pip_work(kpip, py, packed, n_edges)[:2])
    log(f"[slice5] kernels at partition {b0}'s shapes: density_grouped on "
        f"{tuple(o['x'].shape)} rows, {o['sched']['chunks'].numel()} pairs: {d_ms:.6f} ms "
        f"(plain {d_plain:.6f} ms, torch.bincount {d_lib:.6f} ms, bound {d_bound[0]:.6f} ms "
        f"by {d_bound[1]}); pip on "
        f"{tuple(px.shape)} points: {p_ms:.6f} ms (plain {p_plain:.6f} ms, bound "
        f"{p_bound[0]:.6f} ms by {p_bound[1]}); both equal their plain versions")

    # the answers against NumPy oracles
    x, y, w = data["geom__x"], data["geom__y"], data["weight"]
    tm = time_mask(data)
    m_b = (x >= -100) & (x <= -80) & (y >= 30) & (y <= 45) & tm
    g_u, g_w, _, n_b = density_oracles(data, tm)
    want = {"count_b": n_b, "count_polygon_b": polygon_oracle(data, tm, packed, n_edges)}
    tm_long = time_mask(data, LONG_LO, LONG_HI)
    g_long, _, _, want["count_long"] = density_oracles(data, tm_long)
    for key, v in want.items():
        if results[key] != v:
            raise AssertionError(f"{key}: {results[key]} != oracle {v}")
    for key, oracle in (("density_b", g_u), ("density_long", g_long)):
        g = results[key]
        if g.shape != (HEIGHT, WIDTH) or not np.array_equal(g.astype(np.float64), oracle):
            raise AssertionError(f"{key}: unweighted grid differs from the oracle")
    gw = results["density_b_weighted"]
    if not (np.isfinite(gw).all() and np.allclose(gw, g_w, rtol=1e-4, atol=1e-3)):
        raise AssertionError("density_b_weighted outside rtol 1e-4 / atol 1e-3")
    fc = results["sort_weight_desc_1000_b"]
    rows = np.char.decode(fc.columns["__fid__"]).astype(np.int64)
    wb = np.sort(w[m_b])[::-1][:1000]
    edge = wb[-1]
    above = np.flatnonzero(m_b & (w > edge))
    if not (m_b[rows].all() and np.array_equal(w[rows], wb)
            and np.array_equal(np.sort(rows[w[rows] > edge]), above)):
        raise AssertionError("sort_weight_desc_1000_b differs from the NumPy top 1000")
    leaves = results["stats_b"].stats
    wm = w[m_b]
    hist = np.bincount(np.clip(np.floor(wm * np.float32(64)), 0, 63).astype(np.int64),
                       minlength=64)
    exact = [(leaves[0].value(), int(m_b.sum())),
             (leaves[1].value(), {"min": float(wm.min()), "max": float(wm.max()),
                                  "cardinality": len(wm)}),
             (leaves[2].value()["counts"], hist.tolist()), (leaves[3].count, len(wm))]
    for i, (got, v) in enumerate(exact):
        if got != v:
            raise AssertionError(f"stats_b leaf {i}: {got} != {v}")
    w64 = wm.astype(np.float64)
    if not (np.allclose(leaves[3].s1, [w64.sum()], rtol=1e-5)
            and np.allclose(leaves[3].s2, [[(w64 * w64).sum()]], rtol=1e-5)):
        raise AssertionError("stats_b: descriptive sums outside rtol 1e-5")
    fc = results["knn_10_b"]
    kth, pairs, near = knn_check((fc.columns["geom__x"], fc.columns["geom__y"]),
                                 x, y, m_b, -90.0, 40.0, 10)
    log(f"[check] slice5: counts exact (B {n_b}, polygon {want['count_polygon_b']}, long "
        f"window {want['count_long']}); unweighted grids exact, weighted within rtol 1e-4; "
        f"the top 1000 by weight equal NumPy's; stats exact (descriptive within rtol "
        f"1e-5); kNN k-th distance {kth:.3f} m, boundary pairs {pairs}, rows within 1e-6 "
        f"of it {near}; the phase took {time.perf_counter() - t_phase:.3f} s after ingest")
    return launches


def _iso(ms: int) -> str:
    return str(np.datetime64(int(ms), "ms")) + "Z"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10, help="warm runs per query")
    ap.add_argument("--part-rows", type=int, default=PART_ROWS,
                    help="rows of slice 5's partitioned dataset")
    ap.add_argument("--poly-rows", type=int, default=POLY_ROWS,
                    help="polygons of slice 6's building-footprint schema")
    ap.add_argument("--line-rows", type=int, default=LINE_ROWS,
                    help="lines of slice 6's street-segment schema")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        from geomesa_tpu_torch import GeoDataset
        from geomesa_tpu_torch.kernels import _build
        from geomesa_tpu_torch.kernels import density_grouped as kgrouped
        from geomesa_tpu_torch.kernels import pip as kpip
        from geomesa_tpu_torch.kernels.density import pixel_coords
        from geomesa_tpu_torch.utils.geometry import parse_wkt
    except ImportError as e:
        print(f"chip_smoke: geomesa_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 2

    # -- 1. device + build ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    fresh = [src for src in _build.SOURCES if src not in built]
    log(f"[build] {time.perf_counter() - t0:.3f} s for {len(built)} sources "
        f"(parallel nvcc); already up to date: {fresh or 'none'}")
    for src, rec in built.items():
        log(f"[build] {src}.cu: {rec['seconds']:.3f} s")
        for line in rec["log"].strip().splitlines():
            log(f"[build]   {line.strip()}")

    # -- 2. main path --------------------------------------------------------
    n = args.rows
    if n != 20_000_000:
        log(f"[main] cut: {n} rows instead of 20000000")
    data = make_data(n, args.seed)
    torch.cuda.reset_peak_memory_stats()
    ds = GeoDataset(n_shards=8)
    ds.create_schema("gdelt", "weight:Float,dtg:Date,*geom:Point")
    t0 = time.perf_counter()
    ds.insert("gdelt", data)
    ds.flush("gdelt")
    ingest_s = time.perf_counter() - t0
    log(f"[main] ingest {n} rows: {ingest_s:.3f} s")

    q_bbox = f"BBOX(geom, {', '.join(str(v) for v in QUERY_BBOX)}) AND {DURING}"
    wkt = polygon_wkt()
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    queries = {
        "count_bbox": lambda: ds.count("gdelt", q_bbox),
        "density": lambda: ds.density("gdelt", q_bbox, bbox=QUERY_BBOX,
                                      width=WIDTH, height=HEIGHT),
        "density_weighted": lambda: ds.density(
            "gdelt", q_bbox, bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT,
            weight="weight"),
        "count_polygon": lambda: ds.count("gdelt", q_poly),
    }
    kpip.launches = 0
    kgrouped.launches = 0
    results, latency, paths = {}, {}, {}
    for qname, fn in queries.items():
        results[qname], cold = timed(torch, fn)
        warm = [timed(torch, fn)[1] for _ in range(args.reps)]
        latency[qname] = {"cold_ms": cold * 1e3,
                          "warm_p50_ms": float(np.median(warm)) * 1e3}
        q = q_poly if qname == "count_polygon" else q_bbox
        paths[qname] = dict(ds._plan("gdelt", q).__dict__.get("exec_path", {}))
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    peak = torch.cuda.max_memory_allocated()
    for qname in queries:
        log(f"[main] {qname}: cold {latency[qname]['cold_ms']:.3f} ms, warm p50 "
            f"{latency[qname]['warm_p50_ms']:.3f} ms, exec_path {paths[qname]}")
    log(f"[main] launches {launches}; peak device memory {peak} B")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    for qname, fn in queries.items():
        wall, busy, top, _ = profile_warm(torch, fn, args.reps, out_dir / f"{qname}.json")
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        log(f"[profile] {qname}: wall {wall:.4f} ms/call, device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms/call'}, "
            f"idle share {share}, top device work (ms/call) {top}")

    # -- 3. kernels against their plain versions -------------------------------
    ex = ds._executor("gdelt")
    kernels = []
    poly = parse_wkt(wkt)
    (x1, _, _, _, _), packed = kpip.polygon_edge_tables(poly)
    n_edges = len(x1)
    edges = torch.from_numpy(packed).cuda()
    cols = ex.scan_columns(ds._plan("gdelt", q_poly), ["geom__x", "geom__y"])
    px, py = cols["geom__x"], cols["geom__y"]
    got = kpip.pip_mask(px, py, edges, n_edges)
    want = kpip.pip_mask_plain(px, py, edges, n_edges)
    torch.cuda.synchronize()
    pip_err = int((got != want).sum())
    npts = px.numel()
    log(f"[kernel] pip on {tuple(px.shape)} points x {n_edges} edges: "
        f"{pip_err} mismatches")
    if pip_err:
        raise AssertionError(f"pip kernel disagrees with its plain version on {pip_err} points")
    # the first kernel's count took every point against every edge
    pip_bytes, pip_ops, spans = pip_work(kpip, py, packed, n_edges)
    log(f"[kernel] pip work: {spans} crossing tests of {npts * n_edges} "
        f"point-edge pairs; operations counted {pip_ops} (every point against every edge: "
        f"{6 * npts * n_edges})")
    ms, plain_ms, turns = in_turns(
        torch, lambda: kpip.pip_mask(px, py, edges, n_edges),
        lambda: kpip.pip_mask_plain(px, py, edges, n_edges), 20, 3)
    log(f"[kernel] pip in turns (plain, kernel, kernel, plain) ms: {turns}")
    kernels.append({
        "name": "pip", "route": "cuda",
        "source": "geomesa_tpu_torch/csrc/pip.cu",
        "replaces": "geomesa_tpu/kernels/pallas_kernels.py:197",
        "launches": launches["pip"], "max_abs_err": float(pip_err),
        "ms": ms, "plain_ms": plain_ms,
        "bytes": pip_bytes, "ops": pip_ops,
        "library_ms": None,
    })

    bbox_plan = ds._plan("gdelt", q_bbox)
    ops_u = ex.density_inputs(bbox_plan, QUERY_BBOX, WIDTH, HEIGHT)
    ops_w = ex.density_inputs(bbox_plan, QUERY_BBOX, WIDTH, HEIGHT, "weight")
    if ops_u is None or ops_w is None:
        raise AssertionError("the main query did not take the grouped rung")
    errs = []
    def dargs(o):
        return (o["x"], o["y"], o["mask"], o["weight"], QUERY_BBOX, WIDTH,
                HEIGHT, o["sched"])

    for label, o in (("unweighted", ops_u), ("weighted", ops_w)):
        g_k = kgrouped.density_grouped(*dargs(o))
        g_p = kgrouped.density_grouped_plain(*dargs(o))
        torch.cuda.synchronize()
        err = float((g_k - g_p).abs().max())
        errs.append(err)
        log(f"[kernel] density_grouped {label} on {tuple(o['x'].shape)} rows, "
            f"{o['sched']['chunks'].numel()} pairs, "
            f"{o['sched']['seg_tile'].numel()} segments: max abs err {err}")
        if label == "unweighted":
            if not torch.equal(g_k, g_p):
                raise AssertionError("density kernel disagrees with its plain version")
        else:
            if not torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-3):
                raise AssertionError("weighted density kernel outside rtol 1e-4")
            rel = abs(float(g_k.sum()) - float(g_p.sum())) / max(float(g_p.sum()), 1.0)
            if rel >= 1e-4:
                raise AssertionError(f"weighted density sum off by {rel}")
    o = ops_u
    rows = o["x"].numel()
    d_bytes, d_ops, live = density_work(o)
    log(f"[kernel] density_grouped: {live} of {rows} scheduled rows are masked "
        f"in; bytes counted {d_bytes} (the first kernel's count, a 4-byte weight for every "
        f"row: {d_bytes + 4 * rows}; weighted adds {4 * live})")
    cx, cy = pixel_coords(o["x"], o["y"], QUERY_BBOX, WIDTH, HEIGHT)
    flat = (cy.to(torch.int64) * WIDTH + cx).reshape(-1)
    wflat = o["mask"].reshape(-1).to(torch.float32)
    ms, plain_ms, turns = in_turns(
        torch, lambda: kgrouped.density_grouped(*dargs(o)),
        lambda: kgrouped.density_grouped_plain(*dargs(o)), 20, 3)
    log(f"[kernel] density_grouped in turns (plain, kernel, kernel, plain) ms: "
        f"{turns}")
    ms_w = cuda_ms(torch, lambda: kgrouped.density_grouped(*dargs(ops_w)), 20)
    log(f"[kernel] density_grouped weighted: {ms_w:.6f} ms")
    kernels.append({
        "name": "density_grouped", "route": "cuda",
        "source": "geomesa_tpu_torch/csrc/density_grouped.cu",
        "replaces": "geomesa_tpu/kernels/density_pallas.py:201",
        "launches": launches["density_grouped"], "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms,
        "bytes": d_bytes,
        "ops": d_ops,
        "library_ms": cuda_ms(torch, lambda: torch.bincount(
            flat, weights=wflat, minlength=WIDTH * HEIGHT), 20),
    })
    for k in kernels:
        nbytes, nops = k.pop("bytes"), k.pop("ops")
        k["bound_ms"], k["bound_by"] = bound(nbytes, nops)
        log(f"[kernel] {k['name']}: {k['ms']:.6f} ms (plain {k['plain_ms']:.6f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.6f} ms by "
            f"{k['bound_by']}: {nbytes} B, {nops} f32 operations)")

    # -- 4. answers against the oracles -----------------------------------------
    tm = time_mask(data)
    g_u, g_w, g_64, n_bbox = density_oracles(data, tm)
    if results["count_bbox"] != n_bbox:
        raise AssertionError(f"bbox count {results['count_bbox']} != oracle {n_bbox}")
    grid = results["density"]
    if grid.shape != (HEIGHT, WIDTH) or not np.isfinite(grid).all():
        raise AssertionError("density grid has the wrong shape or non-finite cells")
    if not np.array_equal(grid.astype(np.float64), g_u):
        bad = int((grid.astype(np.float64) != g_u).sum())
        raise AssertionError(f"unweighted grid differs from the oracle in {bad} cells")
    if int(grid.sum()) != n_bbox:
        raise AssertionError("unweighted grid total differs from the count")
    gw = results["density_weighted"]
    if not (np.isfinite(gw).all() and np.allclose(gw, g_w, rtol=1e-4, atol=1e-3)):
        raise AssertionError("weighted grid outside rtol 1e-4 / atol 1e-3")
    if abs(gw.sum() - g_w.sum()) / max(g_w.sum(), 1) >= 1e-4:
        raise AssertionError("weighted grid sum outside 1e-4 relative")
    n_poly = polygon_oracle(data, tm, packed, n_edges)
    if results["count_polygon"] != n_poly:
        raise AssertionError(
            f"polygon count {results['count_polygon']} != f32 oracle {n_poly}")
    log(f"[check] bbox count {n_bbox} exact; grids match (unweighted exact, "
        f"weighted within rtol 1e-4); polygon count {n_poly} exact; cells where "
        f"the f64-pixel oracle differs from the reference's f32 pixel mapping: "
        f"{int((g_64 != g_u).sum())}")

    # -- 5. slice 3 ---------------------------------------------------------
    _, extra, fids = slice3(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)

    # -- 6. slice 4 ---------------------------------------------------------
    slice4(args, torch, ds, data, extra, fids, wkt, packed, n_edges, kpip)

    # -- 7. slice 6: extent schemas beside slice 3's points -------------------
    slice6(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)

    # -- 8. slice 5, on a partitioned store of its own -----------------------
    # the earlier phases' stores and operands leave the card first
    del ds, data, extra, fids, ex, cols, px, py, o, ops_u, ops_w, got, want
    del edges, cx, cy, flat, wflat
    torch.cuda.empty_cache()
    slice5(args, torch, wkt, packed, n_edges, kpip, kgrouped)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
