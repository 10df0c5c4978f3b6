#!/usr/bin/env python3
"""On-card smoke test of geomesa_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py [--rows N] [--seed S] [--reps R] [--part-rows N5]
                          [--poly-rows N6] [--line-rows L6] [--trip-rows N7]

(``--s10-child ROOT`` is the slice-10 phase's own crash child;
``--s10-save-split`` saves the slice-10 flat store once and prints the
time ``np.savez_compressed`` takes on each column of its chunk alone, and
nothing else.)

1. Device: the card's name and power limit, whether ``pyarrow`` is installed
   (and its version; logged only); builds the CUDA kernels from
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
   (``--reps``, 2 for the calls that return or sort over a million rows or
   take over 0.2 s cold), with its ``exec_path``, rows, cold and warm p50, D2H
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
   refinement after). Each call runs cold once and warm (``--reps``, 2 for
   calls that refine more than 10k rows or take over 0.2 s cold) and prints its index,
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
   BASELINE config #3's shape: N5 (default 50,000,000; the config's 100,000,000, cut
   for the time limit) points from the
   bench's generator (20M a month, so two and a half months of ``dtg`` at
   50M, five at 100M; seed as above), ingested in the bench's 25M-row
   chunks with ``fids`` 0..N5-1; 11 weekly partitions at 50M (23 at 100M)
   under the default budget of 4 resident, the rest
   spilled as lake snapshots (the default) to
   ``chiprun_out/chip_smoke/spill`` (removed at the end); the additive
   unweighted calls load only the row groups their box meets. On B
   (the bbox + 10 days, 2 partitions): count, density, weighted density,
   the polygon count, weight descending with ``max_features`` 1000 (each
   partition's top-k candidates), stats and ``knn(-90, 40, 10)``; on the
   long window (the box over 2020-01-01/2020-06-01, every partition, spill
   reloads on each call): count and density. Each call prints partitions
   pruned and scanned, snapshot writes and reloads, the path each
   partition's scan took, cold (after ``spill_all()``) and warm p50, and a
   profile's device busy / idle share; the long window's cold call is its
   prefetch-on sample (each long call reloads its partitions) and one call
   runs with the prefetch pipeline off (answer equal to the cold call's),
   and kNN and the long count print a cProfile. Peak
   device memory over the long window is held to (budget + 1) x one whole
   partition's cold peak (pushdown off) + the merge's grids, and spilling every partition
   must give the device memory back. Both kernels' counters are zeroed
   before the calls and must be > 0 after; both are timed against their
   plain versions at one partition's shapes. Answers against NumPy oracles
   as in 4 and 6 (the top 1000: the same weights and the same rows above
   the boundary weight).

9. Slice 7, spatial joins and ``region=`` aggregates, on a dataset of its
   own (after slice 6's stores leave the card, before slice 5): N7
   (default 3,000,000, about a month of NYC yellow-taxi trips) pickups and
   as many dropoffs (``fare:Float,dtg:Date,*geom:Point``, an invented
   Manhattan-heavy demand mixture over NYC's box, January 2024), 1,900 subway-entrance
   stations, 5 borough-like MultiPolygons (holes and islands, 5,340 edges)
   and 195 NTA-like polygons tiling the box (``nta:String,*geom:Polygon``).
   Calls: ``spatial_join`` of 10 days of pickups with the boroughs, fare
   summed (BASELINE #4, the ``pip_assign`` kernel); ``join_spatial`` and
   ``join_count`` of those pickups with the stations within 100 m
   (``dwithin_meters``: split and brute cells); ``join_count`` of one day
   of pickups with one day of dropoffs by ``dwithin`` 0.0005 and ``bbox``
   0.0005 (pairwise tiles), and ``join_spatial`` of each once; ``join_count``
   and ``join_spatial`` of the 10 days with the NTAs (``pip``: interior
   cells wholesale, ``polygon_verdict`` on the boundary cells) and
   ``poly_bbox`` once; ``count``, 512x512 ``density`` and ``stats`` with
   ``region=`` the Bronx; ``explain_join`` of the stations and NTA joins.
   Each call runs cold once and twice warm under the profiler (p50, busy
   and idle share), with its ``JoinStats``. Oracles: the pairs of a
   2,000-row left sample equal the NumPy brute force of those rows
   against the whole right side; every count equals its ``join_spatial``
   pair count; the assignment of a 100k-row sample equals an f32 parity
   oracle; the ``region=`` count, grid and stats equal a NumPy f32 parity
   oracle over the Bronx's parts. The six counters are zeroed before the
   calls and must all be > 0 after; the PIP and grouped density kernels are
   then held against their plain versions on the ``region=`` plan's own
   operands, and each join kernel on the largest operands the calls gave
   it (masks, counts and assignments exact), each timed in turns with its
   plain version, with ``torch.cdist`` as the planar tiles' library
   yardstick.

10. Slice 8, ``density_curve`` and the query-axis batches, on slice 1's
   store right after its checks (no new ingest): the curve of the 10 days
   over CONUS at level 9 (85 x 72 blocks), unweighted and weighted, of a
   1-degree crop at level 12 and of the 64-edge polygon as ``region=``
   (PIP on the path); ``density_curve_batch`` of a 4 x 4 mosaic of
   1-degree level-12 crops; ``density_curve_filter_batch`` of 8 members
   with distinct 5 x 4 degree boxes and 3-day intervals; ``count_batch``
   of 16 distinct 4 x 3 degree boxes with 10-day intervals (placed by the
   seed) and of 5 members sharing the polygon as an ``INTERSECTS``
   residual; ``density_batch`` (256 x 256 over each member's own box,
   unweighted and weighted) and ``stats_batch`` (``Count();MinMax(weight)``)
   of 8 of those members; and a ``DescriptiveStats`` batch, which must
   give None. Each call runs cold once and ``--reps`` warm, and every
   member alone cold once and half as many times warm (at least 3): the
   batch's warm p50 is printed beside the sum of its members'. Every member equals its serial call (counts, unweighted
   grids, curves and sketches exact, weighted grids within rtol 1e-4) and
   every serial result its NumPy f64 oracle (curves binned by the z2
   normalization; weighted curves within rtol 1e-4 plus 16 f32 ulps of the
   largest prefix, the error printed in ulps). PIP is held against its
   plain version on the ``region=`` plan's and the polygon batch's
   operands (timed in turns); one member's scatter is timed with the
   dropped rows' +0.0 in spare cells against the reference's clamped
   cells. Then each call is profiled (busy, idle share, top device work),
   and the phase prints its peak device memory and launches (PIP > 0).
   At the end of slice 5, on its store: ``count_batch`` of 8 boxes over
   B's two partitions, the level-9 curve of B and a curve batch of 4
   crops, each against its serial calls and NumPy oracles.

11. Slice 9, the lake snapshot tier and the data lifecycle. Slice 5's
   store spills lake snapshots (the default); after slice 8's calls on it:
   the smallest partition's snapshot written and fully reloaded in the
   lake and the npz layouts (encode seconds and bytes, decode seconds);
   count, unweighted 512x512 density, the level-9 curve and
   ``stats("Count();MinMax(weight)")`` of a 2 x 2 degree box over B's
   interval and over the long window, and the density of a 30 x 20 degree
   box over two days (its pruned child compacts, so it takes the grouped
   kernel): each cold (after ``spill_all()``: the pushdown-on time from a
   cold store), warm, then with ``geomesa.lake.pushdown`` off from a cold
   store (the long window's off answers in one pass with every partition
   resident),
   with the row groups and bytes loaded of the total and, for a density,
   the kernel each partition took (grouped, einsum or scatter); every answer equal
   to the pushdown-off answer and a NumPy f64 oracle, and row groups
   pruned > 0.
   ``join_count`` of 1,900 NYC stations (a flat schema) with the store by
   ``dwithin`` 0.002 degrees through the window pushdown, equal to the
   NumPy brute force over the right rows in NYC's box, with
   ``JoinStats.pushdown``. Both kernels held against their plain versions
   on a pruned child's operands. Then the lifecycle: ``update_schema``
   adds ``tag:Integer``; ``add_attribute_index`` on it, a count on
   ``attr:tag``, ``remove_attribute_index``; ``delete_features`` of a
   1-degree box over one week; ``age_off`` at 2020-01-09; after each, B's
   count, 512x512 density and the polygon count equal the NumPy oracle over
   the surviving rows. The phase prints its wall, its peak device memory
   and the launches of its own calls, the comparisons with the plain
   versions not counted: both kernels > 0, the grouped density kernel on
   a pruned child and pip on the mutated store. The same lifecycle runs on slice
   1's flat 20M store after slice 6, before that store is freed.

12. Slice 10, durable datasets. On a flat store of its own (slice 1's
   schema and generator, 2,000,000 rows with explicit 128-bit hex ids, a
   cut forced by the time limit) after slice 9's flat lifecycle, once
   the earlier phases' stores have left the card: a full ``save`` (seconds,
   bytes); ``GeoDataset.load`` timed by stage (manifest, chunk reads,
   table rebuild); the main path's four queries on the loaded store, equal
   to the live store's answers and to the slice-1 oracles (counts and the
   unweighted grid exact, the weighted grid within rtol 1e-4); both
   kernels against their plain versions on the loaded store's operands
   (the grouped kernel's built with ``geomesa.density.pallas.max.dup``
   raised: at 2M rows the main density takes the einsum rung); 32 journaled inserts of
   4,096 rows from one writer and 32 from four threads, then 256 of 256
   rows from one writer and 256 from four threads (ack p50, p99 and max,
   fsyncs and group sizes; the threads must share a group commit); an
   incremental ``save`` that writes exactly one new chunk, leaves the old
   chunk files untouched and truncates the journal; a child process (this
   script with ``--s10-child``) that loads the root on the card and
   inserts journaled batches of 256 rows, printing each ack, until the
   parent SIGKILLs it after 256 acks; a fresh ``load`` that replays
   (records replayed and their seconds, the index flush after them apart),
   with every acked batch present and the four
   queries equal to their oracles over the surviving rows; and
   ``refresh_schema`` on a second loaded dataset, which applies exactly
   the 3 records written since and then answers as the writer does. On
   slice 5's store after slice 9's lifecycle: ``save`` (every partition
   checkpointed: dirty residents written, clean snapshots copied; seconds
   and bytes), a one-row insert into one resident partition and a second
   ``save`` that rewrites exactly that partition's snapshot, into a new
   directory, and sweeps the one the first manifest named (by the
   manifest, inode and mtime), ``load`` with every partition attached
   cold, and slice 9's 2°
   box over B and over the long window (count and density), B's polygon
   count and the wide two-day box's density, each equal to the live
   store's answer before the save and to slice 9's oracle over the
   surviving rows, with ``exec_path["lake"]`` and each partition's
   ``density_kernel``. The phase's own launches are counted (the
   comparisons with the plain versions not counted): pip > 0 on the flat
   store, both kernels > 0 on the partitioned one. Its roots are deleted
   when it ends.

13. Slice 11, the aggregate cache (``geomesa.cache.enabled`` scoped on,
   off everywhere else), on slice 1's store right after slice 8, its
   answers first taken with the cache off, each call timed cold (its first
   call in the phase) and warm, and printed beside the cached calls' times
   at the end of the phase: the main box's count cold (10
   level-6 cells and the strips), warm (a whole-result hit, 0 dispatches)
   and panned 2 degrees east (a partial hit); 512x512 densities over a
   fixed CONUS raster of the box (decomposed) and of the pan, weighted
   (whole result only) cold and warm; ``stats`` of
   ``Count();MinMax(weight);Histogram(weight,20,0,2)`` (decomposed) and of
   ``DescriptiveStats(weight)`` (whole result); bench.py's zoom-out at 2
   cells an axis (four quadrants, then the domain) with the hierarchy off
   (the flat arm) and on (the warm arm, which must run 0 device
   dispatches); the 64-edge polygon as ``region=`` at 16 cells an axis,
   count and density cold (interior cells + the boundary scan through pip)
   and warm; a level-9 ``density_curve`` pyramid at 32 cells an axis (two
   overlapping tiles, CONUS at level 9, the level-8 zoom-out served by the
   downsampled chunks, and the polygon's chunk families).
   Every line prints the call's ms, its ``exec.device.dispatch`` delta, the
   cache counters it moved and the cache's exec-path notes; every answer is
   bit-identical to its cache-off answer and equal to its oracle (counts
   f64, grids as in 4, curves binned by the z2 normalization). pip and
   density_grouped must launch in the phase, and are held against their
   plain versions on a boundary scan's points and a cell density's
   schedule. On slice 10's flat store the same zoom-out is warmed and
   ``persist_cache`` written beside the checkpoint, then one 64-row insert
   batch goes into that store, after which the main box's count (one
   whole-result entry at 4 cells an axis) equals the new oracle with a
   cache miss; the loaded dataset's ``restore_cache`` then serves the
   zoom-out with 0 dispatches. On slice
   5's store after slice 10: slice 9's 2-degree box over B, cold, warm and
   panned, and B's polygon count at 2 cells an axis, each equal to cache
   off.

14. Slice 13, the degradation contract and deadlines, no new data. On
   slice 5's store after slice 11's partitioned part, over B's box and
   2020-01-12/2020-01-22 (slice 9's age_off emptied B's first week; this
   window keeps two live weekly partitions): count, the 512x512 density,
   the polygon count, ``Count();MinMax(weight)`` and the level-9 curve
   fault-free, then with the window's second partition failing at
   ``exec.partition.scan``: strict mode raises on each call, under
   ``allow_partial()`` each answer equals the NumPy oracle over the
   surviving partition's rows, and the fault-free answers follow
   unchanged (the count's warm ms healthy and degraded; pip must launch).
   The long window's count under a 1 s ``geomesa.query.timeout``, strict
   and partial: ``QueryTimeoutError``, the partitions scanned and how far
   past the deadline it came. One byte flipped in a spilled partition's
   lake file: a degraded 2-degree count skips the bin and quarantines it,
   the next count skips it with no read of its file, and after the byte is
   restored and ``clear_spill_quarantine`` the count equals the healthy
   one. One row into a partition of its own (January 2021), spilled
   through two transient ``OSError``s at ``index.spill.store``: one write,
   the row read back. On slice 1's flat store, right after slice 11: a 0 ms
   timeout raises on count and density, strict and partial. In slice 7:
   the stations join with its largest tile section failing, under
   ``allow_partial()``, equal to the healthy pairs that the surviving
   sections and brute ranges test.
15. Slice 14, span tracing, the cost ledger, the audit log, guards and
   ``explain``, no new data. On slice 1's flat store right after slice 13's
   0 ms timeout: the main path's four calls (count, the 512x512 density,
   weighted, the polygon count), each run warm untraced and then with
   ``geomesa.trace.enabled``: the traced answer equals the untraced one and
   the oracle-checked one, the trace's preorder span names equal
   ``S14_SPANS`` (which the CPU tests fix for the same calls), and every
   traced launch of pip and density_grouped sits in a ``scan.kernel`` span.
   The count's warm p50 traced against untraced, in turns (the reference's
   ``trace_overhead_pct``; over 5% is logged, not a failure).
   ``explain(analyze=True)`` of the main box: its sections in order and
   ``Matched`` equal to the count. With ``geomesa.audit.path`` in a
   temporary directory and ``geomesa.trace.slow.ms`` 0: one QueryEvent and
   one slow-query tree per call, each with the call's trace id. Under
   ``geomesa.scan.block-full-table`` ``count(INCLUDE)`` raises the
   reference's ``ValueError`` with no dispatch. On slice 5's store, inside
   slice 13's phase: B's traced count has a ``scan.partition`` span per
   partition scanned and the prefetch worker's ``scan.stage`` spans, its
   ``partitions_scanned`` + ``partitions_pruned`` are the store's partitions
   and its ``lake_bytes_read`` the bytes its exec path says it loaded; one
   count with a partition failing under ``allow_partial()``, traced: the
   trace is degraded and one ``DegradationEvent`` names the bin. Both parts
   together must take at most 15 s.
16. Slice 15, the kernel registry, device utilization, trace export,
   breakers, SLO burn and the endpoints, no new data. On slice 1's flat
   store right after slice 14's flat part, with a fresh scan-callable
   registry, tracing on and the file sink of ``tracing_export`` in a
   temporary directory at sample rate ``S15_SAMPLE_RATE`` and seed
   ``S15_SAMPLE_SEED``: the main path's four calls cold, then warm
   ``S15_WARM`` times, each answer equal to the oracle-checked one. The
   registry builds one callable on each call's first run (``kernel`` note
   ``trace``, a ``kernel.recompile`` event) and none on the warm repeats
   (``hit``), and the recompile alert stays 0. Every call's
   ``device_ms.0`` (CUDA events around its dispatch and copy back) is
   above 0 and at most the call's wall. The sink holds exactly the first
   calls (kept as ``recompile``) and the warm calls ``sampled_in`` keeps,
   and each exported OTLP span tree equals the retained finished trace of
   its id. ``S15_PROFILED`` more traced warm calls of each under one
   ``torch.profiler`` session: their ``device_ms.0`` at least 0.9x the
   profiler's busy union (kernels, memcpy, memset) of the calls, which
   must be above 0, and at most their walls. ``device.busy.0`` in (0, 1]. Through
   ``obs.handle``: ``/healthz`` 200 naming the card, 503 while a
   ``trace.otlp`` breaker is forced open, 200 once the breakers are reset;
   ``/metrics`` parses as prometheus text and holds ``kernel_recompiles``,
   ``device_busy_0`` and the trace histograms; ``/debug/devices`` and
   ``/debug/queries?trace=<id>`` answer. One ``obs.serve`` round trip on
   127.0.0.1, port 0. The count's warm p50 untraced, traced with export
   off and traced with export on, in turns, once before the profiler
   sessions and once after the endpoints.
17. Slice 16, the s2 / s3 key spaces, Json attributes, the einsum density
   rung and the call-time knobs, within ``S16_BUDGET_S``, on slice 1's flat
   store after slice 15. Under ``geomesa.density.pallas=false`` the main
   density takes the einsum rung (``density_kernel`` ``mxu-einsum``): its
   unweighted grid bit-equal to the grouped kernel's (and so the oracle's),
   the weighted within rtol 1e-4, at full float32 matmul precision, which
   the phase checks. ``geomesa.compact.b`` scoped to a B other than the
   main path's moves ``exec_path["B"]`` to it with the count and grid
   unchanged; ``geomesa.strategy.decider=first`` moves a bbox + time + ids
   query from the id index to z3 with its count unchanged. An s3 store of
   ``S16_ROWS`` GDELT-like points (``make_data``, 8 shards; cut, each cut
   printed, to no less than ``S16_MIN_ROWS`` when the S2 encode rate of a
   sample says its ingest would pass ``S16_INGEST_S``): ingest seconds with
   the S2 encode and the pack sort apart, the bbox + ``dtg DURING`` count
   and 512x512 density (scatter, as the reference's) and the polygon count
   through ``pip.cu``, each planned on s3 (``explain`` too), warm p50s and
   the ``[S, L]`` device bytes; answers equal the NumPy oracles (the
   polygon's an f32 even-odd one). ``bbox AND jsonPath('$.type') = 'car'``
   over ``S16_JSON_ROWS`` documents against a NumPy oracle. Then, not
   counted: ``pip.cu`` on the s3 store's compacted points against its
   plain version, and the einsum, grouped and scatter rungs on the main
   path's compacted operands in turns, all three grids equal.

18. Slice 17, the serving scheduler and standing queries, within
   ``S17_BUDGET_S``, on slice 1's flat store after slice 16: 8 identical
   main-path counts serial, then fused through ``ds.serving.start()``
   behind a stall ticket (bit-identical, at most 2 dispatches); 8 distinct
   bbox counts and 5 distinct polygon-residual counts fused into query-axis
   batches (``serving.fused.distinct``, equal to serial; the polygon group
   must launch ``pip.cu``); 4 identical 512x512 densities repeat-fused
   (one ``density_grouped.cu`` launch, each grid exact against the serial
   one and its own copy); an expired budget and a full queue refused typed
   with 0 dispatches; a seeded ``serving.slot.loop`` kill and its respawn;
   the queue-wait p99; speculative count, density and stats with 0
   dispatches. Then a fresh ``S17_ROWS``-row flat store of slice 1's shape
   (seed + 17): count and 512x512 density over ``S17_VIEW``, a pyramid and
   ``Count();MinMax(weight)`` over ``S17_VIEW2`` subscribed under
   ``geomesa.subscribe.verify``, ``S17_BATCHES`` inserts of
   ``S17_BATCH_ROWS`` rows and a delete over part of the first viewport;
   after each step every standing result equals a fresh count / density /
   stats on the card and a NumPy oracle (the standing grid maps pixels in
   f64, the card's in f32: each equals its own oracle, the totals agree,
   the differing cells are logged). The host evaluator's delta for one
   batch against one re-scan. The store is dropped at the end.

19. Slice 18, the streaming tier, within ``S18_BUDGET_S``, on stores of
   its own after slice 17: a journaled ``StreamingDataset`` (4 partitions)
   takes a live window of ``S18_LIVE`` AIS-like tracks (``make_data``, seed
   + 1801, explicit event times), written and polled in batches of
   ``S18_BATCH``; the first batch's write and apply rates decide the cuts
   (the cold tier toward ``S18_COLD_FLOOR`` first, then the window toward
   ``S18_LIVE_FLOOR``, each printed). A cold tier of ``S18_COLD_ROWS`` rows
   of slice 1's shape (seed + 18) on the card shares ``S18_SHARED`` fids
   with the window. A standing count and 256x256 density over slice 1's
   box, under ``geomesa.subscribe.verify``, through ``S18_MOVES`` moves, a
   stale update (dropped), ``S18_DELETES`` deletes and a poison message
   (quarantined): each update equals a fresh call and an oracle. Count,
   ``query``, a 512x512 ``density`` on the card and ``Count();MinMax(weight)``
   over slice 1's bbox + ``dtg DURING`` and over its 64-edge polygon, each
   against a NumPy oracle over the live state (grids exact against the f32
   mapping); the density on the card against ``density_grid_np``.
   ``S18_CONFLUENT`` framed-Avro records through ``attach_confluent`` with
   one schema evolution and one tombstone, offsets committed every
   ``S18_COMMIT``; the resume offset. A fresh consumer on the same bus
   recovers the journal: equal caches and offsets, a next poll of 0. Then
   ``LambdaDataset(cold, recovered)``: ``run_persistence`` ages about half
   the window into the cold tier; the merged count, ``query``, f64-mapped
   density and stats equal an oracle in which the hot matches win, the
   polygon count launching ``pip.cu``, and ``pip.cu`` against its plain
   version on the cold tier's operands (not counted). The stores and the
   journal root are dropped at the end.

Output: a ``{"kernels": [...]}`` JSON line (each kernel also carries
``launches_slice8`` to ``launches_slice11`` and ``launches_slice13`` to
``launches_slice18``), the card's ``nvidia-smi``
name/power-limit line, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero. Without a visible CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.metadata
import importlib.util
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


def profile_warm(torch, fn, reps: int, trace_path: Path, warmup: bool = True,
                 walls=None):
    """Profile ``reps`` warm calls (after one more unless ``warmup`` is
    False): (wall ms per call, device-busy ms per call or None when the
    trace holds no device activity, top device kernels by total time,
    device-to-host bytes per call or None when the trace records no copy
    sizes). Busy time is the union of the kernel, memcpy and memset
    intervals of the exported trace. ``walls``, when given, receives each
    call's seconds (synchronized)."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            if walls is not None:
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t1)
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


def density_oracles(data, tm, bbox=None, weight="weight", width=WIDTH, height=HEIGHT):
    """(unweighted, weighted) f64 grids of the rows of ``bbox`` (default
    QUERY_BBOX) that the row mask ``tm`` keeps, with the reference's
    semantics: exact f64 membership; pixel cells computed in f32 op by op,
    except for rows colliding with an f32 bound (the band), which the host
    corrects from f64 values. The grid is ``width`` x ``height`` (default
    512 x 512)."""
    x, y = data["geom__x"], data["geom__y"]
    xmin, ymin, xmax, ymax = QUERY_BBOX if bbox is None else bbox
    m = tm & (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
    x, y, w = x[m], y[m], data[weight][m]
    f = np.float32
    x32, y32 = x.astype(f), y.astype(f)
    band = np.isin(x32, [f(xmin), f(xmax)]) | np.isin(y32, [f(ymin), f(ymax)])
    px = ((x32 - f(xmin)) / f(xmax - xmin) * f(width)).astype(np.int32)
    py = ((y32 - f(ymin)) / f(ymax - ymin) * f(height)).astype(np.int32)
    px = np.where(band, ((x - xmin) / (xmax - xmin) * width).astype(np.int32), px)
    py = np.where(band, ((y - ymin) / (ymax - ymin) * height).astype(np.int32), py)
    idx = np.clip(py, 0, height - 1) * width + np.clip(px, 0, width - 1)
    g = np.bincount(idx, minlength=width * height).astype(np.float64)
    gw = np.bincount(idx, weights=w.astype(np.float64), minlength=width * height)
    # the f64-pixel oracle (tests/test_density_pallas.py) for the record
    px64 = np.clip(((x - xmin) / (xmax - xmin) * width).astype(np.int64), 0, width - 1)
    py64 = np.clip(((y - ymin) / (ymax - ymin) * height).astype(np.int64), 0, height - 1)
    g64 = np.bincount(py64 * width + px64, minlength=width * height)
    return (g.reshape(height, width), gw.reshape(height, width),
            g64.reshape(height, width), int(m.sum()))


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
        knn_paths.clear()
        results[key], cold = timed(torch, fn)
        # 1 warm rep for a call over a million rows or 0.2 s cold (cut from
        # 10 as later slices joined the script)
        reps = 1 if key in heavy or cold > 0.2 else args.reps
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
        # 1 warm rep for a call that refines over 10k rows or whose cold
        # call took over 0.2 s (cut from 10 to fit slices 9-11)
        reps = 1 if path.get("refined_rows", 0) > 10_000 or cold > 0.2 else args.reps
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


# ---------------------------------------------------------------------------
# Slice 7: spatial joins and region aggregates over NYC
# ---------------------------------------------------------------------------

#: about one month of NYC TLC yellow-taxi trips at 2023-24 volume
TRIP_ROWS = 3_000_000
#: NYC Open Data's "Subway Entrances" count
STATION_ROWS = 1_900
#: NYC's 2010 Neighborhood Tabulation Areas
NTA_ROWS = 195
TRIP_SPEC = "fare:Float,dtg:Date,*geom:Point"
TRIP_DAYS = "dtg DURING 2024-01-05T00:00:00Z/2024-01-15T00:00:00Z"
TRIP_DAY = "dtg DURING 2024-01-10T00:00:00Z/2024-01-11T00:00:00Z"
#: taxi demand by area: (lon, lat, sigma lon, sigma lat, share). The
#: shares and spreads are invented, a Manhattan-heavy guess taken from no
#: published table: the cell statistics of the joins over them (pairs per
#: cell, split and brute cells) describe this mixture, not the TLC's data
TRIP_MIX = (
    (-73.985, 40.758, 0.012, 0.012, 0.34),   # Midtown
    (-74.007, 40.714, 0.008, 0.010, 0.15),   # Lower Manhattan
    (-73.966, 40.781, 0.012, 0.016, 0.20),   # Upper East / West Side
    (-73.945, 40.810, 0.010, 0.012, 0.05),   # Harlem
    (-73.779, 40.645, 0.006, 0.004, 0.05),   # JFK
    (-73.873, 40.774, 0.004, 0.003, 0.04),   # LaGuardia
    (-73.960, 40.680, 0.025, 0.020, 0.10),   # Brooklyn
    (-73.880, 40.730, 0.030, 0.020, 0.05),   # Queens
    (-73.890, 40.840, 0.020, 0.020, 0.0185),  # the Bronx
    (-74.140, 40.590, 0.030, 0.030, 0.0005),  # Staten Island
)
#: subway entrances by area: (lon, lat, sigma lon, sigma lat, share);
#: Staten Island's are the Staten Island Railway's
STATION_MIX = (
    (-73.980, 40.755, 0.015, 0.035, 0.36),   # Manhattan
    (-73.950, 40.660, 0.030, 0.030, 0.30),   # Brooklyn
    (-73.850, 40.730, 0.040, 0.025, 0.17),   # Queens
    (-73.880, 40.840, 0.025, 0.025, 0.16),   # the Bronx
    (-74.130, 40.570, 0.040, 0.030, 0.01),   # Staten Island Railway
)


def _mixture(rng, n, mix):
    share = np.array([m[4] for m in mix])
    k = rng.choice(len(mix), n, p=share / share.sum())
    c = np.array([m[:4] for m in mix])[k]
    x = np.clip(c[:, 0] + rng.normal(0, 1, n) * c[:, 2], NYC[0], NYC[2])
    y = np.clip(c[:, 1] + rng.normal(0, 1, n) * c[:, 3], NYC[1], NYC[3])
    return x, y


def make_trips(n: int, seed: int):
    """Taxi trip points over NYC's box: the demand mixture above, a fare
    (log-normal about $15, f32) and ``dtg`` uniform over January 2024."""
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms

    rng = np.random.default_rng(seed)
    x, y = _mixture(rng, n, TRIP_MIX)
    lo = parse_iso_ms("2024-01-01")
    return {"geom__x": x, "geom__y": y,
            "fare": np.exp(rng.normal(np.log(15.0), 0.6, n)).astype(np.float32),
            "dtg": rng.integers(lo, parse_iso_ms("2024-02-01"), n).astype("datetime64[ms]")}


def make_stations(n: int, seed: int):
    rng = np.random.default_rng(seed + 70)
    x, y = _mixture(rng, n, STATION_MIX)
    return {"geom__x": x, "geom__y": y,
            "fare": np.zeros(n, np.float32),
            "dtg": np.full(n, np.datetime64("2024-01-01", "ms"))}


def _star(rng, cx, cy, rx, ry, n, wave=0.12):
    """A star-convex closed ring of n vertices with a few random lobes."""
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = 1 + wave * (np.sin(3 * a + rng.uniform(0, 6)) + 0.5 * np.sin(7 * a + rng.uniform(0, 6)))
    pts = list(zip(np.round(cx + rx * r * np.cos(a), 6), np.round(cy + ry * r * np.sin(a), 6)))
    return tuple(pts + pts[:1])


#: (name, lon, lat, half-width, half-height, shell vertices)
BOROUGHS = (
    ("Manhattan", -73.970, 40.780, 0.030, 0.075, 900),
    ("Bronx", -73.865, 40.850, 0.060, 0.040, 800),
    ("Brooklyn", -73.945, 40.650, 0.070, 0.050, 1000),
    ("Queens", -73.820, 40.705, 0.085, 0.065, 1100),
    ("Staten Island", -74.150, 40.580, 0.070, 0.050, 700),
)


def borough_multipolygons(seed: int):
    """Five borough-like MultiPolygons: a wavy star-convex shell with a
    park-sized hole, and two islands each: about 5,300 edges in all."""
    from geomesa_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(seed + 71)
    out = []
    for _, cx, cy, rx, ry, nv in BOROUGHS:
        shell = _star(rng, cx, cy, rx, ry, nv)
        hole = _star(rng, cx + 0.2 * rx, cy - 0.1 * ry, 0.15 * rx, 0.12 * ry, 48, 0.05)
        islands = [geo.Polygon(_star(rng, cx + s * 1.25 * rx, cy + s * 0.9 * ry,
                                     0.12 * rx, 0.1 * ry, 60, 0.05))
                   for s in (-1.0, 1.0)]
        out.append(geo.MultiPolygon((geo.Polygon(shell, (hole,)), *islands)))
    return out


def nta_wkts(seed: int):
    """195 polygons tiling NYC's box: a 15 x 13 grid whose column widths
    and row heights vary (two wide columns and two tall rows hold the
    large, park- and airport-sized areas), inner nodes jittered, each side
    drawn as 4 collinear segments, so the tiles share their edges."""
    rng = np.random.default_rng(seed + 72)

    def cuts(lo, hi, k, big):
        w = rng.uniform(0.6, 1.4, k)
        w[rng.choice(k, 2, replace=False)] = big
        e = np.concatenate([[0.0], np.cumsum(w / w.sum())])
        return lo + (hi - lo) * e

    xs, ys = cuts(NYC[0], NYC[2], 15, 12.0), cuts(NYC[1], NYC[3], 13, 8.0)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    jx = rng.uniform(-0.2, 0.2, gx.shape) * np.diff(xs).min()
    jy = rng.uniform(-0.2, 0.2, gy.shape) * np.diff(ys).min()
    jx[[0, -1], :], jy[:, [0, -1]] = 0.0, 0.0
    gx, gy = np.round(gx + jx, 6), np.round(gy + jy, 6)

    def side(a, b):
        return [(a[0] + (b[0] - a[0]) * t / 4, a[1] + (b[1] - a[1]) * t / 4) for t in range(4)]

    out = []
    for i in range(15):
        for j in range(13):
            c = [(gx[i, j], gy[i, j]), (gx[i + 1, j], gy[i + 1, j]),
                 (gx[i + 1, j + 1], gy[i + 1, j + 1]), (gx[i, j + 1], gy[i, j + 1])]
            ring = side(c[0], c[1]) + side(c[1], c[2]) + side(c[2], c[3]) + side(c[3], c[0])
            ring.append(ring[0])
            out.append("POLYGON ((" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in ring) + "))")
    return out


#: the join kernels' f32 operations a tested pair (point-edge pair) costs:
#: bbox 2 subtractions, 2 absolutes, 2 compares; dwithin 2 subtractions,
#: 2 products, a sum and a compare; dwithin_meters a third of each
PAIR_OPS = {"bbox": 6, "dwithin": 6, "dwithin_meters": 9}
#: a crossing test: 2 compares and their xor, 4 subtractions, a product, a
#: quotient, a sum and the final compare
CROSS_OPS = 11


#: the functions whose cumulative host time a join call is broken down by
JOIN_HOST_PARTS = (
    "features", "_side_polygons", "co_partition", "_pad_tiles", "_run_slice",
    "_run_brute_slice", "lexsort", "nonzero", "run_polygon_join", "classify_cells",
    "polygon_tables", "_run_poly_slice", "padded_rows", "pip_assign",
)


def host_breakdown(torch, fn, names=JOIN_HOST_PARTS):
    """One warm call under cProfile: (wall ms, {function: cumulative ms})
    for the functions in ``names`` (NumPy's built-ins by their last name)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    out = {}
    for (_, _, func), row in pstats.Stats(prof).stats.items():
        name = func.rstrip(">").split(".")[-1].split(" ")[-1]
        if name in names:
            out[name] = round(out.get(name, 0.0) + row[3] * 1e3, 3)
    return wall, dict(sorted(out.items(), key=lambda kv: -kv[1]))


def y_spans(y, y1, y2) -> int:
    """(point, edge) pairs whose edge y-span holds the point's y: the
    crossing tests that can flip a parity (NaN never counts)."""
    ys = np.sort(np.asarray(y, np.float32).reshape(-1))
    lo = np.searchsorted(ys, np.minimum(y1, y2), side="left")
    hi = np.searchsorted(ys, np.maximum(y1, y2), side="left")
    return int((hi - lo).sum())


def assign_oracle(x32, y32, edges):
    """NumPy f32 parity oracle of ``pip_assign`` (the reference's crossing
    arithmetic, parity per polygon by ``reduceat`` over its contiguous
    edges): the lowest polygon with odd parity, else -1."""
    pid = edges["poly_id"]
    starts = np.flatnonzero(np.r_[True, pid[1:] != pid[:-1]])
    x1, y1, x2, y2 = (edges[k] for k in ("x1", "y1", "x2", "y2"))
    out = np.full(len(x32), -1, np.int64)
    for lo in range(0, len(x32), 2048):
        px, py = x32[lo:lo + 2048, None], y32[lo:lo + 2048, None]
        denom = y2 - y1
        denom = np.where(denom == 0, np.float32(1.0), denom)
        cross = ((y1 > py) != (y2 > py)) & (px < x1 + (py - y1) * (x2 - x1) / denom)
        odd = np.add.reduceat(cross.astype(np.int32), starts, axis=1) % 2 == 1
        out[lo:lo + 2048] = np.where(odd.any(axis=1), pid[starts][odd.argmax(axis=1)], -1)
    return out


def slice7(args, torch, kpip, kgrouped):
    """The slice-7 phase (see the module docstring, 9). Returns the four
    join kernels' entries of the kernels line."""
    from geomesa_tpu_torch import GeoDataset
    from geomesa_tpu_torch.kernels import join as kj
    from geomesa_tpu_torch.utils import geometry as geo

    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    n = args.trip_rows
    if n != TRIP_ROWS:
        log(f"[slice7] cut: {n} trips a side instead of {TRIP_ROWS}")
    t0 = time.perf_counter()
    sides = {"pickups": make_trips(n, args.seed + 10), "dropoffs": make_trips(n, args.seed + 11),
             "stations": make_stations(STATION_ROWS, args.seed)}
    boroughs = borough_multipolygons(args.seed)
    b_wkts = [g.wkt() for g in boroughs]
    ntas = nta_wkts(args.seed)
    log(f"[slice7] generated in {time.perf_counter() - t0:.3f} s: {n} pickups, {n} dropoffs, "
        f"{STATION_ROWS} stations, {len(boroughs)} boroughs "
        f"({sum(len(geo.polygon_edge_buffers(g)['x1']) for g in boroughs)} edges), "
        f"{len(ntas)} NTAs")
    ds = GeoDataset(n_shards=8)
    for name, rows in sides.items():
        ds.create_schema(name, TRIP_SPEC)
        t0 = time.perf_counter()
        ds.insert(name, rows)
        ds.flush(name)
        log(f"[slice7] ingest {name} ({len(rows['fare'])} rows): {time.perf_counter() - t0:.3f} s")
    ds.create_schema("ntas", "nta:String,*geom:Polygon")
    ds.insert("ntas", {"nta": [f"nta{i:03d}" for i in range(len(ntas))],
                       "geom": np.array(ntas, object)})
    ds.flush("ntas")

    # every launch of a join kernel passes through here: the largest
    # operands of each (kernel, predicate) are kept for the check against
    # the plain versions after the calls
    captured = {}
    originals = {k: getattr(kj, k) for k in
                 ("pair_tiles", "pair_flat", "polygon_verdict", "_pip_assign_kernel")}
    #: (kernel name, position of the predicate argument) of each wrapper
    names = {"pair_tiles": ("pair_tiles", 6), "pair_flat": ("pair_flat", 5),
             "polygon_verdict": ("polygon_verdict", 3), "_pip_assign_kernel": ("pip_assign", None)}

    def capture(attr, fn):
        name, at = names[attr]

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            key = (name, None if at is None else a[at])
            size = a[0].numel() * (a[2].shape[-1] if name == "pair_tiles" else 1)
            if key not in captured or captured[key][0] < size:
                captured[key] = (size, a, dict(kw))
            return out
        return wrapped

    for k, fn in originals.items():
        setattr(kj, k, capture(k, fn))
    rng = np.random.default_rng(args.seed + 12)

    def run(label, fn, reps=1):
        """Cold once, then ``reps`` warm calls under the profiler (cut from
        3 to fit slices 10 and 11)."""
        out, cold = timed(torch, fn)
        walls = []
        wall, busy, top, _ = profile_warm(torch, fn, reps, out_dir / f"slice7_{label}.json",
                                          warmup=False, walls=walls)
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        log(f"[slice7] {label}: cold {cold * 1e3:.3f} ms, warm p50 "
            f"{float(np.median(walls)) * 1e3:.3f} ms ({reps} reps), device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms/call'}, idle share {share}, "
            f"top device work (ms/call) {top}")
        return out

    def stats_line(label, st):
        log(f"[slice7] {label} JoinStats: level {st.level}, cells {st.cells_left} left / "
            f"{st.cells_right} right / {st.cells_joint} joint, candidate pairs "
            f"{st.candidate_pairs} of {st.naive_pairs} naive ({st.candidate_fraction:.6f}), "
            f"strip entries {st.strip_entries}, tiles {st.tiles}, strategies "
            f"{st.strategy_cells}, est {st.est_pairs}, dispatched {st.dispatched_pairs}, "
            f"wholesale {st.wholesale_pairs}, matched {st.matched}")

    def side_xy(res):
        g = res._lbatch.columns
        r = res._rbatch.columns
        return g["geom__x"], g["geom__y"], r.get("geom__x"), r.get("geom__y")

    def sample_check(label, res, brute):
        """Pairs of a 2,000-row left sample equal ``brute(rows)``, the
        brute force of those rows against the whole right side."""
        nl = res._lbatch.n
        rows = np.sort(rng.choice(nl, min(2000, nl), replace=False))
        want = brute(rows)
        want = np.stack([rows[want[:, 0]], want[:, 1]], axis=1)
        got = res.pairs[np.isin(res.pairs[:, 0], rows)]
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: sample pairs differ from the brute force "
                                 f"({len(got)} vs {len(want)})")
        log(f"[check] {label}: {len(want)} pairs of a {len(rows)}-row left sample equal the "
            f"brute force against all {res._rbatch.n} right rows")

    kj.reset_launches()
    kpip.launches = 0
    kgrouped.launches = 0
    try:
        # 1. BASELINE #4: pickups over 10 days assigned to the boroughs
        sj = run("spatial_join", lambda: ds.spatial_join("pickups", b_wkts, TRIP_DAYS,
                                                         weight="fare"))
        log(f"[slice7] spatial_join exec_path {ds._plan('pickups', TRIP_DAYS).exec_path}; "
            f"per-borough fare sums {sj[1].tolist()}")
        # 2. pickups within 100 m of a subway entrance (skewed: split and brute)
        kw2 = {"predicate": "dwithin_meters", "distance": 100.0, "left_query": TRIP_DAYS}
        res2 = run("join_stations", lambda: ds.join_spatial("pickups", "stations", **kw2))
        n2 = run("join_count_stations", lambda: ds.join_count("pickups", "stations", **kw2))
        stats_line("stations", res2.stats)
        # 3. pickups and dropoffs of one day, balanced pairwise tiles
        kw3 = {"left_query": TRIP_DAY, "right_query": TRIP_DAY}
        n3d = run("join_count_dwithin", lambda: ds.join_count(
            "pickups", "dropoffs", predicate="dwithin", distance=0.0005, **kw3))
        n3b = run("join_count_bbox", lambda: ds.join_count(
            "pickups", "dropoffs", predicate="bbox", dx=0.0005, dy=0.0005, **kw3))
        res3d, t3d = timed(torch, lambda: ds.join_spatial(
            "pickups", "dropoffs", predicate="dwithin", distance=0.0005, **kw3))
        res3b, t3b = timed(torch, lambda: ds.join_spatial(
            "pickups", "dropoffs", predicate="bbox", dx=0.0005, dy=0.0005, **kw3))
        log(f"[slice7] join_spatial dwithin {t3d * 1e3:.3f} ms, bbox {t3b * 1e3:.3f} ms (once)")
        stats_line("dropoffs dwithin", res3d.stats)
        stats_line("dropoffs bbox", res3b.stats)
        # 4. pickups of 10 days in the NTAs
        kw4 = {"left_query": TRIP_DAYS}
        n4 = run("join_count_nta", lambda: ds.join_count("pickups", "ntas", predicate="pip", **kw4))
        res4 = run("join_nta", lambda: ds.join_spatial("pickups", "ntas", predicate="pip", **kw4))
        n4b, t4b = timed(torch, lambda: ds.join_count("pickups", "ntas", predicate="poly_bbox", **kw4))
        res4b = ds.join_spatial("pickups", "ntas", predicate="poly_bbox", **kw4)
        log(f"[slice7] join_count poly_bbox {t4b * 1e3:.3f} ms (once)")
        stats_line("ntas pip", res4.stats)
        stats_line("ntas poly_bbox", res4b.stats)
        # 5. region= aggregates over one borough (the Bronx: its scan
        # compacts and its density takes the grouped rung)
        region = b_wkts[1]
        hand = f"({TRIP_DAYS}) AND INTERSECTS(geom, {region})"
        rc = run("region_count", lambda: ds.count("pickups", TRIP_DAYS, region=region))
        rd = run("region_density", lambda: ds.density("pickups", TRIP_DAYS, bbox=NYC, width=WIDTH,
                                                      height=HEIGHT, region=region))
        rs = run("region_stats", lambda: ds.stats("pickups", "Count();MinMax(fare)", TRIP_DAYS,
                                                  region=region))
        log(f"[slice7] region exec_path {ds._plan('pickups', hand).exec_path}")
        # 6. explain
        for label, fn in (("stations", lambda: ds.explain_join("pickups", "stations", **kw2)),
                          ("ntas", lambda: ds.explain_join("pickups", "ntas", predicate="pip",
                                                           analyze=True, **kw4))):
            text, t = timed(torch, fn)
            log(f"[slice7] explain_join {label} ({t * 1e3:.3f} ms):")
            for line in text.splitlines():
                log(f"[slice7]   {line}")
    finally:
        for k, fn in originals.items():
            setattr(kj, k, fn)
    launches = dict(kj.launches)
    launches.update(pip=kpip.launches, density_grouped=kgrouped.launches)
    log(f"[slice7] launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of slice 7 never launched: {launches}")
    for label, fn in (
            ("spatial_join", lambda: ds.spatial_join("pickups", b_wkts, TRIP_DAYS, weight="fare")),
            ("join_count_stations", lambda: ds.join_count("pickups", "stations", **kw2)),
            ("join_stations", lambda: ds.join_spatial("pickups", "stations", **kw2)),
            ("join_count_dwithin", lambda: ds.join_count(
                "pickups", "dropoffs", predicate="dwithin", distance=0.0005, **kw3)),
            ("join_count_nta", lambda: ds.join_count("pickups", "ntas", predicate="pip", **kw4))):
        wall, parts = host_breakdown(torch, fn)
        log(f"[slice7] host breakdown of one warm {label} ({wall:.3f} ms under cProfile; "
            f"cumulative ms): {parts}")

    # -- the answers against their oracles ------------------------------------
    t0 = time.perf_counter()
    for label, res, count in (("stations", res2, n2), ("dropoffs dwithin", res3d, n3d),
                              ("dropoffs bbox", res3b, n3b), ("ntas pip", res4, n4),
                              ("ntas poly_bbox", res4b, n4b)):
        if not (count == res.count == len(res.pairs) > 0):
            raise AssertionError(f"{label}: count {count}, join_spatial {res.count} / "
                                 f"{len(res.pairs)} pairs")
    lx, ly, rx, ry = side_xy(res2)
    lu, ru = kj.unit_vectors(lx, ly), kj.unit_vectors(rx, ry)
    p0, p1 = kj.pair_params("dwithin_meters", distance=100.0)
    sample_check("stations", res2, lambda r: kj.brute_force_pairs(
        lu[0][r], lu[1][r], ru[0], ru[1], "dwithin_meters", p0, p1, chunk=256,
        lz=lu[2][r], rz=ru[2]))
    for label, res, pred, kw in (("dropoffs dwithin", res3d, "dwithin", {"distance": 0.0005}),
                                 ("dropoffs bbox", res3b, "bbox", {"dx": 0.0005, "dy": 0.0005})):
        lx, ly, rx, ry = side_xy(res)
        q0, q1 = kj.pair_params(pred, **kw)
        sample_check(label, res, lambda r: kj.brute_force_pairs(
            lx[r], ly[r], rx, ry, pred, q0, q1, chunk=256))
    geoms = [geo.parse_wkt(w) for w in res4._rbatch.columns["geom__wkt"]]
    for label, res, pred in (("ntas pip", res4, "pip"), ("ntas poly_bbox", res4b, "poly_bbox")):
        lx, ly, _, _ = side_xy(res)
        sample_check(label, res, lambda r: kj.polygon_brute_force(lx[r], ly[r], geoms, pred))
    # spatial_join: a 100k-row sample of the table against the f32 oracle
    st = ds._store("pickups")
    plan = ds._plan("pickups", TRIP_DAYS)
    table = st.tables[plan.index_name]
    pick = sides["pickups"]
    rows = np.sort(rng.choice(table.n, min(100_000, table.n), replace=False))
    master = table.order[rows]
    inside = time_mask(pick, "2024-01-05T00:00:00", "2024-01-15T00:00:00")[master]
    flat = geo.MultiPolygon(tuple(q for g in boroughs for q in g.polygons))
    edges = {k: (v.astype(np.float32) if k in ("x1", "y1", "x2", "y2") else v)
             for k, v in geo.polygon_edge_buffers(flat).items()}
    remap = np.repeat(np.arange(len(boroughs)), [len(g.polygons) for g in boroughs])
    want = np.full(len(rows), -1, np.int64)
    a = assign_oracle(pick["geom__x"][master][inside].astype(np.float32),
                      pick["geom__y"][master][inside].astype(np.float32), edges)
    want[inside] = np.where(a >= 0, remap[np.clip(a, 0, None)], -1)
    if not np.array_equal(sj[0][rows], want):
        raise AssertionError(f"spatial_join assignment differs from the f32 oracle on "
                             f"{int((sj[0][rows] != want).sum())} of {len(rows)} sampled rows")
    log(f"[check] spatial_join: {len(rows)} sampled rows equal the f32 parity oracle "
        f"({int((want >= 0).sum())} assigned)")
    # region=: the 10 days' pickups inside the Bronx by a NumPy f32 parity
    # oracle over each part's packed edges (its hole by the even-odd rule)
    rpoly = geo.parse_wkt(region)
    r_tables = [kpip.polygon_edge_tables(p) for p in rpoly.polygons]
    tm = time_mask(pick, "2024-01-05T00:00:00", "2024-01-15T00:00:00")
    in_r = np.zeros(len(tm), bool)
    for (x1, *_), packed in r_tables:
        in_r |= polygon_rows(pick, tm, packed, len(x1))
    want_rc = int(in_r.sum())
    if rc != want_rc or not rc:
        raise AssertionError(f"region count {rc} differs from the f32 parity oracle's {want_rc}")
    g_want = density_oracles(pick, in_r, bbox=NYC, weight="fare")[0]
    if not np.array_equal(rd, g_want):
        raise AssertionError(f"region density differs from the oracle's grid in "
                             f"{int((rd != g_want).sum())} cells")
    fares = pick["fare"][in_r]
    mm = rs.stats[1].value()
    if rs.stats[0].value() != want_rc or (mm["min"], mm["max"]) != (float(fares.min()),
                                                                      float(fares.max())):
        raise AssertionError(f"region stats {rs.value()} differ from the oracle's count "
                             f"{want_rc}, fare {float(fares.min())}..{float(fares.max())}")
    log(f"[check] region: count {rc} ({len(rpoly.polygons)} parts, "
        f"{sum(len(t[0][0]) for t in r_tables)} edges), density and stats equal the f32 parity "
        f"oracle; checks took {time.perf_counter() - t0:.3f} s")
    # slice 13: the stations join degraded, one tile section failing
    s13_join(ds, kw2, res2)

    # the pip and grouped density kernels against their plain versions on
    # the region plan's own operands: its scanned rows against each part's
    # edges, and the region density's grouped schedule
    ex = ds._executor("pickups")
    r_plan = ds._plan("pickups", hand)
    pc = ex.scan_columns(r_plan, ["geom__x", "geom__y"])
    px, py = pc["geom__x"], pc["geom__y"]
    r_edges = [(torch.from_numpy(packed).to(px.device), len(x1)) for (x1, *_), packed in r_tables]

    def region_pip(fn):
        def run():
            out = None
            for e, ne in r_edges:
                m = fn(px, py, e, ne)
                out = m if out is None else out | m
            return out
        return run

    pk, pp = region_pip(kpip.pip_mask), region_pip(kpip.pip_mask_plain)
    bad = int((pk() != pp()).sum())
    p_ms, p_plain, p_turns = in_turns(torch, pk, pp, 20, 3)
    p_work = [pip_work(kpip, py, packed, len(x1)) for (x1, *_), packed in r_tables]
    p_bound = bound(sum(w[0] for w in p_work), sum(w[1] for w in p_work))
    log(f"[kernel] pip on the region plan's {tuple(px.shape)} points x {len(r_edges)} parts: "
        f"{bad} mismatches; in turns (plain, kernel, kernel, plain) ms {p_turns}; bound "
        f"{p_bound[0]:.6f} ms by {p_bound[1]} ({sum(w[2] for w in p_work)} crossing tests)")
    if bad:
        raise AssertionError("pip kernel disagrees with its plain version on the region plan")
    o = ex.density_inputs(r_plan, NYC, WIDTH, HEIGHT)
    if o is None:
        raise AssertionError("the region density did not take the grouped rung")
    a = (o["x"], o["y"], o["mask"], o["weight"], NYC, WIDTH, HEIGHT, o["sched"])
    d_err = float((kgrouped.density_grouped(*a) - kgrouped.density_grouped_plain(*a)).abs().max())
    d_ms, d_plain, d_turns = in_turns(torch, lambda: kgrouped.density_grouped(*a),
                                      lambda: kgrouped.density_grouped_plain(*a), 20, 3)
    d_bound = bound(*density_work(o)[:2])
    log(f"[kernel] density_grouped on the region density's {tuple(o['x'].shape)} rows, "
        f"{o['sched']['chunks'].numel()} pairs: max abs err {d_err}; in turns (plain, kernel, "
        f"kernel, plain) ms {d_turns}; bound {d_bound[0]:.6f} ms by {d_bound[1]}")
    if d_err != 0.0:
        raise AssertionError("density kernel disagrees with its plain version on the region")

    # -- each join kernel against its plain version, at the phase's operands --
    kernels = []
    replaces = {"pair_tiles": "geomesa_tpu/planning/join_exec.py:486",
                "pair_flat": "geomesa_tpu/planning/join_exec.py:532",
                "polygon_verdict": "geomesa_tpu/planning/join_exec.py:938",
                "pip_assign": "geomesa_tpu/processes.py:403"}
    for (name, pred), (_, a, kw) in sorted(captured.items(), key=lambda kv: str(kv[0])):
        lib = None
        if name == "pair_tiles":
            kw = dict(kw, want_mask=True)
            fk = lambda: kj.pair_tiles(*a, **kw)  # noqa: E731
            fp = lambda: kj.pair_tiles_plain(*a, **kw)  # noqa: E731
            (mk, ck), (mp, cp) = fk(), fp()
            err = int((mk != mp).sum()) + int((ck != cp).sum())
            lval, rval = a[4].cpu().numpy().astype(np.int64), a[5].cpu().numpy().astype(np.int64)
            work = int((lval * rval).sum())
            nbytes = sum(t.nbytes for t in a[:6]) + sum(
                t.nbytes for t in (kw.get("lzb"), kw.get("rzb")) if t is not None) \
                + mk.numel() + ck.nbytes
            nops = PAIR_OPS[pred] * work
            shape = f"{a[0].shape[0]} tiles of {a[0].shape[1]} x {a[2].shape[1]}, {work} valid pairs"
            if pred == "dwithin":
                lp = torch.stack([a[0], a[1]], dim=-1)
                rp = torch.stack([a[2], a[3]], dim=-1)
                d = float(np.sqrt(np.float64(a[7])))
                lib = lambda: torch.cdist(lp, rp) <= d  # noqa: E731
        elif name == "pair_flat":
            fk = lambda: kj.pair_flat(*a, **dict(kw, want_mask=True))  # noqa: E731
            fp = lambda: kj.pair_flat_plain(*a, **dict(kw, want_mask=True))  # noqa: E731
            (mk, ck), (mp, cp) = fk(), fp()
            err = int((mk != mp).sum()) + int((ck != cp).sum())
            work = int(a[4])
            nbytes = sum(t.nbytes for t in a[:4]) + sum(
                t.nbytes for t in (kw.get("lzv"), kw.get("rzv")) if t is not None) + mk.numel() + 4
            nops = PAIR_OPS[pred] * work
            shape = f"{a[0].numel()} slots, {work} candidate pairs"
        elif name == "polygon_verdict":
            fk = lambda: kj.polygon_verdict(*a)  # noqa: E731
            fp = lambda: kj.polygon_verdict_plain(*a)  # noqa: E731
            vk, vp = fk(), fp()
            err = int((vk != vp).sum())
            t = a[2]
            ne = int(t["n_edges"])
            y1, y2 = t["y1"][:ne].cpu().numpy(), t["y2"][:ne].cpu().numpy()
            nbytes = a[0].nbytes + a[1].nbytes + sum(
                t[k].nbytes for k in ("x1", "y1", "x2", "y2", "part_id", "part_row", "boxes")) \
                + vk.numel()
            if pred == "pip":
                work = y_spans(a[1].cpu().numpy(), y1, y2)
                nops = CROSS_OPS * work
            else:
                work = a[0].numel() * int(t["n_rows_padded"])
                nops = 4 * work
            shape = f"{a[0].numel()} points x {ne} edges / {t['n_rows_padded']} rows, {work} tests"
        else:  # pip_assign
            fk = lambda: kj._pip_assign_kernel(*a)  # noqa: E731
            fp = lambda: kj.pip_assign_plain(*a)  # noqa: E731
            ak, ap = fk(), fp()
            err = int((ak != ap).sum())
            e = a[3]
            ne = int(e["n_edges"])
            pid = e["poly_id"][:ne].cpu().numpy()
            y1, y2 = e["y1"][:ne].cpu().numpy(), e["y2"][:ne].cpu().numpy()
            m = a[2].reshape(-1).cpu().numpy()
            ys = a[1].reshape(-1).cpu().numpy()[m]
            got = ak.cpu().numpy()[m]
            # a point walks the polygons up to the one it lands in, or all
            work = 0
            for q in range(int(e["n_polys"])):
                sel = pid == q
                walked = (got < 0) | (got >= q)
                work += y_spans(ys[walked], y1[sel], y2[sel])
            nbytes = 9 * ak.numel() + 4 * ak.numel() + sum(
                e[k][:ne].nbytes for k in ("x1", "y1", "x2", "y2", "poly_id"))
            nops = CROSS_OPS * work
            counts_k = np.bincount(ak.cpu().numpy()[m][got >= 0], minlength=int(e["n_polys"]))
            counts_p = np.bincount(ap.cpu().numpy()[m][ap.cpu().numpy()[m] >= 0],
                                   minlength=int(e["n_polys"]))
            if not np.array_equal(counts_k, counts_p):
                raise AssertionError("pip_assign per-polygon counts differ from the plain version's")
            shape = f"{ak.numel()} points ({int(m.sum())} masked) x {ne} edges, {work} span tests"
        torch.cuda.synchronize()
        log(f"[kernel] {name} ({pred}) on {shape}: {err} mismatches")
        if err:
            raise AssertionError(f"{name} ({pred}) disagrees with its plain version: {err}")
        ms, plain_ms, turns = in_turns(torch, fk, fp, 10, 1)
        lib_ms = None if lib is None else cuda_ms(torch, lib, 3)
        b_ms, b_by = bound(nbytes, nops)
        log(f"[kernel] {name} ({pred}) in turns (plain, kernel, kernel, plain) ms: {turns}; "
            f"library {lib_ms}; bound {b_ms:.6f} ms by {b_by} ({nbytes} B, {nops} f32 operations)")
        # the kernels line takes each kernel once: pair_tiles at the planar
        # dwithin tiles (the library's yardstick), pair_flat at the meters
        # join's brute cells, the others at their only operands
        if (name, pred) in (("pair_tiles", "dwithin"), ("pair_flat", "dwithin_meters"),
                            ("polygon_verdict", "pip"), ("pip_assign", None)):
            kernels.append({
                "name": name, "route": "cuda", "source": "geomesa_tpu_torch/csrc/join.cu",
                "replaces": replaces[name], "launches": launches[name], "max_abs_err": float(err),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms,
            })
    if sorted(k["name"] for k in kernels) != sorted(replaces):
        raise AssertionError(f"kernels held: {[k['name'] for k in kernels]}")
    log(f"[slice7] the phase took {time.perf_counter() - t_phase:.3f} s")
    return kernels


PART_SPEC = "weight:Float,dtg:Date,*geom:Point;geomesa.partition='time'"
#: slice 5's rows: cut from BASELINE config #3's 100M so that the whole
#: script keeps within its time limit on the slower card hosts (PERF.md
#: §4); the JAX bench partitions from 50M rows on (bench.py:1082), the
#: least this phase may be cut to
PART_ROWS = 50_000_000
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
    """The slice-5 phase (see the module docstring, 8), then slice 8's,
    slice 9's and slice 10's calls on its store. Returns the launches of
    the kernels in each."""
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
    from geomesa_tpu_torch import config
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
    #: the long window's calls after the cold one: prefetch off. Every
    #: long-window call reloads its partitions (23 against a budget of 4),
    #: so the cold call, prefetch on, is the on sample
    turns = {"count_long": (False,), "density_long": (False,)}

    #: B's additive unweighted calls reload their pruned row groups every
    #: call under the lake default (0.6-1.3 s on the H100)
    pruned = ("count_b", "density_b", "count_polygon_b", "stats_b")

    def reps_of(key):  # kNN's host work runs about a second a call
        if key in pruned:
            return 1  # cut from 2 to fit slice 11
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
            walls = {True: [cold * 1e3], False: []}
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
        log(f"[slice5] {key} prefetch on {walls[True]} ms (the cold call), off "
            f"{walls[False]} ms: mean on "
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
    # a whole partition (pushdown off): the resident child the bound counts
    with config.LAKE_PUSHDOWN.scoped(False):
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
    s8 = slice8_partitioned(args, torch, ds, data, kpip, kgrouped)
    s9, alive = slice9(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)
    s10 = slice10_partitioned(args, torch, ds, data, alive, wkt, packed, n_edges, kpip,
                              kgrouped)
    s11 = slice11_partitioned(torch, ds, data, alive, wkt, packed, n_edges, kpip, kgrouped)
    s13 = slice13(torch, ds, data, alive, wkt, packed, n_edges, kpip, kgrouped)
    return launches, s8, s9, s10, s11, s13


#: slice 8: the curve's full CONUS crop and its level (85 x 72 = 6,120
#: blocks), and the f32 ulps of the largest prefix a weighted block may
#: stray from the f64 oracle beyond rtol 1e-4. The card's scan gives each
#: tile its prefix by a look-back that sums up to 32 predecessor tiles'
#: f32 aggregates in an order set by timing, so the two prefixes of a
#: block carry independent roundings (5.19 and 6.86 ulps in two runs on
#: an H100)
CONUS = (-125.0, 24.0, -66.0, 49.0)
CURVE_ULPS = 16
S8_PROFILE_REPS = 2


def curve_oracle(x, y, w, level, window):
    """f64 block grid of the rows (x, y) (weights ``w``, or counts when
    None) binned by the top ``level`` bits of their z2 normalization."""
    from geomesa_tpu_torch.curves.zorder import Z2SFC

    sfc = Z2SFC()
    ix = (sfc.lon.normalize(x) >> np.uint64(31 - level)).astype(np.int64)
    iy = (sfc.lat.normalize(y) >> np.uint64(31 - level)).astype(np.int64)
    ix0, iy0, ix1, iy1 = window
    m = (ix >= ix0) & (ix <= ix1) & (iy >= iy0) & (iy <= iy1)
    nx, ny = ix1 - ix0 + 1, iy1 - iy0 + 1
    cell = (iy[m] - iy0) * nx + (ix[m] - ix0)
    wt = None if w is None else np.asarray(w, np.float64)[m]
    return np.bincount(cell, weights=wt, minlength=nx * ny).astype(np.float64).reshape(ny, nx)


def curve_check(label, got, want, total=None):
    """Unweighted (``total`` None): exact. Weighted: within rtol 1e-4 plus
    CURVE_ULPS f32 ulps of the largest prefix (``total``, the matches'
    weight). Returns the max abs error and it in ulps."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: grid {got.shape} vs oracle {want.shape}")
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if total is None:
        if err:
            raise AssertionError(f"{label}: {int((got != want).sum())} blocks differ "
                                 "from the oracle")
        return err, 0.0
    ulp = float(np.spacing(np.float32(max(total, 1.0))))
    if not np.allclose(got, want, rtol=1e-4, atol=CURVE_ULPS * ulp):
        raise AssertionError(f"{label}: max abs err {err} beyond rtol 1e-4 + "
                             f"{CURVE_ULPS} ulps ({ulp})")
    return err, err / ulp


def s8_days(i, days):
    """The i-th member's ``days``-long DURING inside January 2020."""
    d0 = 1 + (3 * i) % (31 - days)
    lo, hi = f"2020-01-{d0:02d}T00:00:00", f"2020-01-{d0 + days:02d}T00:00:00"
    return f"dtg DURING {lo}Z/{hi}Z", (lo, hi)


def s8_boxes(rng, m, w, h, lon=(-124.0, -67.0), lat=(25.0, 48.0)):
    """m boxes of w x h degrees placed by ``rng`` inside lon x lat."""
    out = []
    for _ in range(m):
        x0 = round(float(rng.uniform(lon[0], lon[1] - w)), 4)
        y0 = round(float(rng.uniform(lat[0], lat[1] - h)), 4)
        out.append((x0, y0, x0 + w, y0 + h))
    return out


def s8_box_rows(data, box, tm):
    x, y = data["geom__x"], data["geom__y"]
    return tm & (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])


def s8_calls(torch, reps, calls, label, paths=None):
    """Each call cold once and ``reps`` warm: {key: (result, cold ms, warm
    p50 ms)}. ``paths``: {key: the plan whose ``exec_path`` the call
    leaves}, logged after its warm runs."""
    out = {}
    for key, fn in calls.items():
        res, cold = timed(torch, fn)
        warm = [timed(torch, fn)[1] for _ in range(reps)]
        out[key] = (res, cold * 1e3, float(np.median(warm)) * 1e3)
        path = "" if key not in (paths or {}) else \
            f", exec_path {paths[key]().__dict__.get('exec_path')}"
        log(f"[{label}] {key}: cold {cold * 1e3:.3f} ms, warm p50 {out[key][2]:.3f} ms "
            f"({reps} reps){path}")
    return out


def slice8(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped):
    """The slice-8 phase on slice 1's store (see the module docstring, 10).
    Returns this phase's launches of both kernels."""
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.kernels import density as kdensity

    t_phase = time.perf_counter()
    name, reps = "gdelt", args.reps
    rng = np.random.default_rng(args.seed + 8)
    x, y, w = data["geom__x"], data["geom__y"], data["weight"]
    tm = time_mask(data)
    ex = ds._executor(name)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    crop = (-90.0, 38.0, -89.0, 39.0)
    mosaic = [(-92.0 + i, 36.0 + j, -91.0 + i, 37.0 + j) for j in range(4) for i in range(4)]
    fb = [(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {s8_days(i, 3)[0]}", b,
           s8_days(i, 3)[1]) for i, b in enumerate(s8_boxes(rng, 8, 5.0, 4.0))]
    cb = [(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {s8_days(i, 10)[0]}", b,
           s8_days(i, 10)[1]) for i, b in enumerate(s8_boxes(rng, 16, 4.0, 3.0))]
    pb = [(f"INTERSECTS(geom, {wkt}) AND BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) "
           f"AND {DURING}", b) for b in s8_boxes(rng, 5, 6.0, 5.0, (-98.0, -82.0), (31.0, 44.0))]
    db = cb[:8]
    # stats members slot only their interval: at 20M rows nearly every box
    # bound collides with a row's f32 image, and a member with surviving
    # band rows sends a stats batch back to the serial calls (None)
    sb = [(f"weight >= 0.25 AND {s8_days(i, 3)[0]}", s8_days(i, 3)[1]) for i in range(8)]
    fb_q, cb_q, pb_q, db_q, sb_q = ([m[0] for m in g] for g in (fb, cb, pb, db, sb))
    stat = "Count();MinMax(weight)"
    gw = dict(width=256, height=256)

    kpip.launches = 0
    kgrouped.launches = 0
    calls = {
        "curve_conus": lambda: ds.density_curve(name, DURING, level=9, bbox=CONUS),
        "curve_conus_weighted": lambda: ds.density_curve(name, DURING, level=9, bbox=CONUS,
                                                         weight="weight"),
        "curve_crop": lambda: ds.density_curve(name, DURING, level=12, bbox=crop),
        "curve_region": lambda: ds.density_curve(name, DURING, level=9, bbox=QUERY_BBOX,
                                                 region=wkt),
        "curve_batch_4x4": lambda: ds.density_curve_batch(name, DURING, level=12,
                                                          bboxes=mosaic),
        "curve_filter_batch_8": lambda: ds.density_curve_filter_batch(
            name, fb_q, level=12, bboxes=[m[1] for m in fb]),
        "count_batch_16": lambda: ds.count_batch(name, cb_q),
        "count_batch_polygon_5": lambda: ds.count_batch(name, pb_q),
        "density_batch_8": lambda: ds.density_batch(name, db_q, bboxes=[m[1] for m in db], **gw),
        "density_batch_8_weighted": lambda: ds.density_batch(
            name, db_q, bboxes=[m[1] for m in db], weight="weight", **gw),
        "stats_batch_8": lambda: ds.stats_batch(name, stat, sb_q),
        "stats_batch_8_boxes": lambda: ds.stats_batch(name, stat, db_q),
        "stats_batch_descriptive": lambda: ds.stats_batch(name, "DescriptiveStats(weight)", db_q),
    }
    # the region= call plans the polygon folded into the query text
    first = {"curve_region": Query(f"({DURING}) AND INTERSECTS(geom, {wkt})", index="z2"),
             "curve_filter_batch_8": Query(fb_q[0], index="z2"),
             "count_batch_16": cb_q[0], "count_batch_polygon_5": pb_q[0],
             "density_batch_8": db_q[0], "density_batch_8_weighted": db_q[0],
             "stats_batch_8": sb_q[0]}
    res = s8_calls(torch, reps, calls, "slice8",
                   {k: (lambda q=q: ds._plan(name, q)) for k, q in first.items()})
    # the members one at a time, for the batch-against-serial comparison
    serial_calls = {
        "curve_batch_4x4": [lambda b=b: ds.density_curve(name, DURING, level=12, bbox=b)
                            for b in mosaic],
        "curve_filter_batch_8": [lambda m=m: ds.density_curve(name, m[0], level=12, bbox=m[1])
                                 for m in fb],
        "count_batch_16": [lambda q=q: ds.count(name, q) for q in cb_q],
        "count_batch_polygon_5": [lambda q=q: ds.count(name, q) for q in pb_q],
        "density_batch_8": [lambda m=m: ds.density(name, m[0], bbox=m[1], **gw) for m in db],
        "density_batch_8_weighted": [
            lambda m=m: ds.density(name, m[0], bbox=m[1], weight="weight", **gw) for m in db],
        "stats_batch_8": [lambda q=q: ds.stats(name, stat, q) for q in sb_q],
    }
    serial = {}
    for key, fns in serial_calls.items():
        got = [s8_calls(torch, max(3, reps // 2), {i: fn}, "slice8-serial")[i]
               for i, fn in enumerate(fns)]
        serial[key] = ([g[0] for g in got], sum(g[2] for g in got))
        log(f"[slice8] {key}: batch warm p50 {res[key][2]:.3f} ms against the members' "
            f"serial warm p50s summed {serial[key][1]:.3f} ms ({len(fns)} members; "
            f"ratio {res[key][2] / serial[key][1]:.4f})")
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[slice8] launches {launches}; peak device memory {peak} B above the "
        f"{base} B resident before the phase")
    if launches["pip"] <= 0:
        raise AssertionError("pip never launched in slice 8's phase")

    # batch members against their serial calls; a None must have the
    # reference's reason
    if res["stats_batch_descriptive"][0] is not None:
        raise AssertionError("stats_batch with DescriptiveStats must give None")

    def band_rows(queries, agg_cols):
        plans, spec = ds._batch_plans(name, queries)
        return ex._batch_band_rows(plans, ex._batch_setups(plans, spec, agg_cols))

    banded = band_rows(db_q, ["weight"])
    if (res["stats_batch_8_boxes"][0] is None) != banded:
        raise AssertionError("stats_batch_8_boxes: None exactly when a member's scan holds "
                             f"surviving f32 band rows (band rows: {banded})")
    log(f"[slice8] stats_batch_8_boxes: {'None: a member holds surviving band rows, as the '
        'reference' if banded else 'served'}")
    for key in ("count_batch_16", "count_batch_polygon_5"):
        if res[key][0] != serial[key][0]:
            raise AssertionError(f"{key}: {res[key][0]} != serial {serial[key][0]}")
    if res["curve_filter_batch_8"][0] is None:
        if not band_rows([Query(q, index="z2") for q in fb_q], []):
            raise AssertionError("curve_filter_batch_8 gave None without band rows")
        log("[slice8] curve_filter_batch_8: None, a member holds surviving band rows, as "
            "the reference")
        res["curve_filter_batch_8"] = (serial["curve_filter_batch_8"][0],) + \
            res["curve_filter_batch_8"][1:]
    for key in ("curve_batch_4x4", "curve_filter_batch_8"):
        for i, ((g, s), (sg, ss)) in enumerate(zip(res[key][0], serial[key][0])):
            if s != ss or not np.array_equal(g, sg):
                raise AssertionError(f"{key} member {i} differs from its serial call")
    for i, (g, sg) in enumerate(zip(res["density_batch_8"][0], serial["density_batch_8"][0])):
        if not np.array_equal(g, sg):
            raise AssertionError(f"density_batch_8 member {i} differs from its serial call")
    for i, (g, sg) in enumerate(zip(res["density_batch_8_weighted"][0],
                                    serial["density_batch_8_weighted"][0])):
        if not np.allclose(g, sg, rtol=1e-4, atol=1e-3):
            raise AssertionError(f"density_batch_8_weighted member {i} outside rtol 1e-4")
    if [s.to_json() for s in res["stats_batch_8"][0]] != \
            [s.to_json() for s in serial["stats_batch_8"][0]]:
        raise AssertionError("stats_batch_8 differs from its serial calls")

    # serial results against NumPy f64 oracles
    xt, yt, wt = x[tm], y[tm], w[tm]
    errs = {}
    window = ds._snap_blocks(CONUS, 9)[0]
    errs["curve_conus"] = curve_check("curve_conus", res["curve_conus"][0][0],
                                      curve_oracle(xt, yt, None, 9, window))
    total = float(wt.astype(np.float64).sum())
    errs["curve_conus_weighted"] = curve_check(
        "curve_conus_weighted", res["curve_conus_weighted"][0][0],
        curve_oracle(xt, yt, wt, 9, window), total)
    errs["curve_crop"] = curve_check("curve_crop", res["curve_crop"][0][0],
                                     curve_oracle(xt, yt, None, 12, ds._snap_blocks(crop, 12)[0]))
    inside = polygon_rows(data, tm, packed, n_edges)
    errs["curve_region"] = curve_check(
        "curve_region", res["curve_region"][0][0],
        curve_oracle(x[inside], y[inside], None, 9, ds._snap_blocks(QUERY_BBOX, 9)[0]))
    for i, b in enumerate(mosaic):
        curve_check(f"curve_batch_4x4[{i}]", serial["curve_batch_4x4"][0][i][0],
                    curve_oracle(xt, yt, None, 12, ds._snap_blocks(b, 12)[0]))
    for i, (_, b, (lo, hi)) in enumerate(fb):
        r = s8_box_rows(data, b, time_mask(data, lo, hi))
        curve_check(f"curve_filter_batch_8[{i}]", serial["curve_filter_batch_8"][0][i][0],
                    curve_oracle(x[r], y[r], None, 12, ds._snap_blocks(b, 12)[0]))
    for i, (_, b, (lo, hi)) in enumerate(cb):
        want = int(s8_box_rows(data, b, time_mask(data, lo, hi)).sum())
        if serial["count_batch_16"][0][i] != want:
            raise AssertionError(f"count_batch_16 member {i}: {serial['count_batch_16'][0][i]} "
                                 f"!= oracle {want}")
    for i, (_, b) in enumerate(pb):
        want = int(s8_box_rows(data, b, inside).sum())
        if serial["count_batch_polygon_5"][0][i] != want:
            raise AssertionError(f"count_batch_polygon_5 member {i} != f32 oracle {want}")
    for i, (_, b, (lo, hi)) in enumerate(db):
        r = time_mask(data, lo, hi)
        g_u, g_w, _, n_m = density_oracles(data, r, bbox=b, **gw)
        if not np.array_equal(serial["density_batch_8"][0][i].astype(np.float64), g_u):
            raise AssertionError(f"density member {i}: unweighted grid differs from the oracle")
        if not np.allclose(serial["density_batch_8_weighted"][0][i], g_w, rtol=1e-4, atol=1e-3):
            raise AssertionError(f"density member {i}: weighted grid outside rtol 1e-4")
    for i, (_, (lo, hi)) in enumerate(sb):
        got = serial["stats_batch_8"][0][i].stats
        wm = w[time_mask(data, lo, hi) & (w >= np.float32(0.25))]
        want = [len(wm), {"min": float(wm.min()), "max": float(wm.max()),
                          "cardinality": len(wm)}]
        if [got[0].value(), got[1].value()] != want:
            raise AssertionError(f"stats member {i}: {[s.value() for s in got]} != {want}")
    log(f"[check] slice8: every batch member equals its serial call (counts, unweighted "
        f"grids, curves and sketches exact; weighted grids within rtol 1e-4); the serial "
        f"results equal their NumPy f64 oracles (curve max abs err, in f32 ulps of the "
        f"largest prefix: {errs}); DescriptiveStats batch gave None")

    # the +0.0 of rows a batch member's mask drops: the reference's scatter
    # (into the rows' clamped cells) against the port's spare cells
    plans, spec = ds._batch_plans(name, db_q)
    agg = ex._density_cols("weight")
    bs = ex._batch_setups(plans, spec, agg)
    masks = ex._batch_device_agg(plans, spec, bs, lambda m, cols, mm: mm, agg, "mask_batch")
    cols = bs["table"].device_columns(agg)
    mm = masks[0]
    g = torch.from_numpy(kdensity.grid_params(db[0][1])).cuda()
    W = H = 256

    def spare():
        return kdensity.density_grid_at(cols["geom__x"], cols["geom__y"], mm, g[0], g[1],
                                        g[2], g[3], W, H, cols["weight"])

    def clamped():
        px, py = kdensity.pixel_coords(cols["geom__x"].reshape(-1),
                                       cols["geom__y"].reshape(-1), db[0][1], W, H)
        fm = mm.reshape(-1)
        wv = torch.where(fm, cols["weight"].reshape(-1), torch.zeros((), device=fm.device))
        grid = torch.zeros(W * H, dtype=torch.float32, device=fm.device)
        grid.index_add_(0, py.to(torch.int64) * W + px, wv)
        return grid.reshape(H, W)

    if not torch.allclose(spare(), clamped(), rtol=1e-4, atol=1e-3):
        raise AssertionError("the spare-cell scatter disagrees with the clamped one")
    sp_ms, cl_ms, turns = in_turns(torch, spare, clamped, 10, 10)
    log(f"[slice8] one member's weighted 256x256 scatter over {mm.numel()} padded rows "
        f"({int(mm.sum())} masked in): spare cells {sp_ms:.6f} ms, the reference's clamped "
        f"cells {cl_ms:.6f} ms (in turns {turns})")
    del masks, mm, cols

    # pip.cu against its plain version on this phase's operands: the
    # region= curve's z2 plan and the polygon-residual batch's table
    poly_edges = torch.from_numpy(packed).cuda()
    r_plan = ds._plan(name, first["curve_region"])
    p_plans, _ = ds._batch_plans(name, pb_q)
    pip_rec = []
    for label, table in (("region= curve (z2)", ex._table(r_plan)),
                         (f"polygon-residual batch ({p_plans[0].index_name})",
                          ex._table(p_plans[0]))):
        c = table.device_columns(["geom__x", "geom__y"])
        px, py = c["geom__x"], c["geom__y"]
        bad = int((kpip.pip_mask(px, py, poly_edges, n_edges)
                   != kpip.pip_mask_plain(px, py, poly_edges, n_edges)).sum())
        if bad:
            raise AssertionError(f"pip kernel disagrees with its plain version on {bad} points "
                                 f"of the {label}")
        k_ms, p_ms, _ = in_turns(torch, lambda: kpip.pip_mask(px, py, poly_edges, n_edges),
                                 lambda: kpip.pip_mask_plain(px, py, poly_edges, n_edges), 10, 2)
        nb, no, spans = pip_work(kpip, py, packed, n_edges)
        b_ms, by = bound(nb, no)
        pip_rec.append((label, tuple(px.shape), k_ms, p_ms, b_ms, by, spans))
        log(f"[kernel] slice8 pip on the {label}'s {tuple(px.shape)} points x {n_edges} "
            f"edges: 0 mismatches; {k_ms:.6f} ms (plain {p_ms:.6f} ms, bound {b_ms:.6f} ms by "
            f"{by}; {spans} crossing tests)")

    s8_profile(torch, {k: fn for k, fn in calls.items() if res[k][0] is not None})
    log(f"[slice8] the flat phase took {time.perf_counter() - t_phase:.3f} s")
    return launches


def s8_profile(torch, calls):
    """Busy time, idle share and top device work of each call's warm runs."""
    for key, fn in calls.items():
        trace = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke" / f"s8_{key}.json"
        wall, busy, top, _ = profile_warm(torch, fn, S8_PROFILE_REPS, trace)
        trace.unlink(missing_ok=True)
        share = "not measured" if busy is None else f"{1 - busy / wall:.4f}"
        log(f"[profile] slice8 {key}: wall {wall:.4f} ms/call, device busy "
            f"{'not measured' if busy is None else f'{busy:.4f} ms/call'}, idle share "
            f"{share}, top device work (ms/call) {top}")


def slice8_partitioned(args, torch, ds, data, kpip, kgrouped):
    """Slice 8's calls on slice 5's partitioned store: a count batch over
    B's two partitions, the level-9 curve of B and a 4-crop curve batch.
    Returns their launches of both kernels."""
    from geomesa_tpu_torch import Query

    t0 = time.perf_counter()
    name, reps = "gdelt5", args.reps
    rng = np.random.default_rng(args.seed + 85)
    x, y = data["geom__x"], data["geom__y"]
    tm = time_mask(data)
    sub = np.flatnonzero(tm)
    xs, ys = x[sub], y[sub]
    members = [(f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {DURING}", b)
               for b in s8_boxes(rng, 8, 4.0, 3.0, (-100.0, -80.0), (30.0, 45.0))]
    crops = [(-95.0, 33.0, -94.0, 34.0), (-90.0, 40.0, -89.0, 41.0),
             (-84.0, 31.0, -83.0, 32.0), (-99.5, 44.0, -98.5, 45.0)]
    q_b = f"{BOX} AND {DURING}"
    kpip.launches = 0
    kgrouped.launches = 0
    calls = {
        "part_count_batch_8": lambda: ds.count_batch(name, [m[0] for m in members]),
        "part_curve_b": lambda: ds.density_curve(name, q_b, level=9, bbox=QUERY_BBOX),
        "part_curve_batch_4": lambda: ds.density_curve_batch(name, q_b, level=12, bboxes=crops),
    }
    res = s8_calls(torch, reps, calls, "slice8",
                   {"part_count_batch_8": lambda: ds._plan(name, members[0][0]),
                    "part_curve_b": lambda: ds._plan(name, Query(q_b, index="z2"))})
    # B's f32 band rows send its curves to the host (as the reference's):
    # a few warm runs of each member suffice there
    serial = {
        "part_count_batch_8": [s8_calls(torch, max(3, reps // 2),
                                        {0: lambda q=m[0]: ds.count(name, q)},
                                        "slice8-serial")[0] for m in members],
        "part_curve_batch_4": [s8_calls(torch, max(3, reps // 3), {0: lambda b=b: (
            ds.density_curve(name, q_b, level=12, bbox=b))}, "slice8-serial")[0]
            for b in crops],
    }
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    for key, got in serial.items():
        log(f"[slice8] {key}: batch warm p50 {res[key][2]:.3f} ms against the members' "
            f"serial warm p50s summed {sum(g[2] for g in got):.3f} ms")
    if res["part_count_batch_8"][0] != [g[0] for g in serial["part_count_batch_8"]]:
        raise AssertionError("part_count_batch_8 differs from its serial calls")
    for i, ((g, s), got) in enumerate(zip(res["part_curve_batch_4"][0],
                                          serial["part_curve_batch_4"])):
        if s != got[0][1] or not np.array_equal(g, got[0][0]):
            raise AssertionError(f"part_curve_batch_4 crop {i} differs from its serial call")
    for i, (_, b) in enumerate(members):
        want = int(((xs >= b[0]) & (xs <= b[2]) & (ys >= b[1]) & (ys <= b[3])).sum())
        if res["part_count_batch_8"][0][i] != want:
            raise AssertionError(f"part_count_batch_8 member {i} != oracle {want}")
    bx0, by0, bx1, by1 = QUERY_BBOX
    inb = (xs >= bx0) & (xs <= bx1) & (ys >= by0) & (ys <= by1)
    curve_check("part_curve_b", res["part_curve_b"][0][0],
                curve_oracle(xs[inb], ys[inb], None, 9, ds._snap_blocks(QUERY_BBOX, 9)[0]))
    for i, b in enumerate(crops):
        curve_check(f"part_curve_batch_4[{i}]", res["part_curve_batch_4"][0][i][0],
                    curve_oracle(xs[inb], ys[inb], None, 12, ds._snap_blocks(b, 12)[0]))
    s8_profile(torch, calls)
    log(f"[check] slice8 partitioned: batches equal their serial calls, counts and curves "
        f"equal their NumPy oracles; launches {launches}; took "
        f"{time.perf_counter() - t0:.3f} s")
    return launches


#: slice 9: the 2 x 2 degree pushdown box; a wide box over two days of one
#: partition (its pruned child is large enough to compact, so its density
#: takes the grouped kernel); the delete's 1-degree box and week; the
#: age-off cutoff at the end of the second weekly partition (z3 weeks
#: start on Thursdays: 2020-01-02, 2020-01-09, ...); the join's stations
#: and reach (degrees, about 200 m)
S9_BOX = (-91.0, 38.0, -89.0, 40.0)
S9_WIDE = (-110.0, 28.0, -80.0, 48.0)
S9_DAYS = ("2020-01-10T00:00:00", "2020-01-12T00:00:00")
S9_STATS = "Count();MinMax(weight)"
S9_LEVEL = 9
S9_DELETE_BOX = (-95.0, 35.0, -94.0, 36.0)
S9_DELETE_WEEK = ("2020-01-06T00:00:00", "2020-01-12T00:00:00")
S9_AGE_OFF = "2020-01-09T00:00:00"
S9_REACH = 0.002


def s9_query(box, lo, hi) -> str:
    return (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND "
            f"dtg DURING {lo}Z/{hi}Z")


def s9_box_rows(data, box, lo, hi, alive=None):
    x, y = data["geom__x"], data["geom__y"]
    m = (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3]) & time_mask(data, lo, hi)
    return m if alive is None else m & alive


def s9_codec(torch, st, log_prefix="[slice9]"):
    """One partition's snapshot written and reloaded in both layouts:
    encode seconds and bytes of each, and the seconds a full reload takes
    to decode every column."""
    import shutil

    from geomesa_tpu_torch import config

    b = min(st.part_counts, key=st.part_counts.get)  # the phase's size cut
    child = st.child(b)
    child._all.columns.items()  # every column decoded before the timings
    root = Path(st.spill_dir) / "s9_codec"
    out = {}
    for lake in (True, False):
        d = root / ("lake" if lake else "npz")
        with config.LAKE_ENABLED.scoped(lake):
            t0 = time.perf_counter()
            st._write_snapshot(child, str(d))
            enc = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in d.iterdir())
        t0 = time.perf_counter()
        loaded = st._load_snapshot(str(d))
        cols = dict(loaded._all.columns.items())
        keys = dict(loaded._key_cols.items())
        dec = time.perf_counter() - t0
        out["lake" if lake else "npz"] = (enc, size, dec, len(cols) + len(keys))
    shutil.rmtree(root, ignore_errors=True)
    log(f"{log_prefix} snapshot of partition {b} ({st.part_counts[b]} rows): "
        + "; ".join(f"{k} encode {v[0]:.3f} s, {v[1]} B on disk, full reload decoding "
                    f"{v[3]} columns {v[2]:.3f} s" for k, v in out.items()))
    return out


def s9_pushdown(args, torch, ds, data, name, st):
    """Count, unweighted density, unweighted curve and stats of three
    windows with pushdown on: cold (after spill_all; the on timing from a
    cold store) and warm, then off from a cold store, each answer equal to
    the others and to a NumPy oracle; the row groups and bytes each
    loaded."""
    from geomesa_tpu_torch import Query, config

    x, y, w = data["geom__x"], data["geom__y"], data["weight"]
    # the long window's pushdown-off answers come from one pass with every
    # partition resident (a cold off call reloads every whole partition,
    # about 40 s on the H100), so only its count times off against on
    windows = {
        "box_b": (S9_BOX, "2020-01-05T00:00:00", "2020-01-15T00:00:00", 2, (False,)),
        "box_long": (S9_BOX, LONG_LO, LONG_HI, 1, ()),
        "wide_2d": (S9_WIDE, S9_DAYS[0], S9_DAYS[1], 1, (False,)),
    }
    #: the wide window serves the grouped kernel on a pruned child: its
    #: density alone
    only = {"wide_2d": ("density",)}
    rows = []
    for wname, (box, lo, hi, reps, turns) in windows.items():
        q = s9_query(box, lo, hi)
        m = s9_box_rows(data, box, lo, hi)
        wm = w[m]
        g_u = density_oracles(data, time_mask(data, lo, hi), bbox=box)[0]
        window, _ = ds._snap_blocks(box, S9_LEVEL)
        oracle = {
            "count": int(m.sum()),
            "density": g_u,
            "curve": curve_oracle(x[m], y[m], None, S9_LEVEL, window),
            "stats": [int(m.sum()), {"min": float(wm.min()), "max": float(wm.max()),
                                     "cardinality": len(wm)}],
        }
        ops = {
            "count": (q, lambda q=q: ds.count(name, q)),
            "density": (q, lambda q=q, box=box: ds.density(
                name, q, bbox=box, width=WIDTH, height=HEIGHT)),
            "curve": (Query(q, index="z2"), lambda q=q, box=box: ds.density_curve(
                name, q, level=S9_LEVEL, bbox=box)[0]),
            "stats": (q, lambda q=q: [s.value() for s in ds.stats(name, S9_STATS, q).stats]),
        }
        answers, off_walls = {}, {}
        for op, (pq, fn) in ops.items():
            if op not in only.get(wname, ops):
                continue
            st.spill_all()
            got, cold = timed(torch, fn)
            answers[op] = got
            plan = ds._plan(name, pq)
            # the call's audit event carries its lake account
            acct = dict(ds.audit.recent(1)[0].hints.get("lake") or {})
            path = dict(plan.exec_path)
            warm = [timed(torch, fn)[1] * 1e3 for _ in range(reps)]
            # the cold call is the pushdown-on call from a cold store
            walls = {True: [cold * 1e3], False: []}
            for on in turns:
                st.spill_all()
                with config.LAKE_PUSHDOWN.scoped(on):
                    ans, sec = timed(torch, fn)
                walls[on].append(sec * 1e3)
                if not s9_same(op, ans, got):
                    raise AssertionError(f"{wname} {op}: pushdown {'on' if on else 'off'} "
                                         "disagrees with the cold call")
            off_walls[op] = walls
            want = oracle[op]
            same = (got == want) if op in ("count", "stats") else (
                got.shape == want.shape and np.array_equal(got.astype(np.float64), want))
            if not same:
                raise AssertionError(f"{wname} {op}: answer differs from the NumPy oracle")
            if not acct.get("groups_pruned"):
                raise AssertionError(f"{wname} {op}: no row group was pruned ({path})")
            rows.append((wname, op, cold * 1e3, float(np.median(warm)), walls, acct))
            kern = "" if op != "density" else "; density kernel by partition " + str(
                {k: [b for b, p in path["partitions"].items() if p.get("density_kernel") == k]
                 for k in ("grouped", "mxu-einsum", "scatter")})
            log(f"[slice9] {wname} {op}: cold {cold * 1e3:.3f} ms, warm p50 "
                f"{np.median(warm):.3f} ms ({reps} reps); from a cold store: on (the cold "
                f"call) {walls[True]} ms, off "
                f"{walls[False]} ms; row groups loaded {acct['groups_loaded']}/"
                f"{acct['groups_total']}, bytes {acct['bytes_loaded']}/"
                f"{acct['bytes_payload']}; exec_path lake {path.get('lake')!r}, fallback "
                f"{path.get('lake_fallback')!r}, partitions scanned "
                f"{path.get('partitions_scanned')}{kern}; equal to the NumPy oracle")
        if wname == "box_long":
            # the pushdown-off answers in one pass with every partition
            # resident: the first (count) reloads every whole partition
            # from a cold store, the others reuse them
            st.spill_all()
            budget = st.max_resident
            st.max_resident = len(st.partition_bins())
            try:
                with config.LAKE_PUSHDOWN.scoped(False):
                    for op, (_, fn) in ops.items():
                        ans, sec = timed(torch, fn)
                        off_walls[op][False].append(sec * 1e3)
                        if not s9_same(op, ans, answers[op]):
                            raise AssertionError(f"{wname} {op}: pushdown off disagrees")
            finally:
                st.max_resident = budget
                st.evict()  # back to the budget (clean partitions: no rewrite)
            log(f"[slice9] {wname} pushdown off, every partition resident, in order "
                f"{list(ops)}: {[off_walls[op][False][0] for op in ops]} ms (the first "
                "from a cold store); each equal to its pushdown-on answer")
    return rows


def s9_same(op, a, b) -> bool:
    return a == b if op in ("count", "stats") else np.array_equal(a, b)


def s9_join(args, torch, ds, data, name):
    """join_count of 1,900 NYC stations (a flat left side) with the
    partitioned store by dwithin: the right side streams through the lake
    window; the count equals a NumPy brute force."""
    from geomesa_tpu_torch.kernels import join as kjoin

    stations = make_stations(STATION_ROWS, args.seed)
    ds.create_schema("stations9", TRIP_SPEC)
    ds.insert("stations9", stations)
    ds.flush("stations9")
    st = ds._store(name)
    st.spill_all()
    kw = dict(predicate="dwithin", distance=S9_REACH)
    # the pushdown count's JoinStats, kept from the call itself
    real, got = ds._join_pushdown_count, []

    def keep(*a, **k):
        got.append(real(*a, **k))
        return got[-1]

    ds._join_pushdown_count = keep
    try:
        n, cold = timed(torch, lambda: ds.join_count("stations9", name, **kw))
    finally:
        del ds._join_pushdown_count
    if not got:
        raise AssertionError("the join count did not take the pushdown path")
    stats = got[0][3]
    x, y = data["geom__x"], data["geom__y"]
    pad = 0.01
    near = np.flatnonzero((x >= NYC[0] - pad) & (x <= NYC[2] + pad)
                          & (y >= NYC[1] - pad) & (y <= NYC[3] + pad))
    p0, p1 = kjoin.pair_params("dwithin", distance=S9_REACH)
    brute = len(kjoin.brute_force_pairs(stations["geom__x"], stations["geom__y"],
                                        x[near], y[near], "dwithin", p0, p1))
    if not n == stats.matched == brute:
        raise AssertionError(f"join pushdown count {n} / {stats.matched} != brute force {brute}")
    if not stats.pushdown or not stats.pushdown.get("chunks"):
        raise AssertionError("the join count did not take the pushdown path")
    log(f"[slice9] join_count stations9 x {name} by dwithin {S9_REACH}: {n} pairs "
        f"(NumPy brute force over the {len(near)} right rows in NYC's box: {brute}); cold "
        f"{cold * 1e3:.3f} ms; JoinStats.pushdown {stats.pushdown}; "
        f"cells joint {stats.cells_joint}, candidate pairs {stats.candidate_pairs}, "
        f"right rows scanned {stats.n_right}")
    ds.delete_schema("stations9")
    return n


def s9_lifecycle(args, torch, ds, data, name, label, wkt, packed, n_edges):
    """update_schema, an attribute index on the new column (added, queried,
    removed), delete_features of a 1-degree box over one week and age_off
    at the end of the second week; after each, the bbox + time count, the
    512x512 density and the polygon count equal the NumPy oracle over the
    surviving rows."""
    from geomesa_tpu_torch import Query

    st = ds._store(name)
    alive = np.ones(len(data["dtg"]), bool)
    q_b = f"{BOX} AND {DURING}"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    grid = dict(bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
    walls = {}

    # the oracles' rows: those of B's interval, once
    sub = np.flatnonzero(time_mask(data))
    part = {k: v[sub] for k, v in data.items()}
    in_poly = polygon_rows(part, np.ones(len(sub), bool), packed, n_edges)

    def check(step):
        keep = alive[sub]
        g_u, _, _, n_b = density_oracles(part, keep)
        got = (ds.count(name, q_b), ds.density(name, q_b, **grid), ds.count(name, q_poly))
        want_p = int((in_poly & keep).sum())
        if got[0] != n_b or not np.array_equal(got[1].astype(np.float64), g_u) \
                or got[2] != want_p:
            raise AssertionError(f"{label} after {step}: count {got[0]} (oracle {n_b}), "
                                 f"polygon {got[2]} (oracle {want_p}), grid equal "
                                 f"{np.array_equal(got[1].astype(np.float64), g_u)}")
        log(f"[slice9] {label} after {step} ({walls[step]:.3f} s): count {n_b}, polygon "
            f"{want_p} and the grid equal the oracle over {int(alive.sum())} surviving rows; "
            f"exec_path {dict(ds._plan(name, q_b).exec_path)}")

    def step(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        return out

    step("update_schema", lambda: ds.update_schema(name, "tag:Integer"))
    check("update_schema")
    step("add_attribute_index", lambda: ds.add_attribute_index(name, "tag"))
    q_tag = Query(f"tag = 0 AND {DURING}", index="attr:tag")
    n_tag = step("attribute_query", lambda: ds.count(name, q_tag))
    plan = ds._plan(name, q_tag)
    if n_tag != int(time_mask(data).sum()) or plan.index_name != "attr:tag":
        raise AssertionError(f"{label} attribute query: {n_tag} rows on {plan.index_name}")
    log(f"[slice9] {label} add_attribute_index {walls['add_attribute_index']:.3f} s; "
        f"count of tag = 0 over B's interval on attr:tag {n_tag} ({walls['attribute_query']:.3f}"
        f" s), exec_path {dict(plan.exec_path)}")
    step("remove_attribute_index", lambda: ds.remove_attribute_index(name, "tag"))
    check("remove_attribute_index")
    gone = s9_box_rows(data, S9_DELETE_BOX, *S9_DELETE_WEEK, alive)
    n_del = step("delete_features", lambda: ds.delete_features(
        name, s9_query(S9_DELETE_BOX, *S9_DELETE_WEEK)))
    if n_del != int(gone.sum()) or not n_del:
        raise AssertionError(f"{label} delete_features removed {n_del}, oracle {int(gone.sum())}")
    alive &= ~gone
    check("delete_features")
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms

    old = (data["dtg"].astype(np.int64) < parse_iso_ms(S9_AGE_OFF)) & alive
    n_age = step("age_off", lambda: ds.age_off(name, S9_AGE_OFF + "Z"))
    if n_age != int(old.sum()) or not n_age:
        raise AssertionError(f"{label} age_off removed {n_age}, oracle {int(old.sum())}")
    alive &= ~old
    check("age_off")
    log(f"[slice9] {label} lifecycle: removed {n_del} by delete_features, {n_age} by age_off; "
        f"step walls (s) {walls}" + (f"; spills {st.spills}, loads {st.loads}"
                                    if hasattr(st, "spills") else ""))
    return alive


def s9_kernels_on_pruned(torch, ds, name, st, wkt, packed, n_edges, kpip, kgrouped):
    """Both kernels against their plain versions on a pruned ephemeral
    child's operands: the wide two-day window's density (its child
    compacts) and the polygon count's point columns."""
    ex = ds._executor(name)
    out = {}
    q_wide = s9_query(S9_WIDE, *S9_DAYS)
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    for key, q in (("density_grouped", q_wide), ("pip", q_poly)):
        st.spill_all()
        plan = ds._fresh_plan(name, q)
        window = ex._push_window(plan)
        b = ex.prune(plan)[-1]
        child = st.scan_child(b, window)
        if child is None or child.lake_note is None:
            raise AssertionError(f"{key}: partition {b} did not load pruned")
        cex = ex._executor_for(b, child)
        note = child.lake_note
        if key == "density_grouped":
            o = cex.density_inputs(plan, S9_WIDE, WIDTH, HEIGHT)
            if o is None:
                raise AssertionError("the pruned child's density did not take the grouped rung")
            a = (o["x"], o["y"], o["mask"], o["weight"], S9_WIDE, WIDTH, HEIGHT, o["sched"])
            if not torch.equal(kgrouped.density_grouped(*a), kgrouped.density_grouped_plain(*a)):
                raise AssertionError("density kernel disagrees with its plain version on a "
                                     "pruned child")
            ms, plain, _ = in_turns(torch, lambda: kgrouped.density_grouped(*a),
                                    lambda: kgrouped.density_grouped_plain(*a), 20, 3)
            shape = f"{tuple(o['x'].shape)} rows, {o['sched']['chunks'].numel()} pairs"
        else:
            pc = cex.scan_columns(plan, ["geom__x", "geom__y"])
            px, py = pc["geom__x"], pc["geom__y"]
            edges = torch.from_numpy(packed).cuda()
            bad = int((kpip.pip_mask(px, py, edges, n_edges)
                       != kpip.pip_mask_plain(px, py, edges, n_edges)).sum())
            if bad:
                raise AssertionError(f"pip kernel disagrees with its plain version on {bad} "
                                     "points of a pruned child")
            ms, plain, _ = in_turns(torch, lambda: kpip.pip_mask(px, py, edges, n_edges),
                                    lambda: kpip.pip_mask_plain(px, py, edges, n_edges), 20, 3)
            shape = f"{tuple(px.shape)} points"
        out[key] = (ms, plain)
        log(f"[slice9] {key} on partition {b}'s pruned child ({note['groups_loaded']}/"
            f"{note['groups_total']} row groups, {child.count} rows; {shape}): {ms:.6f} ms, "
            f"plain {plain:.6f} ms; equal to its plain version")
        child.drop_device()
        ex._execs.pop(b, None)
    return out


def slice9(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped, name="gdelt5"):
    """The slice-9 phase on slice 5's partitioned store (see the module
    docstring, 11). Returns this phase's launches of every kernel and the
    rows that survive its lifecycle."""
    from geomesa_tpu_torch.kernels import join as kjoin

    t_phase = time.perf_counter()
    st = ds._store(name)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kpip.launches = 0
    kgrouped.launches = 0
    kjoin.reset_launches()

    def counts():
        return {"pip": kpip.launches, "density_grouped": kgrouped.launches, **kjoin.launches}

    s9_codec(torch, st)
    s9_pushdown(args, torch, ds, data, name, st)
    after_push = counts()
    s9_join(args, torch, ds, data, name)
    # the comparisons with the plain versions launch the kernels too: not
    # the phase's own calls, so the counts are put back after them
    held = counts()
    s9_kernels_on_pruned(torch, ds, name, st, wkt, packed, n_edges, kpip, kgrouped)
    kpip.launches, kgrouped.launches = held.pop("pip"), held.pop("density_grouped")
    kjoin.launches.update(held)
    before_life = counts()
    alive = s9_lifecycle(args, torch, ds, data, name, "partitioned", wkt, packed, n_edges)
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    life = {k: v - before_life[k] for k, v in launches.items()}
    log(f"[slice9] partitioned phase: {time.perf_counter() - t_phase:.3f} s, peak device "
        f"memory {peak} B above the {base} B before it; launches of its own calls {launches} "
        f"(pushdown {after_push}, lifecycle {life}; the comparisons with the plain versions "
        "not counted)")
    if min(launches["pip"], launches["density_grouped"]) <= 0:
        raise AssertionError(f"a kernel never launched in slice 9's phase: {launches}")
    if after_push["density_grouped"] <= 0 or life["pip"] <= 0:
        raise AssertionError("the grouped density kernel never ran on a pruned child "
                             f"({after_push}) or pip never ran on the mutated store ({life})")
    return launches, alive


def slice9_flat(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped):
    """Slice 9's lifecycle on slice 1's flat store. Returns its launches."""
    t0 = time.perf_counter()
    kpip.launches = 0
    kgrouped.launches = 0
    s9_lifecycle(args, torch, ds, data, "gdelt", "flat", wkt, packed, n_edges)
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    log(f"[slice9] flat lifecycle: {time.perf_counter() - t0:.3f} s; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in slice 9's flat lifecycle: {launches}")
    return launches


#: slice 10: the flat store's rows (a cut forced by the time limit, PERF.md
#: section 4), the journaled inserts (count and rows each; half from one
#: writer, half from the writer threads), the small journaled inserts (rows
#: each, and acks per writer mode: enough for a p99), the writer threads,
#: the child's acked small batches after which the parent kills it, and the
#: batches the second dataset catches up on
S10_ROWS = 2_000_000
S10_INSERTS = 64
S10_BATCH = 4096
S10_SMALL = 256
S10_SMALL_ACKS = 256
S10_THREADS = 4
S10_KILL_AFTER = 256
S10_REFRESH = 3
S10_SPEC = "weight:Float,dtg:Date,*geom:Point"
#: geomesa.density.pallas.max.dup for the grouped kernel's operands on the
#: flat store (its main density scatters at 2M rows)
S10_MAX_DUP = 64.0
#: the one-row insert into a resident partition lies outside every window
#: the phase queries
S10_ROW_XY = (-124.5, 48.5)
#: a lake partition snapshot's data file
SNAP = "part.lake"


def hex_fids(rng, n: int) -> np.ndarray:
    """``n`` random 128-bit hex feature ids ('S32'), the form of the
    port's default ids, made from ``rng``."""
    b = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    h = np.empty((n, 32), np.uint8)
    h[:, 0::2], h[:, 1::2] = digits[b >> 4], digits[b & 15]
    return h.view("S32").reshape(n)


def s10_batch(i: int, seed: int, rows: int = S10_BATCH, tag: str = "j"):
    """Journaled insert batch ``i`` of ``rows`` rows: slice 1's generator,
    ids ``<tag><i>_<row>``."""
    data = make_data(rows, seed + 1000 + i)
    return data, np.char.add(f"{tag}{i}_".encode(), np.arange(rows).astype("S6"))


def s10_child_batch(i: int, seed: int):
    """The crash child's journaled batch ``i`` (small, ids ``k<i>_<row>``)."""
    return s10_batch(i, seed + 7, S10_SMALL, "k")


def s10_acks(ds, name, batches, threads: int):
    """Insert ``batches`` into ``name`` from ``threads`` writer threads (1:
    this thread); each insert's ack seconds and the journal's counters
    over the run."""
    import threading

    j = ds._journal
    c0 = j.counters()
    acks, errors = [], []
    lock = threading.Lock()

    def writer(mine):
        try:
            for bdata, bfids in mine:
                t0 = time.perf_counter()
                ds.insert(name, bdata, fids=bfids)
                with lock:
                    acks.append(time.perf_counter() - t0)
        except BaseException as e:  # re-raised below
            errors.append(e)

    if threads == 1:
        writer(batches)
    else:
        ts = [threading.Thread(target=writer, args=(batches[k::threads],))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    if errors:
        raise errors[0]
    c1 = j.counters()
    groups = {k: c1["groups"].get(k, 0) - c0["groups"].get(k, 0) for k in c1["groups"]}
    return acks, {"fsyncs": c1["fsyncs"] - c0["fsyncs"],
                  "groups": {k: v for k, v in groups.items() if v}}


def s10_dir_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def s10_child(root: str, seed: int) -> int:
    """The crash child: load the root on the card, then insert journaled
    batches, printing ``ACK <i>`` once each returns, until killed."""
    import torch

    from geomesa_tpu_torch import GeoDataset

    if not torch.cuda.is_available():
        return 2
    ds = GeoDataset.load(root)
    log(f"LOADED {ds.count('gdelt10')}")
    for i in range(100_000):
        data, fids = s10_child_batch(i, seed)
        ds.insert("gdelt10", data, fids=fids)
        log(f"ACK {i}")
    return 0


def s10_save_split(seed: int) -> int:
    """Where the slice-10 flat save's time goes: save the phase's store
    (the same rows and ids) once, then compress each column of its chunk
    alone as ``np.savez_compressed`` does."""
    import shutil

    import torch

    from geomesa_tpu_torch import GeoDataset

    if not torch.cuda.is_available():
        return 2
    root = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke" / "s10_split"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed + 10)
    data = make_data(S10_ROWS, seed + 10)
    try:
        ds = GeoDataset(n_shards=8)
        ds.create_schema("gdelt10", S10_SPEC)
        ds.insert("gdelt10", data, fids=hex_fids(rng, S10_ROWS))
        ds.flush("gdelt10")
        t0 = time.perf_counter()
        ds.save(str(root))
        save_s = time.perf_counter() - t0
        entry = json.loads((root / "manifest.json").read_text())["schemas"]["gdelt10"]
        split = {}
        with np.load(root / entry["chunks"][0]) as z:
            for k in z.files:
                col = z[k]
                path = root / "split.npz"
                t0 = time.perf_counter()
                np.savez_compressed(path, col)
                split[k] = (round(time.perf_counter() - t0, 3), col.nbytes,
                            path.stat().st_size)
        log(f"[slice10] flat save of {S10_ROWS} rows: {save_s:.3f} s; by column (s, raw B, "
            f"compressed B): {split}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def s10_queries(ds, name, q_bbox, q_poly):
    """The main path's four queries on ``name``."""
    grid = dict(bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
    return {
        "count_bbox": ds.count(name, q_bbox),
        "density": ds.density(name, q_bbox, **grid),
        "density_weighted": ds.density(name, q_bbox, weight="weight", **grid),
        "count_polygon": ds.count(name, q_poly),
    }


def s10_check(label, got, want, oracle=None):
    """Counts and the unweighted grid bit for bit, the weighted grid within
    rtol 1e-4, against ``want`` (the live store's answers) and the slice-1
    ``oracle`` (count, unweighted grid, weighted grid, polygon count)."""
    for ref_name, ref in (("live", want), ("oracle", oracle)):
        if ref is None:
            continue
        if got["count_bbox"] != ref["count_bbox"] or got["count_polygon"] != ref["count_polygon"]:
            raise AssertionError(f"{label}: counts {got['count_bbox']} / {got['count_polygon']} "
                                 f"!= {ref_name} {ref['count_bbox']} / {ref['count_polygon']}")
        if not np.array_equal(got["density"].astype(np.float64), ref["density"]):
            raise AssertionError(f"{label}: unweighted grid differs from the {ref_name} grid")
        gw, rw = got["density_weighted"], ref["density_weighted"]
        if not (np.isfinite(gw).all() and np.allclose(gw, rw, rtol=1e-4, atol=1e-3)):
            raise AssertionError(f"{label}: weighted grid outside rtol 1e-4 of the {ref_name}")


def s10_oracle(data, packed, n_edges):
    tm = time_mask(data)
    g_u, g_w, _, n_bbox = density_oracles(data, tm)
    return {"count_bbox": n_bbox, "density": g_u, "density_weighted": g_w,
            "count_polygon": polygon_oracle(data, tm, packed, n_edges)}


def s10_concat(parts):
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def slice10_flat(args, torch, wkt, packed, n_edges, kpip, kgrouped):
    """The slice-10 phase on a flat store of its own (see the module
    docstring, 12). Returns its launches of both kernels."""
    import shutil
    import signal

    from geomesa_tpu_torch import GeoDataset, config

    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    root = out_dir / "s10_flat"
    s11_cache = out_dir / "s11_cache"
    for d in (root, s11_cache):
        shutil.rmtree(d, ignore_errors=True)
    s11_cache.mkdir(parents=True)
    name = "gdelt10"
    q_bbox = f"BBOX(geom, {', '.join(str(v) for v in QUERY_BBOX)}) AND {DURING}"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    rng = np.random.default_rng(args.seed + 10)
    data = make_data(S10_ROWS, args.seed + 10)
    fids = hex_fids(rng, S10_ROWS)
    try:
        ds = GeoDataset(n_shards=8)
        ds.create_schema(name, S10_SPEC)
        ds.insert(name, data, fids=fids)
        ds.flush(name)
        live = s10_queries(ds, name, q_bbox, q_poly)
        oracle = s10_oracle(data, packed, n_edges)
        s10_check("the live store", live, None, oracle)

        # 1. a full save
        t0 = time.perf_counter()
        ds.save(str(root))
        save_s = time.perf_counter() - t0
        size = s10_dir_bytes(root)
        entry = json.loads((root / "manifest.json").read_text())["schemas"][name]
        log(f"[slice10] flat save of {S10_ROWS} rows: {save_s:.3f} s "
            f"({save_s / S10_ROWS * 1e6:.3f} s per million rows), {size} B on disk, "
            f"chunks {entry['chunks']}")
        # slice 11: the warm cache persisted beside the checkpoint
        s11_path, s11_zoom = s11_persist_warm(torch, ds, name, s11_cache)
        del ds
        torch.cuda.empty_cache()

        # 2. reload, 3. the main path's queries on it
        kpip.launches = 0
        kgrouped.launches = 0
        loaded, load_s = timed(torch, lambda: GeoDataset.load(str(root)))
        log(f"[slice10] flat load: {load_s:.3f} s; by stage (s) {loaded.load_seconds}; "
            f"journal attached {loaded._journal is not None}")
        s11_persist_restore(torch, loaded, name, s11_path, s11_zoom)
        got = s10_queries(loaded, name, q_bbox, q_poly)
        s10_check("the loaded store", got, live, oracle)
        paths = {q: dict(loaded._plan(name, q).exec_path) for q in (q_bbox, q_poly)}
        log(f"[slice10] flat loaded store: count {got['count_bbox']}, polygon "
            f"{got['count_polygon']}, grids equal to the live store and the oracle "
            f"(weighted within rtol 1e-4); exec_path {paths}")

        # both kernels against their plain versions on the loaded store's
        # operands: the counters are put back after the comparison
        held = (kpip.launches, kgrouped.launches)
        ex = loaded._executor(name)
        cols = ex.scan_columns(loaded._plan(name, q_poly), ["geom__x", "geom__y"])
        px, py = cols["geom__x"], cols["geom__y"]
        edges = torch.from_numpy(packed).cuda()
        bad = int((kpip.pip_mask(px, py, edges, n_edges)
                   != kpip.pip_mask_plain(px, py, edges, n_edges)).sum())
        if bad:
            raise AssertionError(f"pip disagrees with its plain version on {bad} points "
                                 "of the loaded store")
        # at 2M rows the main density's pair schedule duplicates rows past
        # geomesa.density.pallas.max.dup, so it takes the einsum rung (the
        # reference's); the grouped kernel's operands are built with the
        # knob raised
        with config.DENSITY_PALLAS_MAX_DUP.scoped(S10_MAX_DUP):
            o = ex.density_inputs(loaded._plan(name, q_bbox), QUERY_BBOX, WIDTH, HEIGHT)
        if o is None:
            raise AssertionError("no grouped operands for the loaded store's density")
        a = (o["x"], o["y"], o["mask"], o["weight"], QUERY_BBOX, WIDTH, HEIGHT, o["sched"])
        if not torch.equal(kgrouped.density_grouped(*a), kgrouped.density_grouped_plain(*a)):
            raise AssertionError("density_grouped disagrees with its plain version on the "
                                 "loaded store")
        log(f"[slice10] pip on {tuple(px.shape)} points and density_grouped on "
            f"{tuple(o['x'].shape)} rows, {o['sched']['chunks'].numel()} pairs (max.dup "
            f"{S10_MAX_DUP}) of the loaded store: equal to their plain versions")
        del cols, px, py, o, a
        kpip.launches, kgrouped.launches = held

        # 4. the journal: one writer, then S10_THREADS, with S10_BATCH-row
        # batches and, for a p99 of a few hundred acks, S10_SMALL-row ones
        batches = [s10_batch(i, args.seed) for i in range(S10_INSERTS)]
        small = [s10_batch(i, args.seed, S10_SMALL, "s") for i in range(2 * S10_SMALL_ACKS)]
        j = loaded._journal
        half, ms = S10_INSERTS // 2, lambda xs, q: float(np.percentile(np.array(xs) * 1e3, q))
        for rows, runs in ((S10_BATCH, (batches[:half], batches[half:])),
                           (S10_SMALL, (small[:S10_SMALL_ACKS], small[S10_SMALL_ACKS:]))):
            for threads, mine in zip((1, S10_THREADS), runs):
                acks, c = s10_acks(loaded, name, mine, threads)
                log(f"[slice10] journaled inserts of {rows} rows, {threads} writer(s), "
                    f"{len(acks)} acks: p50 {ms(acks, 50):.3f} ms, p99 {ms(acks, 99):.3f} ms, "
                    f"max {max(acks) * 1e3:.3f} ms; fsyncs {c['fsyncs']}, groups {c['groups']}")
                if threads > 1 and max(c["groups"], default=0) <= 1:
                    raise AssertionError(f"{threads} writers never shared a group commit: "
                                         f"{c['groups']}")
        log(f"[slice10] journal status: {j.status()['records']} records in "
            f"{len(j.status()['segments'])} segments")

        # 5. an incremental save: one new chunk, the old files untouched,
        # the journal truncated
        old = {rel: (root / rel).stat() for rel in entry["chunks"]}
        t0 = time.perf_counter()
        loaded.save(str(root))
        inc_s = time.perf_counter() - t0
        entry2 = json.loads((root / "manifest.json").read_text())["schemas"][name]
        new = [c for c in entry2["chunks"] if c not in entry["chunks"]]
        same = all((root / rel).stat().st_mtime_ns == s.st_mtime_ns
                   and (root / rel).stat().st_ino == s.st_ino for rel, s in old.items())
        if entry2["chunks"][:len(entry["chunks"])] != entry["chunks"] or len(new) != 1 \
                or not same:
            raise AssertionError(f"the incremental save rewrote chunks: {entry['chunks']} -> "
                                 f"{entry2['chunks']}")
        if j.status()["records"] or entry2["journal_seq"] != j.last_seq():
            raise AssertionError(f"the save did not truncate the journal: {j.status()}")
        log(f"[slice10] incremental save: {inc_s:.3f} s, one new chunk {new} "
            f"({(root / new[0]).stat().st_size} B), the old chunk files untouched, journal "
            f"segments truncated (journal_seq {entry2['journal_seq']})")
        base = s10_concat([data] + [b for b, _ in batches + small])
        n_base = len(base["dtg"])
        del loaded
        torch.cuda.empty_cache()

        # 6. a child loads the root and inserts until it is killed
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--s10-child", str(root),
             "--seed", str(args.seed)],
            stdout=subprocess.PIPE, text=True)
        acked, lines = -1, []
        try:
            for line in child.stdout:
                lines.append(line.strip())
                if line.startswith("ACK "):
                    acked = int(line.split()[1])
                    if acked + 1 >= S10_KILL_AFTER:
                        child.send_signal(signal.SIGKILL)
                        break
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
            child.stdout.close()
        if acked + 1 < S10_KILL_AFTER:
            raise AssertionError(f"the child died before {S10_KILL_AFTER} acks: {lines[-5:]}")
        child_s = time.perf_counter() - t0
        recovered, rec_s = timed(torch, lambda: GeoDataset.load(str(root)))
        n_rep = recovered._journal_replayed
        if n_rep < acked + 1:  # a durable but unacked tail may follow
            raise AssertionError(f"replayed {n_rep} records after {acked + 1} acks")
        kids = [s10_child_batch(i, args.seed) for i in range(n_rep)]
        surv = s10_concat([base] + [b for b, _ in kids])
        want_n = len(surv["dtg"])
        if recovered.count(name) != want_n:
            raise AssertionError(f"{recovered.count(name)} rows after the replay, want {want_n}")
        # every acked batch: its first and last rows
        ids = [k[1][e].decode() for k in kids[:acked + 1] for e in (0, -1)]
        found = recovered.count(name, "IN (" + ", ".join(f"'{i}'" for i in ids) + ")")
        if found != len(ids):
            raise AssertionError(f"{len(ids) - found} first / last rows of the "
                                 f"{acked + 1} acked batches lost")
        got = s10_queries(recovered, name, q_bbox, q_poly)
        s10_check("the recovered store", got, None, s10_oracle(surv, packed, n_edges))
        rep_s = recovered.load_seconds.get("replay", 0.0)
        flush_s = recovered.load_seconds.get("replay_flush", 0.0)
        log(f"[slice10] crash: the child acked {acked + 1} batches of {S10_SMALL} rows and "
            f"was killed ({child_s:.3f} s with its load); load + replay {rec_s:.3f} s: "
            f"{n_rep} records replayed in {rep_s:.3f} s ({n_rep / max(rep_s, 1e-9):.1f} "
            f"records/s), then the index flush {flush_s:.3f} s; every acked row present "
            f"({want_n} rows); the four queries equal their oracles over the surviving rows")

        # 7. a second dataset catches up with refresh_schema
        second = GeoDataset.load(str(root))
        more = [s10_batch(S10_INSERTS + i, args.seed) for i in range(S10_REFRESH)]
        for bdata, bfids in more:
            recovered.insert(name, bdata, fids=bfids)
        t0 = time.perf_counter()
        changed = second.refresh_schema(name, str(root))
        ref_s = time.perf_counter() - t0
        if not changed or second._journal_replayed != S10_REFRESH:
            raise AssertionError(f"refresh_schema applied {second._journal_replayed} records, "
                                 f"want {S10_REFRESH}")
        a2, b2 = (s10_queries(d, name, q_bbox, q_poly) for d in (second, recovered))
        s10_check("the refreshed dataset", a2, b2)
        log(f"[slice10] refresh_schema: {S10_REFRESH} records applied in {ref_s:.3f} s; "
            f"answers equal to the writer's ({a2['count_bbox']} rows in the box)")
        launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
        log(f"[slice10] flat phase: {time.perf_counter() - t_phase:.3f} s; launches of its own "
            f"calls {launches} (the comparisons with the plain versions not counted; the "
            f"density takes the einsum rung at this size)")
        if launches["pip"] <= 0:
            raise AssertionError(f"pip never launched in slice 10's flat phase: {launches}")
        return launches
    finally:
        for d in (root, s11_cache):
            shutil.rmtree(d, ignore_errors=True)


def s10_part_answers(ds, name, wkt):
    """Slice 9's 2-degree box over B and over the long window (count and
    density), B's polygon count and the wide two-day box's density, with
    each call's exec_path."""
    q_b = s9_query(S9_BOX, "2020-01-05T00:00:00", "2020-01-15T00:00:00")
    q_long = s9_query(S9_BOX, LONG_LO, LONG_HI)
    q_wide = s9_query(S9_WIDE, *S9_DAYS)
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    calls = {
        "count_box_b": (q_b, lambda: ds.count(name, q_b)),
        "density_box_b": (q_b, lambda: ds.density(name, q_b, bbox=S9_BOX, width=WIDTH,
                                                  height=HEIGHT)),
        "count_box_long": (q_long, lambda: ds.count(name, q_long)),
        "density_box_long": (q_long, lambda: ds.density(name, q_long, bbox=S9_BOX,
                                                        width=WIDTH, height=HEIGHT)),
        "count_polygon_b": (q_poly, lambda: ds.count(name, q_poly)),
        "density_wide_2d": (q_wide, lambda: ds.density(name, q_wide, bbox=S9_WIDE,
                                                       width=WIDTH, height=HEIGHT)),
    }
    out, paths = {}, {}
    for key, (q, fn) in calls.items():
        out[key] = fn()
        p = dict(ds._plan(name, q).exec_path)
        kern = {b: v.get("density_kernel") for b, v in (p.get("partitions") or {}).items()
                if v.get("density_kernel")}
        paths[key] = (p.get("lake"), kern)
    return out, paths


def s10_part_oracle(data, alive, packed, n_edges):
    out = {}
    for key, (box, lo, hi) in (("box_b", (S9_BOX, "2020-01-05T00:00:00", "2020-01-15T00:00:00")),
                               ("box_long", (S9_BOX, LONG_LO, LONG_HI))):
        tm = time_mask(data, lo, hi) & alive
        g_u, _, _, n = density_oracles(data, tm, bbox=box)
        out["count_" + key], out["density_" + key] = n, g_u
    sub = np.flatnonzero(time_mask(data) & alive)
    part = {k: v[sub] for k, v in data.items()}
    out["count_polygon_b"] = polygon_oracle(part, np.ones(len(sub), bool), packed, n_edges)
    tm = time_mask(data, *S9_DAYS) & alive
    out["density_wide_2d"] = density_oracles(data, tm, bbox=S9_WIDE)[0]
    return out


def slice10_partitioned(args, torch, ds, data, alive, wkt, packed, n_edges, kpip, kgrouped,
                        name="gdelt5"):
    """The slice-10 phase on slice 5's store after slice 9's lifecycle (see
    the module docstring, 12). Returns its launches of both kernels."""
    import shutil

    from geomesa_tpu_torch import GeoDataset, config

    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
    root, spill = out_dir / "s10_part", out_dir / "s10_spill"
    for d in (root, spill):
        shutil.rmtree(d, ignore_errors=True)
    st = ds._store(name)
    try:
        before, _ = s10_part_answers(ds, name, wkt)
        oracle = s10_part_oracle(data, alive, packed, n_edges)
        for key, v in before.items():
            if not s9_same(key.split("_")[0], v, oracle[key]):
                raise AssertionError(f"{key} on the live store differs from slice 9's oracle")
        # 1. save: checkpoint_into writes the dirty residents and copies
        # every clean snapshot
        resident, dirty = list(st.partitions), sorted(st._dirty)
        t0 = time.perf_counter()
        ds.save(str(root))
        save_s = time.perf_counter() - t0
        parts = root / f"{name}_parts"
        size = s10_dir_bytes(parts)

        def snaps():
            m = json.loads((root / "manifest.json").read_text())["schemas"][name]["partitions"]
            return m, {k: ((root / rel / SNAP).stat().st_ino,
                           (root / rel / SNAP).stat().st_mtime_ns) for k, rel in m.items()}

        dirs, stamps = snaps()
        log(f"[slice10] partitioned save: {save_s:.3f} s, {len(stamps)} partition snapshots, "
            f"{size} B under {parts.name} ({size / max(save_s, 1e-9) / 1e9:.3f} GB/s); "
            f"resident {resident}, dirty {dirty}")
        # 2. one row into one resident partition, then save again
        b = [k for k in resident if st.partitions[k].count][-1]
        row = {"geom__x": np.array([S10_ROW_XY[0]]), "geom__y": np.array([S10_ROW_XY[1]]),
               "dtg": st.partitions[b]._all.columns["dtg"][:1].astype("datetime64[ms]"),
               "weight": np.array([0.5], np.float32)}
        if st.ft.has("tag"):  # slice 9's update_schema added it
            row["tag"] = np.array([0], np.int32)
        ds.insert(name, row, fids=["s10_row"])
        t0 = time.perf_counter()
        ds.save(str(root))
        inc_s = time.perf_counter() - t0
        # the rewritten partition goes into a new dir; the one the first
        # manifest named is swept once the second is durable
        dirs2, stamps2 = snaps()
        moved = sorted(k for k in dirs2 if dirs2[k] != dirs.get(k))
        rewritten = sorted(k for k in stamps2 if stamps2[k] != stamps.get(k))
        on_disk = sorted(d.name for d in parts.iterdir())
        if moved != [str(b)] or rewritten != [str(b)] or (root / dirs[str(b)]).exists() \
                or on_disk != sorted(Path(rel).name for rel in dirs2.values()):
            raise AssertionError(f"the incremental save rewrote {rewritten} (moved {moved}), "
                                 f"want partition {b} alone; on disk {on_disk}")
        log(f"[slice10] one-row insert into partition {b}, then save: {inc_s:.3f} s, "
            f"snapshots rewritten {rewritten} of {len(stamps2)} ({dirs[str(b)]} -> "
            f"{dirs2[str(b)]}, the old dir swept)")
        # 3. load: every partition attached cold
        kpip.launches = 0
        kgrouped.launches = 0
        with config.SPILL_DIR.scoped(str(spill)):
            loaded, load_s = timed(torch, lambda: GeoDataset.load(str(root)))
        lst = loaded._store(name)
        if lst.partitions or sorted(lst.spilled) != st.partition_bins():
            raise AssertionError("the loaded store is not every partition cold")
        log(f"[slice10] partitioned load: {load_s:.3f} s ({loaded.load_seconds}), "
            f"{len(lst.spilled)} partitions attached cold, {lst.count} rows")
        # 4. slice 9's windows on the attached store
        t0 = time.perf_counter()
        got, paths = s10_part_answers(loaded, name, wkt)
        q_s = time.perf_counter() - t0
        for key, v in got.items():
            op = key.split("_")[0]  # count or density
            if not s9_same(op, v, before[key]) or not s9_same(op, v, oracle[key]):
                raise AssertionError(f"{key} on the loaded store differs from the live store "
                                     "or slice 9's oracle")
            log(f"[slice10] loaded {key}: equal to the live store and the oracle "
                f"({v if not isinstance(v, np.ndarray) else int(v.sum())}); exec_path lake "
                f"{paths[key][0]!r}, density_kernel by partition {paths[key][1]}")
        launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
        log(f"[slice10] partitioned phase: {time.perf_counter() - t_phase:.3f} s (the six "
            f"calls {q_s:.3f} s); launches of its own calls {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel never launched in slice 10's partitioned phase: "
                                 f"{launches}")
        loaded._store(name).drop_device()
        return launches
    finally:
        for d in (root, spill):
            shutil.rmtree(d, ignore_errors=True)



# ---------------------------------------------------------------------------
# slice 11: the aggregate cache
# ---------------------------------------------------------------------------

#: the dashboard raster: a fixed CONUS render box around the filter boxes
S11_RENDER = (-125.0, 24.0, -66.0, 50.0)
#: the pan: the main box moved east
S11_PAN = 2.0
S11_STATS = "Count();MinMax(weight);Histogram(weight,20,0,2)"
S11_STATS_WHOLE = "DescriptiveStats(weight)"
#: the zoom-out's decomposition: 16 level-2 quadrant cells, the domain at
#: level 1 (bench.py's smoke run takes 4, 80 cell plans; each cold cell
#: pays a planner cover and a compaction cover on the host, so the phase
#: halves the axis to stay inside the script's time limit)
S11_ZOOM_AXIS = 2

#: the polygon region and the curve pyramid: at the default 8 cells an axis
#: the 64-edge polygon has no interior cell (level 6), at 16 it has 10
S11_REGION_AXIS = 16
S11_LEVEL = 9
#: the curve pyramid's chunking: 4-block chunks at level 9 (2.8 x 1.4
#: degrees), small enough that the polygon holds interior chunks
S11_CURVE_AXIS = 32
S11_TILES = ((-125.0, 24.0, -95.5, 50.0), (-100.0, 24.0, -66.0, 50.0))
S11_INSERT = 64
#: the partitioned store's decomposition (each cell sub-scan loads its own
#: row groups there)
S11_PART_AXIS = 2
#: the cache counters the phase prints as per-call deltas
S11_COUNTERS = ("exec.device.dispatch", "cache.hit", "cache.partial", "cache.miss",
                "cache.put", "cache.invalidate", "cache.hierarchy.hit",
                "cache.hierarchy.promote", "cache.hierarchy.residual", "cache.polygon",
                "cache.curve.region", "cache.persist.restored")
S11_NOTES = ("cache", "cache_cells", "cache_level", "cache_chunk", "hierarchy",
             "cache_region", "cache_boundary_cells", "cache_residual_fraction",
             "cache_region_chunks")


def s11_zoom_queries(during=DURING):
    """bench.py's zoom-out: the four quadrants, then the domain."""
    quads = [f"BBOX(geom, {b}) AND {during}" for b in (
        "-180, -90, 0, 0", "0, -90, 180, 0", "-180, 0, 0, 90", "0, 0, 180, 90")]
    return quads, f"BBOX(geom, -180, -90, 180, 90) AND {during}"


def s11_box(box) -> str:
    return f"BBOX(geom, {', '.join(str(v) for v in box)}) AND {DURING}"


class S11Calls:
    """Runs one call of the phase: wall ms, the per-call counter deltas
    (dispatches first) and the cache's exec-path notes, logged on one line."""

    def __init__(self, torch, ds, name, label="[slice11]"):
        from geomesa_tpu_torch import metrics

        self.torch, self.ds, self.name, self.label = torch, ds, name, label
        self.reg = metrics.registry()

    def counts(self):
        return {k: self.reg.counter(k).value for k in S11_COUNTERS}

    def notes(self, plan_query):
        if plan_query is None:
            return {}
        path = self.ds._plan(self.name, plan_query).__dict__.get("exec_path", {})
        return {k: v for k, v in path.items() if k in S11_NOTES}

    def __call__(self, key, fn, plan_query=None, extra=""):
        c0 = self.counts()
        out, s = timed(self.torch, fn)
        c1 = self.counts()
        d = {k: c1[k] - c0[k] for k in S11_COUNTERS}
        moved = {k: v for k, v in d.items() if v and k != "exec.device.dispatch"}
        log(f"{self.label} {key}: {s * 1e3:.3f} ms, dispatches "
            f"{d['exec.device.dispatch']}, cache {moved}, exec_path "
            f"{self.notes(plan_query)}{extra}")
        return out, s * 1e3, d


def s11_render_oracle(data, rows, render=S11_RENDER, box=None, width=WIDTH, height=HEIGHT):
    """The unweighted grid of ``rows`` over ``render``: pixels in f32 op
    by op, except rows in the f32 band of the filter ``box``, which the
    host maps from f64 (density_oracles' semantics with the raster apart
    from the filter)."""
    x, y = data["geom__x"][rows], data["geom__y"][rows]
    xmin, ymin, xmax, ymax = render
    f = np.float32
    x32, y32 = x.astype(f), y.astype(f)
    px = ((x32 - f(xmin)) / f(xmax - xmin) * f(width)).astype(np.int32)
    py = ((y32 - f(ymin)) / f(ymax - ymin) * f(height)).astype(np.int32)
    if box is not None:
        band = np.isin(x32, [f(box[0]), f(box[2])]) | np.isin(y32, [f(box[1]), f(box[3])])
        px = np.where(band, ((x - xmin) / (xmax - xmin) * width).astype(np.int32), px)
        py = np.where(band, ((y - ymin) / (ymax - ymin) * height).astype(np.int32), py)
    idx = np.clip(py, 0, height - 1) * width + np.clip(px, 0, width - 1)
    return np.bincount(idx, minlength=width * height).astype(np.float64).reshape(height, width)


def s11_same(label, got, off, oracle=None):
    """Cached answers bit-identical to the cache-off answer (and equal to
    the oracle when one is given)."""
    same = (np.array_equal(got, off) and got.dtype == off.dtype) \
        if isinstance(got, np.ndarray) else got == off
    if not same:
        raise AssertionError(f"slice11 {label}: the cached answer differs from cache off")
    if oracle is not None:
        ok = np.array_equal(np.asarray(got, np.float64), oracle) \
            if isinstance(got, np.ndarray) else got == oracle
        if not ok:
            raise AssertionError(f"slice11 {label}: differs from the oracle")


def slice11(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped, n_bbox, n_poly):
    """The slice-11 phase on slice 1's store (see the module docstring,
    13). Returns its launches of both kernels."""
    import dataclasses

    from geomesa_tpu_torch import Query, config
    from geomesa_tpu_torch.cache import AggregateCache

    t_phase = time.perf_counter()
    name = "gdelt"
    st = ds._store(name)
    kpip.launches = 0
    kgrouped.launches = 0
    tm = time_mask(data)
    x, y = data["geom__x"], data["geom__y"]
    pan = (QUERY_BBOX[0] + S11_PAN, QUERY_BBOX[1], QUERY_BBOX[2] + S11_PAN, QUERY_BBOX[3])
    q_box, q_pan = s11_box(QUERY_BBOX), s11_box(pan)
    quads, q_zoom = s11_zoom_queries()
    run = S11Calls(torch, ds, name)

    def rows_in(box):
        return tm & (x >= box[0]) & (x <= box[2]) & (y >= box[1]) & (y <= box[3])

    def dens(q, weight=None, region=None):
        return lambda: ds.density(name, q, bbox=S11_RENDER, width=WIDTH, height=HEIGHT,
                                  weight=weight, region=region)

    def curve_q(region=None, q=DURING):
        return dataclasses.replace(Query(ecql=ds._with_region(name, q, region)), index="z2")

    # -- the cache-off answers the cached ones must equal, each call timed
    # cold (its first call in the phase) and warm (the next) ---------------
    t0 = time.perf_counter()
    off, off_ms = {}, {}

    def off_call(key, fn):
        out, s_cold = timed(torch, fn)
        _, s_warm = timed(torch, fn)
        off[key], off_ms[key] = out, (s_cold * 1e3, s_warm * 1e3)
        log(f"[slice11] cache off {key}: cold {s_cold * 1e3:.3f} ms, warm "
            f"{s_warm * 1e3:.3f} ms")

    with config.CACHE_ENABLED.scoped("false"):
        off_call("count", lambda: ds.count(name, q_box))
        off_call("count_pan", lambda: ds.count(name, q_pan))
        off_call("density", dens(q_box))
        off_call("density_pan", dens(q_pan))
        off_call("density_weighted", dens(q_box, "weight"))
        off_call("stats", lambda: ds.stats(name, S11_STATS, q_box).value())
        off_call("stats_whole", lambda: ds.stats(name, S11_STATS_WHOLE, q_box).value())
        for i, q in enumerate(quads):
            off_call(f"quad{i}", lambda q=q: ds.count(name, q))
        off_call("zoom", lambda: ds.count(name, q_zoom))
        off_call("poly_count", lambda: ds.count(name, DURING, region=wkt))
        off_call("poly_density", dens(DURING, region=wkt))
        for i, b in enumerate(S11_TILES):
            off_call(f"tile{i}", lambda b=b: ds.density_curve(
                name, DURING, level=S11_LEVEL, bbox=b)[0])
        off_call("curve", lambda: ds.density_curve(name, DURING, level=S11_LEVEL,
                                                   bbox=S11_RENDER)[0])
        off_call("curve8", lambda: ds.density_curve(name, DURING, level=S11_LEVEL - 1,
                                                    bbox=S11_RENDER)[0])
        off_call("curve_poly", lambda: ds.density_curve(name, DURING, level=S11_LEVEL,
                                                        bbox=S11_RENDER, region=wkt)[0])
    s11_same("cache off count", off["count"], n_bbox)
    off_s = time.perf_counter() - t0
    kpip.launches = 0
    kgrouped.launches = 0
    in_poly = polygon_rows(data, tm, packed, n_edges)
    oracle = {
        "count_pan": int(rows_in(pan).sum()),
        "density": s11_render_oracle(data, rows_in(QUERY_BBOX), box=QUERY_BBOX),
        "density_pan": s11_render_oracle(data, rows_in(pan), box=pan),
        "zoom": int(tm.sum()),
        "poly_density": s11_render_oracle(data, in_poly),
    }
    ds.cache = AggregateCache()
    reg = S11Calls(torch, ds, name).reg
    with config.CACHE_ENABLED.scoped("true"):
        # 1. the main box's count: cold (10 cells + strips), warm, a pan
        n, cold_ms, d = run("count cold", lambda: ds.count(name, q_box), q_box)
        s11_same("count cold", n, n_bbox)
        n, warm_ms, d = run("count warm", lambda: ds.count(name, q_box), q_box)
        s11_same("count warm", n, n_bbox)
        if d["exec.device.dispatch"] or d["cache.hit"] != 1:
            raise AssertionError(f"slice11: the repeated count was not a whole hit: {d}")
        n, pan_ms, d = run("count pan +2 deg", lambda: ds.count(name, q_pan), q_pan)
        s11_same("count pan", n, off["count_pan"], oracle["count_pan"])
        if d["cache.partial"] != 1:
            raise AssertionError(f"slice11: the pan reused no cell: {d}")

        # 2. 512x512 density over the fixed CONUS raster: decomposed
        g, dens_ms, d = run("density cold (decomposed)", dens(q_box), q_box)
        s11_same("density", g, off["density"], oracle["density"])
        if "cache_cells" not in run.notes(q_box):
            raise AssertionError("slice11: the dashboard density did not decompose")
        g, dens_pan_ms, d = run("density pan +2 deg", dens(q_pan), q_pan)
        s11_same("density pan", g, off["density_pan"], oracle["density_pan"])
        # weighted grids add float atomics in an order the card sets, so
        # two scans agree within rtol 1e-4 (check 4's tolerance); the warm
        # hit returns the stored grid bit for bit
        gw, _, d = run("density weighted cold (whole result)", dens(q_box, "weight"), q_box)
        if "cache_cells" in run.notes(q_box) or not np.allclose(
                gw, off["density_weighted"], rtol=1e-4, atol=1e-3):
            raise AssertionError("slice11: the weighted density decomposed or left rtol 1e-4")
        g, _, d = run("density weighted warm", dens(q_box, "weight"), q_box)
        s11_same("density weighted warm", g, gw)

        # 3. stats: exact-merge decomposed, descriptive whole result only
        s, _, d = run(f"stats {S11_STATS} (decomposed)",
                      lambda: ds.stats(name, S11_STATS, q_box), q_box)
        s11_same("stats", s.value(), off["stats"])
        if s.value()[0] != n_bbox:
            raise AssertionError("slice11: the stats count differs from the oracle")
        s, _, d = run(f"stats {S11_STATS_WHOLE} (whole result)",
                      lambda: ds.stats(name, S11_STATS_WHOLE, q_box), q_box)
        s11_same("stats descriptive", s.value(), off["stats_whole"])

        # 4. the hierarchical zoom-out: flat arm, then the warm arm
        with config.CACHE_CELLS_PER_AXIS.scoped(S11_ZOOM_AXIS):
            with config.CACHE_HIERARCHY.scoped("false"):
                ds.cache.store.invalidate()
                for i, q in enumerate(quads):
                    n, _, _ = run(f"zoom flat arm quad {i}", lambda q=q: ds.count(name, q), q)
                    s11_same(f"zoom quad {i}", n, off[f"quad{i}"])
                n, flat_ms, d_flat = run("zoom-out flat arm", lambda: ds.count(name, q_zoom),
                                         q_zoom)
                s11_same("zoom-out flat", n, off["zoom"], oracle["zoom"])
            ds.cache.store.invalidate()
            for i, q in enumerate(quads):
                run(f"zoom warm arm quad {i}", lambda q=q: ds.count(name, q), q)
            n, zoom_ms, d = run("zoom-out warm arm", lambda: ds.count(name, q_zoom), q_zoom)
            s11_same("zoom-out warm", n, off["zoom"], oracle["zoom"])
            hits, total = map(int, run.notes(q_zoom)["cache_cells"].split("/"))
            if d["exec.device.dispatch"] != 0 or hits != total:
                raise AssertionError(f"slice11: the warm zoom-out dispatched: {d}, "
                                     f"cells {hits}/{total}")
            log(f"[slice11] zoom-out: flat {flat_ms:.3f} ms ({d_flat['exec.device.dispatch']} "
                f"dispatches) vs warm {zoom_ms:.3f} ms (0 dispatches), served fraction "
                f"{hits / max(total, 1):.4f}")

        # 5. the polygon region (count and density): interior cells cached,
        # boundary cells through pip
        with config.CACHE_CELLS_PER_AXIS.scoped(S11_REGION_AXIS):
            q_region = ds._with_region(name, DURING, wkt)
            pip0 = kpip.launches
            n, region_ms, d = run("region count cold",
                                  lambda: ds.count(name, DURING, region=wkt), q_region)
            s11_same("region count", n, off["poly_count"], n_poly)
            notes = run.notes(q_region)
            if notes.get("cache_region") != "polygon" or kpip.launches <= pip0:
                raise AssertionError(f"slice11: the region did not decompose through pip: "
                                     f"{notes}, pip launches {kpip.launches - pip0}")
            n_int = int(notes["cache_cells"].split("/")[1])
            n, region_warm_ms, d = run("region count warm",
                                       lambda: ds.count(name, DURING, region=wkt), q_region)
            s11_same("region count warm", n, n_poly)
            g, _, d = run("region density cold", dens(DURING, region=wkt), q_region)
            s11_same("region density", g, off["poly_density"], oracle["poly_density"])
            g, _, d = run("region density warm", dens(DURING, region=wkt), q_region)
            s11_same("region density warm", g, off["poly_density"])
            log(f"[slice11] region: {n_int} interior cells, {notes['cache_boundary_cells']} "
                f"boundary cells at level {notes['cache_level']}; count {n_poly} equal to cache "
                "off and the f32 parity oracle")

        # 6. a level-9 density_curve pyramid: tiles, a zoom-out level,
        # polygon chunk families
        with config.CACHE_CELLS_PER_AXIS.scoped(S11_CURVE_AXIS):
            cq = curve_q()
            for i, b in enumerate(S11_TILES):
                (g, snapped), _, d = run(f"curve tile {i}", lambda b=b: ds.density_curve(
                    name, DURING, level=S11_LEVEL, bbox=b), cq)
                s11_same(f"curve tile {i}", g, off[f"tile{i}"])
                curve_check(f"slice11 curve tile {i}", g, curve_oracle(
                    x[tm], y[tm], None, S11_LEVEL, ds._snap_blocks(b, S11_LEVEL)[0]))
                if i and d["cache.partial"] != 1:
                    raise AssertionError(f"slice11: the second tile reused no chunk: {d}")
            for lvl, key in ((S11_LEVEL, "curve"), (S11_LEVEL - 1, "curve8")):
                (g, _), _, d = run(f"curve CONUS level {lvl}", lambda lvl=lvl: ds.density_curve(
                    name, DURING, level=lvl, bbox=S11_RENDER), cq)
                s11_same(f"curve level {lvl}", g, off[key])
                curve_check(f"slice11 curve level {lvl}", g, curve_oracle(
                    x[tm], y[tm], None, lvl, ds._snap_blocks(S11_RENDER, lvl)[0]))
            # the level-8 chunks are the level-9 ones downsampled (rolled
            # up when those were stored, or assembled on the miss)
            if int(run.notes(cq)["cache_cells"].split("/")[0]) <= 0:
                raise AssertionError(f"slice11: the curve zoom-out reused no chunk: {d}")
            cqr = curve_q(region=wkt)
            (g, _), _, d = run("curve region", lambda: ds.density_curve(
                name, DURING, level=S11_LEVEL, bbox=S11_RENDER, region=wkt), cqr)
            s11_same("curve region", g, off["curve_poly"])
            curve_check("slice11 curve region", g, curve_oracle(
                x[in_poly], y[in_poly], None, S11_LEVEL,
                ds._snap_blocks(S11_RENDER, S11_LEVEL)[0]))
            fam = run.notes(cqr).get("cache_region_chunks", "")
            hits = int(run.notes(cqr)["cache_cells"].split("/")[0])
            if d["cache.curve.region"] != 1 or " 0 interior" in f" {fam}" or hits <= 0:
                raise AssertionError(f"slice11: the interior chunks were not served from the "
                                     f"plain family: {fam}, {hits} hits")

        # 7. the kernels against their plain versions on cache-path operands
        held = (kpip.launches, kgrouped.launches)
        s11_kernels(torch, ds, name, st, q_box, q_region, wkt, packed, n_edges, kpip, kgrouped)
        kpip.launches, kgrouped.launches = held

    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    # cache on beside cache off, on the same calls (off: cold, warm)
    side = (("count cold", cold_ms, "count"), ("count warm", warm_ms, "count"),
            ("count pan", pan_ms, "count_pan"), ("density cold", dens_ms, "density"),
            ("density pan", dens_pan_ms, "density_pan"), ("zoom-out warm arm", zoom_ms, "zoom"),
            ("region count cold", region_ms, "poly_count"),
            ("region count warm", region_warm_ms, "poly_count"))
    log("[slice11] cache on vs off (ms; off cold / warm): " + "; ".join(
        f"{k} {on:.3f} vs {off_ms[o][0]:.3f} / {off_ms[o][1]:.3f}" for k, on, o in side))
    entries, nbytes = ds.cache.store.total_entries, ds.cache.store.total_bytes
    ds.cache.store.invalidate()
    log(f"[slice11] phase: {time.perf_counter() - t_phase:.3f} s (cache-off answers "
        f"{off_s:.3f} s); {entries} entries, {nbytes} B cached at the end, dropped; launches "
        f"of its own calls {launches} (the comparisons with the plain versions not counted); "
        f"exec.device.dispatch total {reg.counter('exec.device.dispatch').value}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in slice 11's phase: {launches}")
    return launches


def s11_kernels(torch, ds, name, st, q_box, q_region, wkt, packed, n_edges, kpip, kgrouped):
    """pip on one boundary scan's compact points and density_grouped on one
    cell density's schedule, each against its plain version and timed in
    turns with it."""
    from geomesa_tpu_torch import config
    from geomesa_tpu_torch.cache import decompose, decompose_region

    ex = ds._executor(name)
    geom = st.ft.geom_field
    q = ds._as_query(q_region)
    with config.CACHE_CELLS_PER_AXIS.scoped(S11_REGION_AXIS):
        rdec = decompose_region(ds._plan(name, q_region).filter, st.ft)
    bplan = ds.cache._sub_plan(ds, st, q, rdec.residual_scan_filter(geom))
    cols = ex.scan_columns(bplan, ["geom__x", "geom__y"])
    px, py = cols["geom__x"], cols["geom__y"]
    edges = torch.from_numpy(packed).cuda()
    got, want = kpip.pip_mask(px, py, edges, n_edges), kpip.pip_mask_plain(px, py, edges, n_edges)
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"pip disagrees with its plain version on {bad} boundary points")
    ms, plain_ms, _ = in_turns(torch, lambda: kpip.pip_mask(px, py, edges, n_edges),
                               lambda: kpip.pip_mask_plain(px, py, edges, n_edges), 10, 3)
    log(f"[slice11] pip on the boundary scan's {tuple(px.shape)} points x {n_edges} edges: "
        f"equal to its plain version; {ms:.6f} ms (plain {plain_ms:.6f} ms)")
    dec = decompose(ds._plan(name, q_box).filter, st.ft)
    o = None
    for cell in dec.cells:
        cplan = ds.cache._sub_plan(ds, st, ds._as_query(q_box), dec.cell_filter(cell, geom))
        o = ex.density_inputs(cplan, S11_RENDER, WIDTH, HEIGHT)
        if o is not None:
            break
    if o is None:
        raise AssertionError("no cell density of the main box took the grouped rung")
    a = (o["x"], o["y"], o["mask"], o["weight"], S11_RENDER, WIDTH, HEIGHT, o["sched"])
    if not torch.equal(kgrouped.density_grouped(*a), kgrouped.density_grouped_plain(*a)):
        raise AssertionError("density_grouped disagrees with its plain version on a cell")
    ms, plain_ms, _ = in_turns(torch, lambda: kgrouped.density_grouped(*a),
                               lambda: kgrouped.density_grouped_plain(*a), 10, 3)
    log(f"[slice11] density_grouped on cell {cell}'s {tuple(o['x'].shape)} rows, "
        f"{o['sched']['chunks'].numel()} pairs: equal to its plain version; {ms:.6f} ms "
        f"(plain {plain_ms:.6f} ms)")


def s11_persist_warm(torch, ds, name, root):
    """Warm the zoom-out on slice 10's live flat store and persist the
    cache beside its checkpoint: (cache file, the answers)."""
    from geomesa_tpu_torch import config

    quads, zoom = s11_zoom_queries()
    run = S11Calls(torch, ds, name, "[slice11 persist]")
    path = str(Path(root) / "cache.lake")
    with config.CACHE_ENABLED.scoped("true"), \
            config.CACHE_CELLS_PER_AXIS.scoped(S11_ZOOM_AXIS):
        for i, q in enumerate(quads):
            run(f"quad {i}", lambda q=q: ds.count(name, q), q)
        n, _, _ = run("zoom-out", lambda: ds.count(name, zoom), zoom)
    with config.CACHE_ENABLED.scoped("false"):
        if ds.count(name, zoom) != n:
            raise AssertionError("slice11 persist: the zoom-out differs from cache off")
    summary, s = timed(torch, lambda: ds.persist_cache(path))
    log(f"[slice11 persist] persist_cache: {s * 1e3:.3f} ms, entries {summary}, "
        f"{Path(path).stat().st_size} B")
    # invalidation: one insert batch into the persisted store (it is not
    # read again), then the main box's count equals the new oracle and the
    # counters show a miss. At 4 cells an axis the box holds no level-5
    # cell: one whole-result entry, one scan a call
    q_box = s11_box(QUERY_BBOX)
    with config.CACHE_ENABLED.scoped("true"), config.CACHE_CELLS_PER_AXIS.scoped(4):
        before, _, _ = run("main box count", lambda: ds.count(name, q_box), q_box)
        rng = np.random.default_rng(11)
        ds.insert(name, {
            "geom__x": rng.uniform(QUERY_BBOX[0] + 1, QUERY_BBOX[2] - 1, S11_INSERT),
            "geom__y": rng.uniform(QUERY_BBOX[1] + 1, QUERY_BBOX[3] - 1, S11_INSERT),
            "dtg": np.full(S11_INSERT, np.datetime64("2020-01-10T00:00:00", "ms")),
            "weight": np.full(S11_INSERT, 0.5, np.float32),
        })
        ds.flush(name)
        n_after, _, d = run(f"main box count after a {S11_INSERT}-row insert",
                            lambda: ds.count(name, q_box), q_box)
    if n_after != before + S11_INSERT or d["cache.miss"] != 1 or d["cache.invalidate"] <= 0:
        raise AssertionError(f"slice11: the insert did not invalidate: {n_after} after "
                             f"{before}, {d}")
    return path, n


def s11_persist_restore(torch, ds, name, path, want):
    """Restore the persisted cache into the loaded dataset; its zoom-out
    then launches nothing and equals the live answer."""
    from geomesa_tpu_torch import config

    _, zoom = s11_zoom_queries()
    run = S11Calls(torch, ds, name, "[slice11 persist]")
    out, s = timed(torch, lambda: ds.restore_cache(path))
    restored = out.get(name, {}).get("restored", 0)
    log(f"[slice11 persist] restore_cache: {s * 1e3:.3f} ms, {out}")
    if restored <= 0:
        raise AssertionError(f"slice11 persist: nothing restored: {out}")
    with config.CACHE_ENABLED.scoped("true"), \
            config.CACHE_CELLS_PER_AXIS.scoped(S11_ZOOM_AXIS):
        n, _, d = run("restored zoom-out", lambda: ds.count(name, zoom), zoom)
    if n != want or d["exec.device.dispatch"] != 0:
        raise AssertionError(f"slice11 persist: the restored zoom-out gave {n} (want {want}) "
                             f"with {d['exec.device.dispatch']} dispatches")
    ds.cache.store.invalidate()


def slice11_partitioned(torch, ds, data, alive, wkt, packed, n_edges, kpip, kgrouped,
                        name="gdelt5"):
    """Slice 9's 2-degree box over B on slice 5's store: count cold, warm
    and a pan, and B's polygon count, at S11_PART_AXIS cells an axis; each
    equal to cache off. Returns the launches of its calls."""
    from geomesa_tpu_torch import config
    from geomesa_tpu_torch.cache import AggregateCache

    t_phase = time.perf_counter()
    b_lo, b_hi = "2020-01-05T00:00:00", "2020-01-15T00:00:00"
    pan = (S9_BOX[0] + 1.0, S9_BOX[1], S9_BOX[2] + 1.0, S9_BOX[3])
    q_b, q_pan = s9_query(S9_BOX, b_lo, b_hi), s9_query(pan, b_lo, b_hi)
    during = f"dtg DURING {b_lo}Z/{b_hi}Z"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {during}"
    with config.CACHE_ENABLED.scoped("false"):
        off = {q: ds.count(name, q) for q in (q_b, q_pan, q_poly)}
    want = {q_b: int(s9_box_rows(data, S9_BOX, b_lo, b_hi, alive).sum()),
            q_pan: int(s9_box_rows(data, pan, b_lo, b_hi, alive).sum())}
    kpip.launches = 0
    kgrouped.launches = 0
    ds.cache = AggregateCache()
    run = S11Calls(torch, ds, name, "[slice11 partitioned]")
    with config.CACHE_ENABLED.scoped("true"), \
            config.CACHE_CELLS_PER_AXIS.scoped(S11_PART_AXIS):
        for key, q in (("box B cold", q_b), ("box B warm", q_b), ("box B pan +1 deg", q_pan),
                       ("polygon over B cold", q_poly), ("polygon over B warm", q_poly)):
            n, _, _ = run(key, lambda q=q: ds.count(name, q), q)
            s11_same(f"partitioned {key}", n, off[q], want.get(q))
    ds.cache.store.invalidate()
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    log(f"[slice11 partitioned] {time.perf_counter() - t_phase:.3f} s; each answer equal to "
        f"cache off (boxes to the oracle over the surviving rows); launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# slice 13: the degradation contract and deadlines
# ---------------------------------------------------------------------------

#: B moved one week later: slice 9's age_off at 2020-01-09 emptied B's first
#: week, and this window keeps two live weekly partitions
S13_LO, S13_HI = "2020-01-12T00:00:00", "2020-01-22T00:00:00"
S13_LEVEL = 9
#: the long window's deadline
S13_TIMEOUT_S = 1.0
#: where the spill-retry check's one row goes (outside every query box)
S13_ROW_XY = (-124.4, 48.4)


def s13_check(label, key, got, want):
    """``got`` equal to the oracle ``want``: counts, the unweighted grid and
    the curve exactly, the stats' count and f32 min / max exactly."""
    if key == "stats":
        c, mm = got.stats[0].value(), got.stats[1].value()
        ok = [c, mm["min"], mm["max"]] == want
    elif key in ("density", "curve"):
        ok = np.array_equal(np.asarray(got, np.float64), want)
    else:
        ok = got == want
    if not ok:
        raise AssertionError(f"[slice13] {label} {key}: differs from the oracle over the "
                             "surviving rows")


def slice13(torch, ds, data, alive, wkt, packed, n_edges, kpip, kgrouped, name="gdelt5"):
    """The slice-13 phase on slice 5's store after slice 11's partitioned
    part (see the module docstring, 14), with slice 14's partitioned part
    after its degraded calls. Returns the launches of its calls and
    :func:`s14_partitioned`'s (launches, wall)."""
    from geomesa_tpu_torch import config, resilience
    from geomesa_tpu_torch.filter.ecql import parse_iso_ms
    from geomesa_tpu_torch.lake.snapshot import PartitionSnapshot
    from geomesa_tpu_torch.resilience import InjectedFault, QueryTimeoutError

    t_phase = time.perf_counter()
    st = ds._store(name)
    during = f"dtg DURING {S13_LO}Z/{S13_HI}Z"
    q = f"{BOX} AND {during}"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {during}"
    # the oracle rows: the window's surviving rows and the bin of each
    sub = np.flatnonzero(time_mask(data, S13_LO, S13_HI) & alive)
    part = {k: v[sub] for k, v in data.items()}
    rbins = np.asarray(st.binned.to_bin_and_offset(part["dtg"].astype(np.int64))[0])
    live = sorted(b for b in set(rbins.tolist()) if st.part_counts.get(b))
    if len(live) != 2:
        raise AssertionError(f"[slice13] the window holds live partitions {live}, want two")
    dead = live[1]
    in_poly = polygon_rows(part, np.ones(len(sub), bool), packed, n_edges)
    window, _ = ds._snap_blocks(QUERY_BBOX, S13_LEVEL)
    x, y = part["geom__x"], part["geom__y"]
    xmin, ymin, xmax, ymax = QUERY_BBOX
    in_box = (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)

    def oracle(keep):
        m = keep & in_box
        w = part["weight"][m]
        return {"count": int(m.sum()), "density": density_oracles(part, keep)[0],
                "count_polygon": int((in_poly & keep).sum()),
                "stats": [int(m.sum()), float(w.min()), float(w.max())],
                "curve": curve_oracle(x[m], y[m], None, S13_LEVEL, window)}

    healthy = oracle(np.ones(len(sub), bool))
    degraded = oracle(rbins != dead)
    calls = {
        "count": lambda: ds.count(name, q),
        "density": lambda: ds.density(name, q, bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT),
        "count_polygon": lambda: ds.count(name, q_poly),
        "stats": lambda: ds.stats(name, S9_STATS, q),
        "curve": lambda: ds.density_curve(name, q, level=S13_LEVEL, bbox=QUERY_BBOX)[0],
    }
    kpip.launches = 0
    kgrouped.launches = 0
    # 1. one of the window's two partitions failing at exec.partition.scan:
    # strict mode raises, partial mode answers over the survivor, and the
    # fault-free answers follow, equal to the oracle over both
    fault = dict(times=None, where=lambda c: c.get("bin") == dead)
    raised = 0
    walls = {}
    with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults(seed=13) as inj:
        inj.fail("exec.partition.scan", **fault)
        for key, fn in calls.items():
            try:
                fn()
            except InjectedFault:
                raised += 1
        for key, fn in calls.items():
            with resilience.allow_partial() as partial:
                got, walls[key, "degraded"] = timed(torch, fn)
            if [s.part for s in partial.skipped] != [f"bin:{dead}"]:
                raise AssertionError(f"[slice13] degraded {key} skipped {partial.skipped}")
            s13_check("degraded", key, got, degraded[key])
    if raised != len(calls):
        raise AssertionError(f"[slice13] strict mode raised on {raised} of {len(calls)} calls")
    for key, fn in calls.items():
        got, walls[key, "healthy"] = timed(torch, fn)
        s13_check("after", key, got, healthy[key])
    healthy_ms, degraded_ms = (walls["count", k] * 1e3 for k in ("healthy", "degraded"))
    per_call = {k: (round(walls[k, "healthy"] * 1e3, 3), round(walls[k, "degraded"] * 1e3, 3))
                for k in calls}
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    if launches["pip"] <= 0:
        raise AssertionError(f"[slice13] the polygon counts never launched pip: {launches}")
    log(f"[slice13] window {S13_LO}/{S13_HI} over partitions {live}, bin {dead} failing at "
        f"exec.partition.scan: strict mode raised on all {len(calls)} calls; under "
        f"allow_partial() count {degraded['count']} of {healthy['count']}, polygon "
        f"{degraded['count_polygon']} of {healthy['count_polygon']}, the 512x512 density, "
        f"Count();MinMax(weight) and the level-{S13_LEVEL} curve equal the NumPy oracle over "
        f"the surviving partition, and the fault-free answers after them equal the oracle "
        f"over both partitions; "
        f"warm count healthy {healthy_ms:.3f} ms, degraded {degraded_ms:.3f} ms; launches "
        f"{launches}; warm ms of each call healthy / degraded {per_call}")

    # slice 14's part on this store: B traced, then one degraded count
    s14 = s14_partitioned(torch, ds, name, f"{BOX} AND {DURING}", dead, q, kpip, kgrouped)

    # 2. the deadline: the long window's count under geomesa.query.timeout
    q_long = f"{BOX} AND {LONG}"
    for mode in ("strict", "partial"):
        seen = []
        with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults() as inj, \
                config.QUERY_TIMEOUT.scoped(f"{int(S13_TIMEOUT_S * 1000)} ms"):
            inj.fail("exec.partition.scan", times=None,
                     where=lambda c: seen.append(c["bin"]) and False)
            with (resilience.allow_partial() if mode == "partial"
                  else contextlib.nullcontext()) as partial:
                t0 = time.perf_counter()
                try:
                    ds.count(name, q_long)
                except QueryTimeoutError:
                    late = time.perf_counter() - t0 - S13_TIMEOUT_S
                else:
                    raise AssertionError(f"[slice13] the long window's {mode} count beat "
                                         f"a {S13_TIMEOUT_S} s deadline")
        if partial is not None and partial.skipped:
            raise AssertionError(f"[slice13] a deadline was degraded: {partial.skipped}")
        log(f"[slice13] long window count under geomesa.query.timeout {S13_TIMEOUT_S} s "
            f"({mode}): QueryTimeoutError after {len(seen)} of {len(st.partition_bins())} "
            f"partitions scanned, {late * 1e3:.3f} ms past the deadline")

    # 3. quarantine: one flipped byte in a spilled partition's lake file
    q_small = s9_query(S9_BOX, S13_LO, S13_HI)
    small = int(s9_box_rows(data, S9_BOX, S13_LO, S13_HI, alive).sum())
    qb = next((b for b in live if b in st.spilled), None)
    if qb is None:
        qb = live[0]
        with st._part_lock:
            st._spill(qb)
    d = st.spilled[qb]
    snap = PartitionSnapshot(d)
    lo, hi = float(parse_iso_ms(S13_LO)), float(parse_iso_ms(S13_HI))
    g = snap.prune([S9_BOX], [(lo, hi)])[0]
    off = snap.file.blobs[snap.groups[g]["cols"]["c/geom__x"]["b"]][0] + 3
    path = snap.file.path
    snap.file.close()
    with open(path, "r+b") as fh:
        fh.seek(off)
        byte = fh.read(1)
        fh.seek(off)
        fh.write(bytes([byte[0] ^ 0x5A]))
    keep_small = s9_box_rows(data, S9_BOX, S13_LO, S13_HI, alive)
    qbins = np.asarray(st.binned.to_bin_and_offset(
        data["dtg"][keep_small].astype(np.int64))[0])
    want_q = int((qbins != qb).sum())
    try:
        with resilience.allow_partial() as partial:
            got1 = ds.count(name, q_small)
        reads = []
        with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults() as inj:
            inj.fail("lake.read", times=None, where=lambda c: reads.append(c["path"]) and False)
            with resilience.allow_partial() as again:
                got2 = ds.count(name, q_small)
    finally:
        with open(path, "r+b") as fh:
            fh.seek(off)
            fh.write(byte)
    if [s.part for s in partial.skipped] != [f"bin:{qb}"] or got1 != want_q \
            or list(st.spill_quarantine()) != [qb]:
        raise AssertionError(f"[slice13] corrupt bin {qb}: count {got1} (oracle {want_q}), "
                             f"skipped {partial.skipped}, quarantine {st.spill_quarantine()}")
    if got2 != want_q or [s.part for s in again.skipped] != [f"bin:{qb}"] \
            or any(r == path for r in reads):
        raise AssertionError(f"[slice13] the quarantined bin {qb} was read again or answered "
                             f"{got2}")
    if st.clear_spill_quarantine(qb) != [qb] or ds.count(name, q_small) != small:
        raise AssertionError("[slice13] the repaired bin's answers differ from the healthy ones")
    log(f"[slice13] one byte flipped in bin {qb}'s lake file (row group {g}'s c/geom__x "
        f"blob): the 2-degree count skipped it ({partial.skipped[0].source}, phase "
        f"{partial.skipped[0].phase}) with {got1} of {small} rows, quarantined; the next count "
        f"skipped it again ({again.skipped[0].source}) with {len(reads)} lake reads, none of "
        f"bin {qb}; byte restored, clear_spill_quarantine, the count equals the healthy one")

    # 4. spill retries: two transient OSErrors at index.spill.store, on a
    # one-row partition of its own (a week past the data), so the write
    # retried is one small snapshot
    day = "2021-01-06"
    row = {"geom__x": np.array([S13_ROW_XY[0]]), "geom__y": np.array([S13_ROW_XY[1]]),
           "dtg": np.array([f"{day}T12:00:00"], "datetime64[ms]"),
           "weight": np.array([0.5], np.float32)}
    if st.ft.has("tag"):  # slice 9's update_schema added it
        row["tag"] = np.array([0], np.int32)
    ds.insert(name, row, fids=["s13_row"])
    ds.flush(name)
    b = int(st.binned.to_bin_and_offset(row["dtg"].astype(np.int64))[0][0])
    spills = st.spills
    with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults() as inj:
        rule = inj.fail("index.spill.store", OSError("transient write error"), times=2,
                        where=lambda c: c.get("bin") == b)
        t0 = time.perf_counter()
        with st._part_lock:
            st._spill(b)
        spill_s = time.perf_counter() - t0
    spilled = b in st.spilled and b not in st.partitions
    x0, y0 = S13_ROW_XY
    q_row = (f"BBOX(geom, {x0 - 0.01}, {y0 - 0.01}, {x0 + 0.01}, {y0 + 0.01}) AND "
             f"dtg DURING {day}T00:00:00Z/{day}T23:59:59Z")
    n_row = ds.count(name, q_row)
    if rule.hits != 2 or not spilled or st.spills != spills + 1 or n_row != 1:
        raise AssertionError(f"[slice13] spill retries: {rule.hits} faults, bin {b} spilled "
                             f"{spilled}, writes {st.spills - spills}, row read back {n_row}")
    log(f"[slice13] a one-row partition {b}, spilled through two transient OSErrors at "
        f"index.spill.store in {spill_s:.3f} s: one snapshot write, the partition spilled, "
        f"the row read back")
    log(f"[slice13] the phase took {time.perf_counter() - t_phase - s14[1]:.3f} s "
        f"(slice 14's part apart)")
    return launches, s14


def slice13_flat(ds, name="gdelt"):
    """``geomesa.query.timeout`` 0ms on slice 1's flat store: count and the
    512x512 density raise ``QueryTimeoutError``, under ``allow_partial()``
    too."""
    from geomesa_tpu_torch import config, resilience
    from geomesa_tpu_torch.resilience import QueryTimeoutError

    q = f"{BOX} AND {DURING}"
    outcomes = []
    for partial in (False, True):
        for key, fn in (("count", lambda: ds.count(name, q)),
                        ("density", lambda: ds.density(name, q, bbox=QUERY_BBOX, width=WIDTH,
                                                       height=HEIGHT))):
            with config.QUERY_TIMEOUT.scoped("0ms"), \
                    (resilience.allow_partial() if partial else contextlib.nullcontext()):
                try:
                    fn()
                except QueryTimeoutError:
                    outcomes.append(key)
                    continue
            raise AssertionError(f"[slice13] flat {key} answered under a 0 ms timeout")
    log(f"[slice13] flat store, geomesa.query.timeout 0ms: {outcomes} raised "
        "QueryTimeoutError, strict and under allow_partial()")


def s13_join(ds, kw, healthy):
    """One degraded ``join_spatial`` (``kw``, slice 7's stations join) with
    its largest tile section (by padded pair slots) failing: the section is
    skipped under ``allow_partial()``, and the pairs are the healthy join's
    that the other sections and the brute ranges test. Each candidate pair
    is tested in exactly one of them, so the oracle reads only the
    surviving ones' candidates."""
    from geomesa_tpu_torch import resilience
    from geomesa_tpu_torch.planning import join_exec

    real = join_exec._run_slice
    failed = []

    def failing(plan, sec, *a, **k):
        big = max(plan.sections, key=lambda t: t.n_tiles * t.Bp * t.Pp)
        if sec is big and not failed:
            failed.append((plan, sec))
            raise RuntimeError("injected tile failure")
        return real(plan, sec, *a, **k)

    join_exec._run_slice = failing
    try:
        with resilience.allow_partial() as partial:
            res = ds.join_spatial("pickups", "stations", **kw)
    finally:
        join_exec._run_slice = real
    if not failed:
        raise AssertionError("[slice13] the stations join ran no tile section")
    plan, sec = failed[0]
    R = healthy._rbatch.n
    cand = [np.zeros(0, np.int64)]
    for t in plan.sections:
        if t is sec or not t.n_tiles:
            continue
        # every (left, right) slot of the tiles within their valid counts
        ok = ((np.arange(t.Bp)[None, :, None] < t.l_valid[:, None, None])
              & (np.arange(t.Pp)[None, None, :] < t.r_valid[:, None, None]))
        cand.append((t.l_rows.astype(np.int64)[:, :, None] * R
                     + t.r_rows.astype(np.int64)[:, None, :])[ok])
    if plan.n_brute:
        cand.append(plan.brute_l.astype(np.int64) * R + plan.brute_r.astype(np.int64))
    keys = healthy.pairs[:, 0] * R + healthy.pairs[:, 1]
    want = healthy.pairs[np.isin(keys, np.concatenate(cand))]
    label = f"tiles[0:{sec.n_tiles}]"
    if res.stats.skipped != [label] or [s.part for s in partial.skipped] != [label] \
            or not np.array_equal(res.pairs, want) or not res.count == len(want) < healthy.count:
        raise AssertionError(f"[slice13] degraded stations join: skipped {res.stats.skipped}, "
                             f"{len(res.pairs)} pairs, oracle {len(want)}")
    log(f"[slice13] stations join with its {sec.strategy} section ({sec.n_tiles} tiles) "
        f"failing: skipped {res.stats.skipped}, {res.count} of {healthy.count} pairs, equal "
        f"to the healthy pairs that the other sections and the brute ranges test")


# ---------------------------------------------------------------------------
# slice 14: span tracing, the cost ledger, the audit log, guards, explain
# ---------------------------------------------------------------------------

#: preorder span names of each main-path call traced warm (the compacted
#: layout, its column slabs already gathered): the CPU tests fix the same
#: lists on a small compacted store (tests/test_torch_trace.py)
S14_SPANS = {
    "count_bbox": ["count", "plan", "scan.kernel", "scan.sync"],
    "density": ["density", "plan", "scan.kernel", "scan.sync"],
    "density_weighted": ["density", "plan", "scan.kernel", "scan.sync"],
    "count_polygon": ["count", "plan", "scan.kernel", "scan.sync"],
}
#: explain(analyze=True)'s sections, in order
S14_SECTIONS = ["Planning 'gdelt' query", "Aggregate cache", "Hierarchy", "Warm path",
                "Observability", "Selectivity (analyze)", "Cost"]
#: warm traced / untraced count pairs for the overhead p50s
S14_OVERHEAD_REPS = 40
#: the phase's budget, its flat and partitioned parts together
S14_BUDGET_S = 15.0
S14_GUARD_MSG = ("full-table scan blocked (geomesa.scan.block-full-table=true); "
                 "add spatial/temporal/attribute predicates")


def span_names(trace) -> list:
    """Preorder span names of a finished trace."""
    out = []

    def walk(s):
        out.append(s.name)
        for c in s.children:
            walk(c)

    walk(trace.root)
    return out


@contextlib.contextmanager
def kernel_spans(kpip, kgrouped, tracing):
    """The span current at each launch of pip and density_grouped while
    the scope runs (``{"pip": [...], "density_grouped": [...]}``): the
    wrappers pass through to the kernels and are put back on exit."""
    seen = {"pip": [], "density_grouped": []}
    real_pip, real_dg = kpip.pip_mask, kgrouped.density_grouped

    def pip_mask(*a, **k):
        seen["pip"].append(getattr(tracing.current_span(), "name", None))
        return real_pip(*a, **k)

    def density_grouped(*a, **k):
        seen["density_grouped"].append(getattr(tracing.current_span(), "name", None))
        return real_dg(*a, **k)

    kpip.pip_mask, kgrouped.density_grouped = pip_mask, density_grouped
    try:
        yield seen
    finally:
        kpip.pip_mask, kgrouped.density_grouped = real_pip, real_dg


def s14_host_profile(torch, fn, n: int, top: int = 8):
    """``n`` warm calls under cProfile: the ``top`` functions by own time,
    as (name (file:line), ms a call)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    prof.disable()
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [(f"{f[2]} ({Path(f[0]).name}:{f[1]})", round(v[2] * 1e3 / n, 4)) for f, v in rows]


def slice14(torch, ds, calls, want, kpip, kgrouped, n_bbox, name="gdelt"):
    """The slice-14 phase on slice 1's flat store after slice 13's (see the
    module docstring, 15): ``calls`` are the main path's four calls,
    ``want`` their oracle-checked answers. Returns (launches, wall s, the
    count's warm p50s untraced / traced)."""
    import tempfile

    from geomesa_tpu_torch import audit, config, metrics, tracing

    t_phase = time.perf_counter()
    q_bbox = f"{BOX} AND {DURING}"
    kpip.launches = 0
    kgrouped.launches = 0
    # 1. the main path traced: answers, span trees, launches under spans
    with kernel_spans(kpip, kgrouped, tracing) as seen:
        for key, fn in calls.items():
            plain = fn()  # warm: the traced call finds its slabs gathered
            with config.TRACE_ENABLED.scoped("true"):
                got = fn()
            tr = tracing.last_trace()
            if key == "density_weighted":  # float atomics: rtol 1e-4
                same = (np.allclose(got, plain, rtol=1e-4, atol=1e-3)
                        and np.allclose(got, want[key], rtol=1e-4, atol=1e-3))
            elif isinstance(got, np.ndarray):
                same = np.array_equal(got, plain) and np.array_equal(got, want[key])
            else:
                same = got == plain == want[key]
            if not same:
                raise AssertionError(f"[slice14] traced {key} differs from the untraced call "
                                     f"or the oracle-checked answer")
            names = span_names(tr)
            if names != S14_SPANS[key]:
                raise AssertionError(f"[slice14] {key} spans {names}, want {S14_SPANS[key]}")
            log(f"[slice14] {key}: traced = untraced = oracle; spans {names}; trace "
                f"{tr.trace_id} {tr.root.duration_ms:.3f} ms")
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    for k, names in seen.items():
        traced = [n for n in names if n is not None]
        if not traced or set(traced) != {"scan.kernel"}:
            raise AssertionError(f"[slice14] {k} launched under spans {names}")
    log(f"[slice14] launches {launches}; under tracing each launch sat in a scan.kernel "
        f"span ({ {k: len([n for n in v if n]) for k, v in seen.items()} } traced launches)")

    # 2. the reference's trace_overhead_pct: the count's warm p50, traced
    # against untraced, in turns (untraced, traced, traced, untraced)
    count = calls["count_bbox"]
    walls = {False: [], True: []}
    for _ in range(S14_OVERHEAD_REPS // 2):
        for on in (False, True, True, False):
            with config.TRACE_ENABLED.scoped(str(on).lower()):
                walls[on].append(timed(torch, count)[1] * 1e3)
    p50_off, p50_on = (float(np.median(walls[k])) for k in (False, True))
    pct = (p50_on - p50_off) / p50_off * 100.0
    log(f"[slice14] warm count p50 untraced {p50_off:.6f} ms, traced {p50_on:.6f} ms "
        f"({len(walls[True])} calls each, in turns): trace overhead {pct:.3f}%"
        + (" (over 5%: a finding, not a failure)" if pct > 5.0 else ""))
    # where the difference goes: the span API alone (a root and the count's
    # three children, no query), and each mode's host profile over 20 calls
    def skeleton():
        with tracing.start("count", schema=name):
            for span_name in ("plan", "scan.kernel", "scan.sync"):
                with tracing.span(span_name):
                    pass

    with config.TRACE_ENABLED.scoped("true"):
        t0 = time.perf_counter()
        for _ in range(2000):
            skeleton()
        skel_us = (time.perf_counter() - t0) / 2000 * 1e6
    log(f"[slice14] the span API alone: {skel_us:.3f} us a trace of 4 spans (host)")
    for on in (False, True):
        with config.TRACE_ENABLED.scoped(str(on).lower()):
            log(f"[slice14] host profile of 20 warm counts, traced {on}: "
                f"{s14_host_profile(torch, count, 20)}")

    # 3. explain(analyze=True) of the main box
    with config.TRACE_ENABLED.scoped("true"):
        text = ds.explain(name, q_bbox, analyze=True)
    heads = [ln for ln in text.splitlines() if not ln.startswith(" ")]
    if heads != S14_SECTIONS or f"  Matched: {n_bbox}" not in text.splitlines():
        raise AssertionError(f"[slice14] explain sections {heads} or its match count")
    log("[slice14] explain(analyze=True):\n" + text)

    # 4. the audit JSONL and the slow-query log: one event per call with its
    # trace id, and one slow tree per call at geomesa.trace.slow.ms 0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "audit.jsonl"
        ids = []
        with config.TRACE_ENABLED.scoped("true"), config.AUDIT_PATH.scoped(str(path)), \
                config.TRACE_SLOW_MS.scoped("0"):
            for fn in calls.values():
                fn()
                ids.append(tracing.last_trace().trace_id)
        audit._appender.reset()
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    events = [r["hints"]["trace_id"] for r in recs if "hints" in r]
    slow = [r["trace_id"] for r in recs if r.get("kind") == "slow_trace"]
    if events != ids or slow != ids:
        raise AssertionError(f"[slice14] audit file trace ids {events}, slow {slow}, want {ids}")
    log(f"[slice14] audit file: {len(events)} QueryEvents and {len(slow)} slow-query trees, "
        f"one each per call, carrying the calls' trace ids")

    # 5. the full-table-scan guard: refused before any dispatch
    d0 = metrics.registry().counter(metrics.EXEC_DEVICE_DISPATCH).value
    with config.BLOCK_FULL_TABLE_SCANS.scoped("true"):
        try:
            ds.count(name, "INCLUDE")
        except ValueError as e:
            msg = str(e)
        else:
            raise AssertionError("[slice14] count(INCLUDE) passed the full-table-scan guard")
    delta = metrics.registry().counter(metrics.EXEC_DEVICE_DISPATCH).value - d0
    if msg != S14_GUARD_MSG or delta:
        raise AssertionError(f"[slice14] guard: {msg!r}, dispatch delta {delta}")
    log(f"[slice14] geomesa.scan.block-full-table: count(INCLUDE) raised ValueError "
        f"{msg!r}; exec.device.dispatch delta {delta}")
    wall = time.perf_counter() - t_phase
    log(f"[slice14] the flat part took {wall:.3f} s")
    return launches, wall, (p50_off, p50_on)


def s14_partitioned(torch, ds, name, q_b, dead, q_dead, kpip, kgrouped):
    """Slice 14's part on slice 5's store, inside slice 13's phase: a
    traced count of B (a ``scan.partition`` span per partition scanned,
    the prefetch worker's ``scan.stage`` spans, the pruning and lake
    costs), then one count of ``q_dead`` with bin ``dead`` failing, traced
    under ``allow_partial()``: the trace is degraded and one
    ``DegradationEvent`` names the bin. Returns (launches, wall s)."""
    from geomesa_tpu_torch import audit, config, resilience, tracing

    t_phase = time.perf_counter()
    kpip.launches = 0
    kgrouped.launches = 0
    st = ds._store(name)
    with config.TRACE_ENABLED.scoped("true"):
        n = ds.count(name, q_b)
    tr = tracing.last_trace()
    names = span_names(tr)
    path = ds._plan(name, q_b).exec_path
    cost = tr.cost
    scanned = int(cost.get("partitions_scanned", 0))
    lake = path.get("lake")
    loaded = int(lake.split(", ")[1].split("/")[0]) if lake else 0
    # an emptied partition (slice 9's age_off) is pruned in but not scanned
    if (names.count("scan.partition") != len(path["partitions"])
            or scanned != path["partitions_scanned"]
            or scanned + int(cost["partitions_pruned"]) != len(st.partition_bins())
            or int(cost.get("lake_bytes_read", 0)) != loaded
            or (scanned >= 2 and "scan.stage" not in names)):
        raise AssertionError(f"[slice14] B's traced count: spans {names}, cost {cost}, "
                             f"exec_path {path}")
    log(f"[slice14] B's traced count {n}: {names.count('scan.partition')} scan.partition, "
        f"{names.count('scan.stage')} scan.stage spans; cost {cost}; lake {lake}")
    d0 = len(audit.degradations.events)
    with config.TRACE_ENABLED.scoped("true"), config.FAULT_INJECTION.scoped("true"), \
            resilience.inject_faults(seed=14) as inj:
        inj.fail("exec.partition.scan", times=None, where=lambda c: c.get("bin") == dead)
        with resilience.allow_partial():
            ds.count(name, q_dead)
    tr = tracing.last_trace()
    evs = list(audit.degradations.events)[d0:]
    if not tr.degraded or [e.part for e in evs] != [f"bin:{dead}"]:
        raise AssertionError(f"[slice14] degraded count: trace degraded {tr.degraded}, "
                             f"events {evs}")
    log(f"[slice14] the degraded count's trace is marked degraded; one DegradationEvent "
        f"({evs[0].source}, {evs[0].part}, phase {evs[0].phase})")
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    wall = time.perf_counter() - t_phase
    log(f"[slice14] the partitioned part took {wall:.3f} s; launches {launches}")
    return launches, wall


#: slice 15's export sampling, warm repetitions, overhead turns and budget
S15_SAMPLE_RATE = "0.5"
S15_SAMPLE_SEED = "15"
S15_WARM = 5
S15_PROFILED = 5
S15_OVERHEAD_REPS = 40
S15_BUDGET_S = 60.0


def _otlp_plain(v):
    """An OTLP attribute value as the value it encodes."""
    if "intValue" in v:
        return int(v["intValue"])
    return next(iter(v.values()))


def otlp_trees(spans):
    """trace id (16 hex) -> the exported span tree as nested
    ``{"name", "attrs", "children"}``, by parent links."""
    nodes, roots = {}, {}
    for sp in spans:
        nodes[sp["spanId"]] = {"name": sp["name"], "children": [], "attrs": {
            a["key"]: _otlp_plain(a["value"]) for a in sp.get("attributes", ())}}
    for sp in spans:
        parent = sp.get("parentSpanId")
        if parent:
            nodes[parent]["children"].append(nodes[sp["spanId"]])
        else:
            roots[sp["traceId"][:16]] = nodes[sp["spanId"]]
    return roots


def tree_shape(node):
    """(name, attributes as strings, children) of an OTLP or finished-trace
    tree; the exporter's ``geomesa.*`` root attributes left out."""
    attrs = sorted((k, str(v)) for k, v in (node.get("attrs") or {}).items()
                   if not k.startswith("geomesa."))
    return (node["name"], attrs, [tree_shape(c) for c in node.get("children", ())])


def profiler_busy_ms(torch, fn, n: int, trace_path: Path):
    """(results, busy ms) of ``n`` calls under one ``torch.profiler``
    session, each ending synchronized: the union of the kernel, memcpy and
    memset intervals of its trace. (A session of one short call can come
    back without its device events.)"""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = []
        for _ in range(n):
            out.append(fn())
            torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for s0, s1 in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    return out, busy / 1e3


def _s15_same(key, got, want) -> bool:
    if key == "density_weighted":  # float atomics: rtol 1e-4
        return bool(np.allclose(got, want, rtol=1e-4, atol=1e-3))
    if isinstance(got, np.ndarray):
        return bool(np.array_equal(got, want))
    return got == want


def slice15(torch, ds, calls, want, kpip, kgrouped, name="gdelt"):
    """The slice-15 phase on slice 1's flat store after slice 14's flat part
    (see the module docstring, 16): ``calls`` are the main path's four
    calls, ``want`` their oracle-checked answers. Returns (launches, wall
    s, a dict of the phase's numbers)."""
    import shutil
    import tempfile
    import urllib.request

    from geomesa_tpu_torch import config, metrics, obs, resilience, tracing, tracing_export
    from geomesa_tpu_torch import utilization
    from geomesa_tpu_torch.kernels import registry as kreg

    t_phase = time.perf_counter()
    queries = {"count_bbox": f"BBOX(geom, {', '.join(str(v) for v in QUERY_BBOX)}) AND {DURING}",
               "count_polygon": f"INTERSECTS(geom, {polygon_wkt()}) AND {DURING}"}
    queries["density"] = queries["density_weighted"] = queries["count_bbox"]
    kpip.launches = 0
    kgrouped.launches = 0
    tracing_export.reset()
    resilience.reset_breakers()
    utilization.reset()
    kreg.reset_alert()
    # a fresh registry: the four calls build their callables again
    ds._store(name).__dict__["_kernel_registry"] = kreg.KernelRegistry()
    reg = ds._executor(name).kernel_registry()
    tmp = Path(tempfile.mkdtemp(prefix="geomesa_s15_"))
    sink = tmp / "spans.jsonl"
    rebuilds = metrics.registry().counter(metrics.KERNEL_RECOMPILES)
    rows, kept_want = [], {}
    out = {}
    try:
        with config.TRACE_ENABLED.scoped("true"), config.TRACE_EXPORT_PATH.scoped(str(sink)),                 config.TRACE_SAMPLE_RATE.scoped(S15_SAMPLE_RATE),                 config.TRACE_SAMPLE_SEED.scoped(S15_SAMPLE_SEED):
            # 1. cold, then warm: registry builds, device_ms, answers
            for rnd in range(1 + S15_WARM):
                for key, fn in calls.items():
                    r0 = rebuilds.value
                    got = fn()
                    tr = tracing.last_trace()
                    builds = rebuilds.value - r0
                    path = ds._plan(name, queries[key]).exec_path
                    dev_ms = tr.cost.get("device_ms.0", 0.0)
                    wall = tr.root.duration_ms
                    if not _s15_same(key, got, want[key]):
                        raise AssertionError(f"[slice15] {key} differs from the oracle-checked answer")
                    if rnd == 0 and not (builds >= 1 and path.get("kernel") == "trace"
                                         and tr.recompiles == builds):
                        raise AssertionError(f"[slice15] cold {key}: {builds} builds, "
                                             f"kernel note {path.get('kernel')}, "
                                             f"{tr.recompiles} recompile events")
                    if rnd > 0 and not (builds == 0 and path.get("kernel") == "hit"
                                        and tr.recompiles == 0):
                        raise AssertionError(f"[slice15] warm {key}: {builds} builds, "
                                             f"kernel note {path.get('kernel')}")
                    if not 0.0 < dev_ms <= wall:
                        raise AssertionError(f"[slice15] {key}: device_ms.0 {dev_ms} outside "
                                             f"(0, wall {wall}]")
                    kept_want[tr.trace_id] = "recompile" if rnd == 0 else (
                        "sampled" if tracing_export.sampled_in(tr.trace_id) else None)
                    rows.append((rnd, key, tr.trace_id, builds, dev_ms, wall))
                    if rnd == 0:
                        log(f"[slice15] cold {key}: {builds} build(s), exec_path kernel notes "
                            f"{ {k: v for k, v in path.items() if k.startswith(('kernel', 'shape'))} }, "
                            f"device_ms.0 {dev_ms:.6f} of wall {wall:.6f} ms")
            tracing_export.flush()
        for key in calls:
            mine = [r for r in rows if r[1] == key and r[0] > 0]
            log(f"[slice15] warm {key} x{len(mine)}: device_ms.0 "
                f"{[round(r[4], 6) for r in mine]} ms of walls {[round(r[5], 6) for r in mine]} ms")
        traces = reg.traces()
        alert = metrics.registry().gauge(metrics.KERNEL_RECOMPILE_ALERT).value
        if sum(traces.values()) != len(calls) or alert != 0:
            raise AssertionError(f"[slice15] registry builds {traces} (want one per call) "
                                 f"or alert {alert}")
        log(f"[slice15] registry: builds by site {traces}, {len(reg)} entries, evictions "
            f"{reg.evicts()}, alert gauge {alert}")

        # 2. the file sink against the retained traces
        spans = [sp for ln in sink.read_text().splitlines()
                 for sp in json.loads(ln)["resourceSpans"][0]["scopeSpans"][0]["spans"]]
        trees = otlp_trees(spans)
        want_ids = {t for t, why in kept_want.items() if why}
        if set(trees) != want_ids:
            raise AssertionError(f"[slice15] exported {sorted(trees)}, want {sorted(want_ids)}")
        for tid in want_ids:
            rec = tracing.finished_trace(tid)
            got_keep = trees[tid]["attrs"].get("geomesa.keep")
            if tree_shape(trees[tid]) != tree_shape(rec["tree"]) or got_keep != kept_want[tid]:
                raise AssertionError(f"[slice15] exported tree {tid} ({got_keep}) differs from "
                                     f"the retained trace ({kept_want[tid]})")
        n_warm = len(rows) - len(calls)
        n_warm_kept = sum(1 for t, why in kept_want.items() if why == "sampled")
        log(f"[slice15] file sink: {len(trees)} traces, {len(spans)} spans; the {len(calls)} "
            f"cold calls kept as recompile, {n_warm_kept} of {n_warm} warm calls as sampled "
            f"(sampled_in at rate {S15_SAMPLE_RATE}, seed {S15_SAMPLE_SEED}); every tree "
            f"equals its retained trace")
        out["exported"] = (len(trees), n_warm_kept, n_warm)

        # 2b. the count's warm p50 untraced, traced with export off and traced
        # with export on, in turns, before any profiler session of the phase
        count = calls["count_bbox"]
        modes = ("untraced", "export off", "export on")

        def turns(when):
            walls = {m: [] for m in modes}
            with config.TRACE_SAMPLE_RATE.scoped(S15_SAMPLE_RATE), \
                    config.TRACE_SAMPLE_SEED.scoped(S15_SAMPLE_SEED):
                for _ in range(S15_OVERHEAD_REPS // 2):
                    for m in modes + modes[::-1]:
                        with config.TRACE_ENABLED.scoped("false" if m == "untraced" else "true"), \
                                config.TRACE_EXPORT_PATH.scoped(str(sink) if m == "export on" else ""):
                            walls[m].append(timed(torch, count)[1] * 1e3)
                tracing_export.flush()
            p50 = {m: float(np.median(walls[m])) for m in modes}
            log(f"[slice15] warm count p50 {when}: untraced {p50['untraced']:.6f} ms, traced "
                f"export off {p50['export off']:.6f} ms, export on {p50['export on']:.6f} ms "
                f"({len(walls['untraced'])} calls each, in turns): tracing adds "
                f"{(p50['export off'] - p50['untraced']) * 1e3:.3f} us, export "
                f"{(p50['export on'] - p50['export off']) * 1e3:.3f} us")
            return p50

        out["turns_before"] = turns("before the profiler sessions")

        # 3. device_ms.0 against the profiler's busy union of the same calls
        prof_dir = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke"
        ratios = {}
        with config.TRACE_ENABLED.scoped("true"):
            for key, fn in calls.items():
                ids = []

                def traced_call(fn=fn, ids=ids):
                    out = fn()
                    ids.append(tracing.last_trace())
                    return out

                _, union = profiler_busy_ms(torch, traced_call, S15_PROFILED,
                                            prof_dir / f"s15_{key}.json")
                dev_ms = sum(tr.cost["device_ms.0"] for tr in ids)
                wall = sum(tr.root.duration_ms for tr in ids)
                ratios[key] = (dev_ms / len(ids), union / len(ids), wall / len(ids))
                log(f"[slice15] {key} under the profiler, {len(ids)} calls: device_ms.0 "
                    f"{dev_ms / len(ids):.6f} ms a call, busy union {union / len(ids):.6f} "
                    f"(ratio {dev_ms / union if union else math.inf:.4f}), wall "
                    f"{wall / len(ids):.6f}")
                if not (0.0 < union and 0.9 * union <= dev_ms <= wall):
                    raise AssertionError(f"[slice15] {key}: device_ms.0 {dev_ms} not in "
                                         f"[0.9 x busy union {union} > 0, wall {wall}]")
        out["device_ms"] = ratios
        busy = metrics.registry().gauge("device.busy.0").value
        if not 0.0 < busy <= 1.0:
            raise AssertionError(f"[slice15] device.busy.0 {busy}")
        usage = utilization.snapshot()["devices"]["0"]
        log(f"[slice15] device.busy.0 {busy}; /debug/devices totals {usage}")

        # 4. the endpoints through obs.handle
        card = torch.cuda.get_device_name(0)
        code, _, body = obs.handle("/healthz", ds)
        h = json.loads(body)
        if code != 200 or h["status"] != "ok" or card not in (h["device"].get("devices") or ()):
            raise AssertionError(f"[slice15] /healthz {code}: {h}")
        resilience.breaker("trace.otlp", threshold=1).record_failure()
        code_open, _, body = obs.handle("/healthz", ds)
        if code_open != 503 or json.loads(body)["open_breakers"] != ["trace.otlp"]:
            raise AssertionError(f"[slice15] /healthz with trace.otlp open: {code_open}")
        resilience.reset_breakers()
        code_back = obs.handle("/healthz", ds)[0]
        if code_back != 200:
            raise AssertionError(f"[slice15] /healthz after the reset: {code_back}")
        log(f"[slice15] /healthz {code} (devices {h['device']['devices']}, mesh {h['mesh']}), "
            f"{code_open} with trace.otlp forced open, {code_back} after reset_breakers")
        code, ctype, body = obs.handle("/metrics", ds)
        text = body.decode()
        metric_names = set()
        for line in text.splitlines():
            mname, _, value = line.rpartition(" ")
            float(value)  # every sample line ends in a number
            metric_names.add(mname.split("{")[0])
        need = ("geomesa_kernel_recompiles", "geomesa_device_busy_0",
                "geomesa_trace_count_seconds_bucket", "geomesa_trace_scan_kernel_seconds_bucket")
        if code != 200 or not ctype.startswith("text/plain") or not all(
                n in metric_names for n in need):
            raise AssertionError(f"[slice15] /metrics {code} {ctype}: missing "
                                 f"{[n for n in need if n not in metric_names]}")
        code_dev, _, body = obs.handle("/debug/devices", ds)
        devs = json.loads(body)
        tid = rows[-1][2]
        code_q, _, qbody = obs.handle(f"/debug/queries?trace={tid}", ds)
        if code_dev != 200 or "0" not in devs["devices"] or code_q != 200                 or json.loads(qbody)["trace_id"] != tid:
            raise AssertionError(f"[slice15] /debug/devices {code_dev}, /debug/queries "
                                 f"?trace= {code_q}")
        log(f"[slice15] /metrics {code}: {len(text.splitlines())} lines, {len(metric_names)} "
            f"series; /debug/devices {code_dev} (health {devs['health']}); "
            f"/debug/queries?trace={tid} {code_q}")

        # 5. one obs.serve round trip on 127.0.0.1
        srv = obs.serve(ds, host="127.0.0.1", port=0, background=True)
        try:
            port = srv.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                served = (r.status, json.loads(r.read())["status"])
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                served += (r.status, len(r.read()))
        finally:
            srv.shutdown()
            srv.server_close()
        if served[0] != 200 or served[1] != "ok" or served[2] != 200:
            raise AssertionError(f"[slice15] obs.serve round trip {served}")
        log(f"[slice15] obs.serve on 127.0.0.1:{port}: /healthz {served[0]} {served[1]}, "
            f"/metrics {served[2]} ({served[3]} B)")

        # 6. the same turns after the profiler sessions and the endpoints
        out["turns_after"] = turns("after the profiler sessions")
    finally:
        tracing_export.reset()
        resilience.reset_breakers()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"[slice15] a main-path kernel never launched: {launches}")
    wall = time.perf_counter() - t_phase
    log(f"[slice15] launches {launches}; the phase took {wall:.3f} s")
    if wall > S15_BUDGET_S:
        raise AssertionError(f"[slice15] the phase took {wall:.3f} s, over its {S15_BUDGET_S} s")
    return launches, wall, out



#: the slice-16 phase's own budget (seconds), checked like slice 15's
S16_BUDGET_S = 60.0
#: rows of the s3 store (GDELT-like: make_data's distribution)
S16_ROWS = 10_000_000
#: the floor the phase cuts the s3 store to, never below
S16_MIN_ROWS = 2_000_000
#: seconds of the phase's budget the s3 store's ingest may take; the rows
#: are cut (to no less than S16_MIN_ROWS) when a sample's encode rate
#: says it would take longer
S16_INGEST_S = 24.0
S16_SPEC = "weight:Float,dtg:Date,*geom:Point;geomesa.indices='s3,id'"
S16_JSON_ROWS = 100_000
S16_JSON_SPEC = "props:Json,dtg:Date,*geom:Point"
S16_JSON_BOX = (-100.0, 30.0, -90.0, 40.0)
S16_REPS = 5


def s16_rows(torch) -> int:
    """The s3 store's rows: S16_ROWS, cut (each cut printed) while the S2
    encode rate of a 200,000-point sample says the ingest would outrun
    S16_INGEST_S."""
    from geomesa_tpu_torch.curves import s2

    sample = make_data(200_000, 1601)
    t0 = time.perf_counter()
    s2.lnglat_to_id(sample["geom__x"], sample["geom__y"])
    per_row = (time.perf_counter() - t0) / 200_000
    # the key encode is about 80% of a flush (the rest: fid hashes,
    # sketches, the pack sort), measured on slice 16's own store
    rows = S16_ROWS
    while rows > S16_MIN_ROWS and rows * per_row / 0.8 > S16_INGEST_S:
        cut = max(S16_MIN_ROWS, rows // 2)
        log(f"[slice16] cut: {cut} s3 rows instead of {rows} (S2 encode "
            f"{per_row * 1e6:.3f} us a point: {rows * per_row:.3f} s to encode)")
        rows = cut
    return rows


def slice16(args, torch, ds, data, results, paths, wkt, packed, n_edges, kpip, kgrouped,
            n_bbox, name="gdelt"):
    """The slice-16 phase (see the module docstring, 17): an s3 store, the
    einsum density rung on the main path's store, a jsonPath query and two
    knob scopes on the main path. ``results`` / ``paths`` are the main
    path's oracle-checked answers and exec_paths. Returns (launches, wall
    s)."""
    from geomesa_tpu_torch import GeoDataset, Query, config
    from geomesa_tpu_torch.kernels import density_mxu as kmxu
    from geomesa_tpu_torch.kernels.density import density_grid

    t_phase = time.perf_counter()
    kpip.launches = 0
    kgrouped.launches = 0
    q_bbox = f"BBOX(geom, {', '.join(str(v) for v in QUERY_BBOX)}) AND {DURING}"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    grid = dict(bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    if tf32 != (False, "highest"):
        raise AssertionError(f"[slice16] float32 matmuls are not at full precision: {tf32}")

    # 1. the main density on its grouped rung, then on the einsum rung
    # with the grouped one off
    g_g, cold_g = timed(torch, lambda: ds.density(name, q_bbox, **grid))
    warm_g = [timed(torch, lambda: ds.density(name, q_bbox, **grid))[1]
              for _ in range(S16_REPS)]
    kern_g = ds._plan(name, q_bbox).exec_path.get("density_kernel")
    if kern_g != "grouped" or not np.array_equal(g_g, results["density"]):
        raise AssertionError(f"[slice16] the main density took {kern_g!r} or changed")
    with config.DENSITY_PALLAS.scoped("false"):
        g_e, cold_e = timed(torch, lambda: ds.density(name, q_bbox, **grid))
        kern = ds._plan(name, q_bbox).exec_path.get("density_kernel")
        g_ew = ds.density(name, q_bbox, weight="weight", **grid)
        warm_e = [timed(torch, lambda: ds.density(name, q_bbox, **grid))[1]
                  for _ in range(S16_REPS)]
    if kern != "mxu-einsum":
        raise AssertionError(f"[slice16] the main density took {kern!r}, not the einsum rung")
    if not np.array_equal(g_e, results["density"]):
        bad = int((g_e != results["density"]).sum())
        raise AssertionError(f"[slice16] the einsum grid differs from the grouped kernel's "
                             f"(and the oracle's) in {bad} cells")
    if not np.allclose(g_ew, results["density_weighted"], rtol=1e-4, atol=1e-3):
        raise AssertionError("[slice16] the weighted einsum grid is outside rtol 1e-4")
    log(f"[slice16] einsum rung on the main path (geomesa.density.pallas=false): "
        f"density_kernel {kern}; unweighted grid bit-equal to the grouped kernel's and the "
        f"oracle ({int(g_e.sum())} rows), weighted within rtol 1e-4 (max abs diff "
        f"{float(np.abs(g_ew - results['density_weighted']).max())}); cold "
        f"{cold_e * 1e3:.3f} ms, warm p50 {float(np.median(warm_e)) * 1e3:.3f} ms against the "
        f"grouped rung's {cold_g * 1e3:.3f} / {float(np.median(warm_g)) * 1e3:.3f} ms; matmul "
        f"allow_tf32 {tf32[0]}, precision {tf32[1]!r}")

    # 2. two knob scopes on the main path, each with the plan change it causes
    b0 = paths["count_bbox"].get("B")
    b_over = 256 if b0 != 256 else 1024
    with config.COMPACT_B.scoped(b_over):
        c_b = ds.count(name, q_bbox)
        b_got = ds._plan(name, q_bbox).exec_path.get("B")
        g_b = ds.density(name, q_bbox, **grid)
        gb_kern = ds._plan(name, q_bbox).exec_path.get("density_kernel")
    if c_b != n_bbox or b_got != b_over or not np.array_equal(g_b, results["density"]):
        raise AssertionError(f"[slice16] geomesa.compact.b={b_over}: B {b_got}, count {c_b} "
                             f"(want {n_bbox})")
    log(f"[slice16] geomesa.compact.b={b_over}: exec_path B {b0} -> {b_got}; count and "
        f"grid ({gb_kern}) unchanged")
    fids = list(ds.query(name, Query(ecql=q_bbox, max_features=3)).fids)
    q_ids = f"{q_bbox} AND IN ({', '.join(repr(str(f)) for f in fids)})"
    cost = ds._plan(name, q_ids).index_name
    n_cost = ds.count(name, q_ids)
    with config.STRATEGY_DECIDER.scoped("first"):
        first = ds._plan(name, q_ids).index_name
        n_first = ds.count(name, q_ids)
    if (cost, first) != ("id", "z3") or not (n_cost == n_first == len(fids)):
        raise AssertionError(f"[slice16] geomesa.strategy.decider=first: index {cost} -> "
                             f"{first}, counts {n_cost} / {n_first} (want {len(fids)})")
    log(f"[slice16] geomesa.strategy.decider=first: index {cost} -> {first}; "
        f"count {n_first} either way")

    # 3. an s3 store of GDELT-like points
    rows = s16_rows(torch)
    d16 = make_data(rows, args.seed + 16)
    s3ds = GeoDataset(n_shards=8)
    s3ds.create_schema("gdelt16", S16_SPEC)
    t0 = time.perf_counter()
    s3ds.insert("gdelt16", d16)
    s3ds.flush("gdelt16")
    ingest_s = time.perf_counter() - t0
    st = s3ds._store("gdelt16")
    log(f"[slice16] s3 store: {rows} rows ingested in {ingest_s:.3f} s; S2 encode "
        f"{st.key_seconds['s3']:.3f} s, fid hashes {st.key_seconds['id']:.3f} s, s3 pack "
        f"sort {st.flush_seconds['s3']:.3f} s, sketches {st.flush_seconds['sketches']:.3f} s")
    calls = {
        "count_bbox": (q_bbox, lambda: s3ds.count("gdelt16", q_bbox)),
        "density": (q_bbox, lambda: s3ds.density("gdelt16", q_bbox, **grid)),
        "count_polygon": (q_poly, lambda: s3ds.count("gdelt16", q_poly)),
    }
    got, lat = {}, {}
    for key, (q, fn) in calls.items():
        got[key], cold = timed(torch, fn)
        warm = [timed(torch, fn)[1] for _ in range(S16_REPS)]
        lat[key] = (cold * 1e3, float(np.median(warm)) * 1e3)
        plan = s3ds._plan("gdelt16", q)
        chosen = [ln for ln in s3ds.explain("gdelt16", q).splitlines() if "Chosen index" in ln]
        if plan.index_name != "s3" or not chosen or "s3" not in chosen[0]:
            raise AssertionError(f"[slice16] {key} planned {plan.index_name} ({chosen})")
        log(f"[slice16] s3 {key}: cold {lat[key][0]:.3f} ms, warm p50 {lat[key][1]:.3f} ms; "
            f"exec_path {dict(plan.exec_path)}")
    tm = time_mask(d16)
    g_u, _, _, n16 = density_oracles(d16, tm)
    n16_poly = polygon_oracle(d16, tm, packed, n_edges)
    if got["count_bbox"] != n16 or not np.array_equal(got["density"].astype(np.float64), g_u):
        raise AssertionError(f"[slice16] s3 count {got['count_bbox']} (oracle {n16}) or its "
                             "grid differs from the oracle")
    if got["count_polygon"] != n16_poly:
        raise AssertionError(f"[slice16] s3 polygon count {got['count_polygon']} != f32 "
                             f"oracle {n16_poly}")
    if s3ds._plan("gdelt16", q_bbox).exec_path.get("density_kernel") != "scatter":
        raise AssertionError("[slice16] an s3 density left the scatter rung")
    dev_bytes = sum(t.device_bytes() for t in st.tables.values())
    t16 = st.tables["s3"]
    log(f"[slice16] s3 answers equal the oracles: count {n16}, grid exact, polygon "
        f"{n16_poly} (f32 even-odd); [S, L] = [{t16.n_shards}, {t16.shard_len}], device "
        f"bytes {dev_bytes}")

    # 4. a jsonPath query on a small Json schema, against a NumPy oracle
    rng = np.random.default_rng(args.seed + 160)
    jn = S16_JSON_ROWS
    kinds = np.array(["car", "truck", "bike"])[rng.integers(0, 3, jn)]
    docs = [json.dumps({"type": str(k), "speed": int(v)})
            for k, v in zip(kinds, rng.integers(0, 120, jn))]
    jd = make_data(jn, args.seed + 161)
    jds = GeoDataset(n_shards=8)
    jds.create_schema("docs", S16_JSON_SPEC)
    jds.insert("docs", {"props": docs, "dtg": jd["dtg"], "geom__x": jd["geom__x"],
                        "geom__y": jd["geom__y"]})
    jds.flush("docs")
    xmin, ymin, xmax, ymax = S16_JSON_BOX
    q_json = (f"BBOX(geom, {xmin}, {ymin}, {xmax}, {ymax}) AND "
              "jsonPath('$.type', props) = 'car'")
    (n_json, json_s) = timed(torch, lambda: jds.count("docs", q_json))
    x, y = jd["geom__x"], jd["geom__y"]
    want_json = int(((x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)
                     & (kinds == "car")).sum())
    if n_json != want_json:
        raise AssertionError(f"[slice16] jsonPath count {n_json} != oracle {want_json}")
    log(f"[slice16] jsonPath over {jn} documents: {n_json} rows, equal to the oracle, in "
        f"{json_s * 1e3:.3f} ms; exec_path {dict(jds._plan('docs', q_json).exec_path)}")

    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"[slice16] a kernel never launched in the phase: {launches}")

    # 5. kernels against their plain versions on the phase's operands (not
    # counted): pip on the s3 store's scan columns
    ex16 = s3ds._executor("gdelt16")
    cols = ex16.scan_columns(s3ds._plan("gdelt16", q_poly), ["geom__x", "geom__y"])
    px, py = cols["geom__x"], cols["geom__y"]
    edges = torch.from_numpy(packed).cuda()
    bad = int((kpip.pip_mask(px, py, edges, n_edges)
               != kpip.pip_mask_plain(px, py, edges, n_edges)).sum())
    if bad:
        raise AssertionError(f"[slice16] pip disagrees with its plain version on {bad} points "
                             "of the s3 store")
    pip_ms = cuda_ms(torch, lambda: kpip.pip_mask(px, py, edges, n_edges), 20)
    log(f"[slice16] pip on the s3 store's {tuple(px.shape)} scan points "
        f"({dict(s3ds._plan('gdelt16', q_poly).exec_path).get('scan')}): equal to its "
        f"plain version; {pip_ms:.6f} ms")
    del cols, px, py, edges
    # the three rungs on the main path's compacted operands, in turns
    ex = ds._executor(name)
    plan = ds._plan(name, q_bbox)
    setup = ex._scan_setup(plan, ["geom__x", "geom__y"])
    ex._maybe_compact(plan, setup)
    c, m = ex._fused(plan, setup, ["geom__x", "geom__y"])
    _, sched_g = ex._density_rung(plan, setup, QUERY_BBOX, WIDTH, HEIGHT)
    with config.DENSITY_PALLAS.scoped("false"):
        rung, sched_p = ex._density_rung(plan, setup, QUERY_BBOX, WIDTH, HEIGHT)
    if rung != "mxu-einsum":
        raise AssertionError(f"[slice16] no einsum schedule on the main path ({rung})")
    gx, gy = c["geom__x"], c["geom__y"]
    fns = {
        "einsum": lambda: kmxu.density_grid_pairs(gx, gy, m, QUERY_BBOX, WIDTH, HEIGHT, None,
                                                  sched_p),
        "grouped": lambda: kgrouped.density_grouped(gx, gy, m, None, QUERY_BBOX, WIDTH, HEIGHT,
                                                    sched_g),
        "scatter": lambda: density_grid(gx, gy, m, QUERY_BBOX, WIDTH, HEIGHT),
    }
    outs = {k: f() for k, f in fns.items()}
    if not (torch.equal(outs["einsum"], outs["grouped"])
            and torch.equal(outs["einsum"], outs["scatter"])):
        raise AssertionError("[slice16] the einsum, grouped and scatter grids differ")
    t = {k: [] for k in fns}
    for k in ("einsum", "grouped", "scatter", "scatter", "grouped", "einsum"):
        t[k].append(cuda_ms(torch, fns[k], 10))
    torch.cuda.synchronize()
    peak0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fns["einsum"]()
    torch.cuda.synchronize()
    peak_e = torch.cuda.max_memory_allocated() - peak0
    log(f"[slice16] the main path's {tuple(gx.shape)} compacted rows, 512x512, in turns: "
        f"einsum {np.mean(t['einsum']):.6f} ms ({sched_p['n_pairs']} pairs of "
        f"{sched_p['TY']}x{sched_p['TX']} tiles, batches of {sched_p['PB']}), grouped kernel "
        f"{np.mean(t['grouped']):.6f} ms, scatter {np.mean(t['scatter']):.6f} ms; all three "
        f"grids equal; the einsum's scratch {peak_e} B above the {peak0} B allocated")
    del c, m, gx, gy, outs, setup, sched_g, sched_p, fns
    del s3ds, jds, d16, st, t16, ex16
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[slice16] launches {launches}; the phase took {wall:.3f} s")
    if wall > S16_BUDGET_S:
        raise AssertionError(f"[slice16] the phase took {wall:.3f} s, over its {S16_BUDGET_S} s")
    return launches, wall

#: the slice-17 phase's own budget (seconds), checked like slice 16's
S17_BUDGET_S = 30.0
#: the standing part's flat store, its insert batches and their rows
S17_ROWS = 2_000_000
S17_BATCHES = 10
S17_BATCH_ROWS = 20_000
#: the standing viewports (inside CONUS) and the delete's box, which cuts
#: part of the first viewport
S17_VIEW = (-100.0, 30.0, -80.0, 45.0)
S17_VIEW2 = (-120.0, 35.0, -105.0, 47.0)
S17_DELETE = (-95.0, 33.0, -90.0, 38.0)
S17_STAT = "Count();MinMax(weight)"
S17_LEVELS = 6
S17_FUSED = 8


def s17_stall(sched, timeout: float = 60.0):
    """Occupy the dispatch thread until the returned gate opens, so the
    tickets submitted meanwhile queue and fuse."""
    import threading

    gate, started = threading.Event(), threading.Event()

    def fn():
        started.set()
        return gate.wait(timeout)

    fut = sched.submit(fn, user="stall", op="stall")
    if not started.wait(30):
        raise AssertionError("[slice17] the stall ticket never dispatched")
    return gate, fut


def s17_fused(sched, calls, user: str, spec_of):
    """Submit ``calls`` behind a stall as fusable tickets, release them and
    return (results, wall s from the release to the last result, per-ticket
    queue waits s)."""
    gate, fut = s17_stall(sched)
    waits = []
    futs = []
    try:
        for fn, opts in calls:
            spec = spec_of(opts)
            inner = spec.batch

            def batch(tickets, inner=inner):
                # the scheduler stamps each member's wait before the batch
                waits.extend(t.wait_s for t in tickets)
                return inner(tickets)

            spec.batch = batch
            t_sub = time.perf_counter()
            futs.append(sched.submit(
                lambda fn=fn, t_sub=t_sub: waits.append(time.perf_counter() - t_sub) or fn(),
                user=user, op="fused", fuse=spec))
    finally:
        t0 = time.perf_counter()
        gate.set()
        fut.result(60)
    out = [f.result(120) for f in futs]
    wall = time.perf_counter() - t0
    return out, wall, waits


def s17_grid_f64(x, y, box, width, height):
    """The standing density's pixel mapping: f64, clip-cast."""
    xmin, ymin, xmax, ymax = box
    px = np.clip(((x - xmin) / (xmax - xmin) * width).astype(np.int32), 0, width - 1)
    py = np.clip(((y - ymin) / (ymax - ymin) * height).astype(np.int32), 0, height - 1)
    return np.bincount(py * width + px, minlength=width * height).reshape(height, width)


def s17_oracles(cols, view, levels):
    """NumPy oracles of the standing viewports over the host rows: the
    count, the f64-mapped 512x512 grid, the pyramid's leaf, and
    ``Count();MinMax(weight)``."""
    x, y, w = cols["geom__x"], cols["geom__y"], cols["weight"]
    m = (x >= view[0]) & (x <= view[2]) & (y >= view[1]) & (y <= view[3])
    side = 1 << levels
    return {"count": int(m.sum()),
            "density": s17_grid_f64(x[m], y[m], view, WIDTH, HEIGHT).astype(np.float32),
            "leaf": s17_grid_f64(x[m], y[m], view, side, side).astype(np.float64),
            "stats": (int(m.sum()), float(w[m].min()), float(w[m].max()))}


def slice17(args, torch, ds, data, results, wkt, kpip, kgrouped, n_bbox, name="gdelt"):
    """The slice-17 phase (see the module docstring, 18): the serving
    scheduler on slice 1's store, then standing queries on a fresh 2M-row
    flat store. Returns (launches, wall s)."""
    from geomesa_tpu_torch import GeoDataset, config, metrics, resilience
    from geomesa_tpu_torch.serving import fuse
    from geomesa_tpu_torch.subscribe import delta as sdl

    t_phase = time.perf_counter()
    kpip.launches = 0
    kgrouped.launches = 0
    reg = metrics.registry()
    disp = reg.counter(metrics.EXEC_DEVICE_DISPATCH)
    q_bbox = f"BBOX(geom, {', '.join(str(v) for v in QUERY_BBOX)}) AND {DURING}"
    grid = dict(bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
    rng = np.random.default_rng(args.seed + 17)
    spec_of = lambda opts: fuse.make_spec(ds, opts.pop("op"), name, opts)  # noqa: E731

    # 1. 8 identical main-path counts: serial, then fused behind a stall
    serial = [timed(torch, lambda: ds.count(name, q_bbox)) for _ in range(S17_FUSED)]
    if any(r != n_bbox for r, _ in serial):
        raise AssertionError("[slice17] a serial count differs from the oracle")
    sched = ds.serving.start()
    all_waits = []
    try:
        d0 = disp.value
        out, wall, waits = s17_fused(
            sched, [(lambda: ds.count(name, q_bbox), {"op": "count", "ecql": q_bbox})
                    for _ in range(S17_FUSED)], "s17-repeat", spec_of)
        all_waits += waits
        d_rep = disp.value - d0
        if out != [n_bbox] * S17_FUSED or d_rep > 2:
            raise AssertionError(f"[slice17] fused counts {out} ({d_rep} dispatches) against "
                                 f"{n_bbox} with at most 2")
        log(f"[slice17] 8 identical main-path counts: serial "
            f"{sum(s for _, s in serial) * 1e3:.3f} ms in all (p50 "
            f"{float(np.median([s for _, s in serial])) * 1e3:.3f} ms), fused "
            f"{wall * 1e3:.3f} ms from the release to the last answer; {d_rep} dispatches; "
            f"answers bit-identical to serial and the oracle ({n_bbox})")

        # 2. 8 distinct-bbox counts and 5 distinct polygon-residual counts
        boxes = [(-100.0 + 2 * i, 30.0 + i, -92.0 + 2 * i, 38.0 + i) for i in range(S17_FUSED)]
        bq = [f"BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND {DURING}" for b in boxes]
        pq = [f"INTERSECTS(geom, {wkt}) AND BBOX(geom, {b[0]}, {b[1]}, {b[2]}, {b[3]}) AND "
              f"{DURING}" for b in s8_boxes(rng, 5, 6.0, 5.0, (-98.0, -82.0), (31.0, 44.0))]
        for label, qs in (("bbox", bq), ("polygon", pq)):
            # cold first (each member's plan), then warm: the fused group
            # plans the same texts, so it meets the warm plans
            cold = [timed(torch, lambda q=q: ds.count(name, q))[1] for q in qs]
            ser = [timed(torch, lambda q=q: ds.count(name, q)) for q in qs]
            fd0 = reg.counter(metrics.SERVING_FUSED_DISTINCT).value
            d0, p0 = disp.value, kpip.launches
            out, wall, waits = s17_fused(
                sched, [(lambda q=q: ds.count(name, q), {"op": "count", "ecql": q}) for q in qs],
                f"s17-{label}", spec_of)
            all_waits += waits
            fd = reg.counter(metrics.SERVING_FUSED_DISTINCT).value - fd0
            d, pl = disp.value - d0, kpip.launches - p0
            if out != [r for r, _ in ser] or fd != len(qs) or d > 2:
                raise AssertionError(f"[slice17] distinct {label} counts {out} against serial "
                                     f"{[r for r, _ in ser]}, {fd} distinct members, {d} "
                                     "dispatches")
            if label == "polygon" and pl <= 0:
                raise AssertionError("[slice17] the fused polygon group never launched pip.cu")
            log(f"[slice17] {len(qs)} distinct {label} counts: serial cold "
                f"{sum(cold) * 1e3:.3f} ms in all, warm {sum(s for _, s in ser) * 1e3:.3f} ms, "
                f"fused {wall * 1e3:.3f} ms; "
                f"serving.fused.distinct +{fd}, {d} dispatches, pip.cu launches +{pl}; answers "
                f"equal to serial {[r for r, _ in ser]}")

        # 3. 4 identical 512x512 densities, repeat-fused: one grouped launch
        g_ser, s_ser = timed(torch, lambda: ds.density(name, q_bbox, **grid))
        if not np.array_equal(g_ser, results["density"]):
            raise AssertionError("[slice17] the serial density changed")
        d0, g0 = disp.value, kgrouped.launches
        dopts = {"op": "density", "ecql": q_bbox, "bbox": list(QUERY_BBOX), "width": WIDTH,
                 "height": HEIGHT}
        out, wall, waits = s17_fused(
            sched, [(lambda: ds.density(name, q_bbox, **grid), dict(dopts)) for _ in range(4)],
            "s17-density", spec_of)
        all_waits += waits
        d, gl = disp.value - d0, kgrouped.launches - g0
        if gl != 1 or d > 2 or not all(np.array_equal(g, g_ser) for g in out):
            raise AssertionError(f"[slice17] fused densities: {gl} grouped launches, {d} "
                                 "dispatches, or a grid unequal to the serial one")
        if len({id(g) for g in out}) != 4:
            raise AssertionError("[slice17] fused members share a grid object")
        log(f"[slice17] 4 identical 512x512 densities: serial {s_ser * 1e3:.3f} ms each, fused "
            f"{wall * 1e3:.3f} ms for all 4; density_grouped.cu launches +{gl}, {d} "
            f"dispatches; grids exact against the serial grid, each member its own copy")

        # 4. typed refusals with no dispatch: an expired budget, a full queue
        d0 = disp.value
        try:
            sched.submit(lambda: ds.count(name, q_bbox), user="s17-late", op="count",
                         budget_s=0.0)
            raise AssertionError("[slice17] an expired budget was admitted")
        except resilience.DeadlineShedError as e:
            shed_msg = str(e)
        gate, fut = s17_stall(sched)
        try:
            with config.SERVING_QUEUE_DEPTH.scoped(1):
                queued = sched.submit(lambda: ds.count(name, q_bbox), user="s17-full", op="count")
                try:
                    sched.submit(lambda: ds.count(name, q_bbox), user="s17-full", op="count")
                    raise AssertionError("[slice17] a full queue admitted a ticket")
                except resilience.AdmissionRejectedError as e:
                    full_msg = str(e)
            if disp.value != d0:
                raise AssertionError("[slice17] a refused ticket dispatched")
        finally:
            gate.set()
            fut.result(60)
        if queued.result(60) != n_bbox:
            raise AssertionError("[slice17] the queued count changed")
        log(f"[slice17] refusals with 0 dispatches: [{resilience.DeadlineShedError.code}] "
            f"{shed_msg!r}; [{resilience.AdmissionRejectedError.code}] {full_msg!r}")

        # 5. a seeded kill of the dispatch slot and its respawn
        with config.FAULT_INJECTION.scoped("true"), resilience.inject_faults(seed=17) as inj:
            with sched._cv:
                gen0, resp0 = sched._slot_gen[0], sched._respawns
            inj.fail("serving.slot.loop", SystemExit("slice17 kill"), times=1)
            t0 = time.perf_counter()
            after = sched.submit(lambda: ds.count(name, q_bbox), user="s17-kill", op="count")
            if not sched.wait_respawns(resp0 + 1, timeout=30):
                raise AssertionError("[slice17] the killed slot never respawned")
            got = after.result(60)
            kill_s = time.perf_counter() - t0
        with sched._cv:
            gen1 = sched._slot_gen[0]
        if got != n_bbox or gen1 != gen0 + 1 or len(inj.fired) != 1:
            raise AssertionError(f"[slice17] after the kill: count {got}, generation "
                                 f"{gen0} -> {gen1}, fired {inj.fired}")
        log(f"[slice17] seeded slot kill: respawned (generation {gen0} -> {gen1}); the queued "
            f"count answered {got} {kill_s * 1e3:.3f} ms after its submission")
        p99 = float(np.percentile(all_waits, 99)) * 1e3
        hist_p99 = reg.histogram(metrics.SERVING_QUEUE_WAIT).quantile(0.99) * 1e3
        snap = sched.snapshot()
    finally:
        sched.stop()
    log(f"[slice17] queue wait p99 {p99:.3f} ms over {len(all_waits)} fused tickets (the "
        f"serving.queue.wait histogram's bucket bound: {hist_p99:.3f} ms); scheduler "
        f"{snap}")

    # 6. speculative count / density / stats: host reads only
    d0, g0, p0 = disp.value, kgrouped.launches, kpip.launches
    with resilience.deadline_scope(0.0):
        c = ds.count(name, q_bbox, speculative_ok=True)
        g = ds.density(name, q_bbox, speculative_ok=True, **grid)
        st = ds.stats(name, "Count();MinMax(dtg)", q_bbox, speculative_ok=True)
    est = ds.count(name, q_bbox, exact=False)
    if disp.value != d0 or kgrouped.launches != g0 or kpip.launches != p0:
        raise AssertionError("[slice17] a speculative answer dispatched")
    if c != est or g.shape != (HEIGHT, WIDTH) or not np.isfinite(g).all():
        raise AssertionError(f"[slice17] speculative count {c} against the estimate {est}")
    ev = ds.audit.recent(1)[0]
    if not (ev.hints.get("speculative") and ev.hints.get("shed")):
        raise AssertionError("[slice17] the speculative audit marker is missing")
    log(f"[slice17] speculative answers with 0 dispatches: count {c} (exact {n_bbox}), density "
        f"total {float(g.sum()):.1f}, stats {st.to_json()}")

    # 7. standing queries on a fresh flat store of slice 1's shape
    t0 = time.perf_counter()
    sdata = make_data(S17_ROWS, args.seed + 17)
    sds = GeoDataset(n_shards=8)
    sname = "standing"
    sds.create_schema(sname, "weight:Float,dtg:Date,*geom:Point")
    sds.insert(sname, sdata)
    sds.flush(sname)
    build_s = time.perf_counter() - t0
    with config.SUBSCRIBE_VERIFY.scoped("true"):
        subs = {
            "count": sds.subscribe(sname, "count", bbox=S17_VIEW),
            "density": sds.subscribe(sname, "density", bbox=S17_VIEW, width=WIDTH,
                                     height=HEIGHT),
            "pyramid": sds.subscribe(sname, "pyramid", bbox=S17_VIEW2, levels=S17_LEVELS),
            "stats": sds.subscribe(sname, "stats", bbox=S17_VIEW2, stat_spec=S17_STAT),
        }
        host = {k: [v] for k, v in sdata.items()}
        insert_s = []
        checks = 0

        def check(step):
            nonlocal checks
            cols = {k: np.concatenate(v) for k, v in host.items()}
            o1 = s17_oracles(cols, S17_VIEW, S17_LEVELS)
            o2 = s17_oracles(cols, S17_VIEW2, S17_LEVELS)
            got = {}
            for k, sid in subs.items():
                p = sds.subscription_poll(sid)
                spec = sds.standing._groups[sname][sds.standing._subs[sid][1]].spec
                got[k] = sdl.decode_result(spec, p["result"])
            view_q = "BBOX(geom, {}, {}, {}, {})"
            n1 = sds.count(sname, view_q.format(*S17_VIEW))
            g1 = sds.density(sname, view_q.format(*S17_VIEW), bbox=S17_VIEW, width=WIDTH,
                             height=HEIGHT)
            n2 = sds.count(sname, view_q.format(*S17_VIEW2))
            s2 = sds.stats(sname, S17_STAT, view_q.format(*S17_VIEW2))
            # the card's density maps pixels in f32 op by op (the
            # reference's device path), the standing grid in f64 (its host
            # evaluator): each equals its own oracle and the totals agree
            g1_f32, _, g1_f64, n1_or = density_oracles(
                cols, np.ones(len(cols["geom__x"]), bool), bbox=S17_VIEW)
            pyr, sg = got["pyramid"], got["stats"]
            cnt, mm = sg.stats[0].count, sg.stats[1]
            ok = (got["count"] == n1 == o1["count"] == n1_or
                  and np.array_equal(got["density"].astype(np.float64), g1_f64)
                  and np.array_equal(got["density"], o1["density"])
                  and np.array_equal(g1.astype(np.float64), g1_f32)
                  and float(g1.sum()) == float(got["density"].sum()) == n1
                  and np.array_equal(pyr[0], o2["leaf"])
                  and all(float(lv.sum()) == n2 for lv in pyr)
                  and sg.to_json() == s2.to_json()
                  and (cnt, float(mm.lo), float(mm.hi)) == o2["stats"])
            if not ok:
                raise AssertionError(f"[slice17] standing results diverge after {step}")
            checks += 1
            return int((got["density"] != g1).sum())

        diff_cells = [check("subscribe")]
        for i in range(S17_BATCHES):
            b = make_data(S17_BATCH_ROWS, args.seed + 1700 + i)
            t1 = time.perf_counter()
            sds.insert(sname, b)
            insert_s.append(time.perf_counter() - t1)
            for k in host:
                host[k].append(b[k])
            diff_cells.append(check(f"insert {i + 1}"))
        t1 = time.perf_counter()
        n_del = sds.delete_features(sname, "BBOX(geom, {}, {}, {}, {})".format(*S17_DELETE))
        delete_s = time.perf_counter() - t1
        cols = {k: np.concatenate(v) for k, v in host.items()}
        x, y = cols["geom__x"], cols["geom__y"]
        dm = ((x >= S17_DELETE[0]) & (x <= S17_DELETE[2]) & (y >= S17_DELETE[1])
              & (y <= S17_DELETE[3]))
        if n_del != int(dm.sum()):
            raise AssertionError(f"[slice17] delete removed {n_del}, the oracle {int(dm.sum())}")
        host = {k: [v[~dm]] for k, v in cols.items()}
        diff_cells.append(check("delete"))
        polls = {k: sds.subscription_poll(sid) for k, sid in subs.items()}
    # the delta pass against one re-scan, the evaluator alone (verify off)
    eng = sds.standing
    win_cols, win_n = sds._store(sname)._all.columns, sds._store(sname)._all.n
    batch = make_data(S17_BATCH_ROWS, args.seed + 1799)
    from geomesa_tpu_torch.schema.columns import encode_batch

    st_ = sds._store(sname)
    enc = encode_batch(st_.ft, batch, st_.dicts, None)
    groups = list(eng._groups[sname].values())

    def eval_all(cols_, n_):
        for grp in groups:
            sdl.eval_rows(grp.spec, grp.cf, st_.ft, cols_, n_, st_.dicts)

    t1 = time.perf_counter()
    eval_all(enc.columns, enc.n)
    delta_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    eval_all(win_cols, win_n)
    rescan_ms = (time.perf_counter() - t1) * 1e3
    kinds = {k: [u["kind"] for u in p["updates"]] for k, p in polls.items()}
    log(f"[slice17] standing store of {S17_ROWS} rows built in {build_s:.3f} s; "
        f"{S17_BATCHES} inserts of {S17_BATCH_ROWS} rows (insert + delta + verify re-scan "
        f"p50 {float(np.median(insert_s)) * 1e3:.3f} ms) and a delete of {n_del} rows "
        f"({delete_s * 1e3:.3f} ms); {checks} checks: count / density / pyramid / stats equal "
        f"to fresh card answers and NumPy oracles (density grid against the card's f32-mapped "
        f"grid: cells differing {diff_cells}, totals equal); update kinds {kinds}")
    log(f"[slice17] host evaluation of the 4 groups: one batch's delta {delta_ms:.3f} ms against "
        f"one re-scan of {win_n} rows {rescan_ms:.3f} ms")
    del sds, sdata, host, cols, win_cols, st_, enc, groups, eng
    torch.cuda.empty_cache()

    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    wall = time.perf_counter() - t_phase
    log(f"[slice17] launches {launches}; the phase took {wall:.3f} s")
    if wall > S17_BUDGET_S:
        raise AssertionError(f"[slice17] the phase took {wall:.3f} s, over its {S17_BUDGET_S} s")
    return launches, wall


#: the slice-18 phase's own budget (seconds), checked as slices 16 and 17 check theirs
S18_BUDGET_S = 30.0
#: the Lambda store's cold tier (slice 1's shape, seed + 18) and the live
#: window (distinct fids, written in batches); cuts go no lower than the floors
S18_COLD_ROWS = 2_000_000
S18_COLD_FLOOR = 500_000
S18_LIVE = 200_000
S18_LIVE_FLOOR = 50_000
S18_BATCH = 20_000
#: live fids that also exist in the cold tier (``c<i>``), moves, deletes
S18_SHARED = 50_000
S18_MOVES = 20_000
S18_DELETES = 1_000
S18_SCHEMA = "ais"
S18_SPEC = "weight:Float,dtg:Date,*geom:Point"
#: the live window's event times: row i at S18_T0 + i ms
S18_T0 = 1_700_000_000_000
S18_STAT = "Count();MinMax(weight)"
S18_STANDING_GRID = 256
#: framed-Avro records through ``attach_confluent``; a broker offset is
#: committed every S18_COMMIT records (and at the last one)
S18_CONFLUENT = 10_000
S18_COMMIT = 1_000
#: for the cut estimate, checked after each batch of the load: the host
#: passes over the whole window after the load at the mean write + apply
#: cost a message so far (the journal replay, the checks), the seconds of
#: the parts that do not grow with it (the moves, the Avro records, the
#: merged calls), and the share of the budget the estimate may reach
S18_PASSES = 1.5
S18_FIXED_S = 4.5
S18_MARGIN = 0.85


def s18_fid(i: int) -> str:
    return f"c{i}" if i < S18_SHARED else f"l{i}"


def s18_pip64(x, y, tables) -> np.ndarray:
    """Even-odd membership over the f64 edge table, op for op as the host's
    exact mask (``filter/compile.py::_pip_fn`` with ``xp=np``)."""
    x1, y1, _, y2, slope = tables
    out = np.zeros(len(x), bool)
    for lo in range(0, len(x), 1 << 16):
        xb, yb = x[lo:lo + (1 << 16), None], y[lo:lo + (1 << 16), None]
        cond = (y1 > yb) != (y2 > yb)
        out[lo:lo + (1 << 16)] = (cond & (xb < x1 + (yb - y1) * slope)).sum(axis=1) % 2 == 1
    return out


def s18_grid_f32(x, y, box, width, height):
    """The card's pixel mapping of the stream's density: f32 op by op, no
    band correction (membership is the host's exact f64 mask)."""
    f = np.float32
    xmin, ymin, xmax, ymax = box
    px = ((x.astype(f) - f(xmin)) / f(xmax - xmin) * f(width)).astype(np.int32)
    py = ((y.astype(f) - f(ymin)) / f(ymax - ymin) * f(height)).astype(np.int32)
    idx = np.clip(py, 0, height - 1) * width + np.clip(px, 0, width - 1)
    return np.bincount(idx, minlength=width * height).reshape(height, width)


def s18_live_batch(rows, ts, dtg, x, y, w):
    """``StreamingDataset.write`` arguments of the live rows ``rows``."""
    data = {"weight": w[rows].tolist(), "dtg": dtg[rows].tolist(),
            "geom": list(zip(x[rows].tolist(), y[rows].tolist()))}
    return data, [s18_fid(int(i)) for i in rows], ts[rows].tolist()


def slice18(args, torch, wkt, kpip, kgrouped):
    """The slice-18 phase (see the module docstring, 19): the streaming tier
    on a live window of AIS-like tracks beside a cold tier on the card.
    Returns (launches, wall s)."""
    import tempfile

    from geomesa_tpu_torch import GeoDataset, config, metrics
    from geomesa_tpu_torch.schema.columns import fid_strs
    from geomesa_tpu_torch.schema.feature_type import FeatureType
    from geomesa_tpu_torch.stream import LambdaDataset, StreamingDataset
    from geomesa_tpu_torch.stream.confluent import (
        ConfluentSerializer, SchemaRegistry, attach_confluent, confluent_resume_offset,
    )
    from geomesa_tpu_torch.subscribe import delta as sdl
    from geomesa_tpu_torch.utils.geometry import parse_wkt

    t_phase = time.perf_counter()
    kpip.launches = 0
    kgrouped.launches = 0
    reg = metrics.registry()
    name = S18_SCHEMA
    q_box = f"BBOX(geom, {', '.join(str(v) for v in QUERY_BBOX)}) AND {DURING}"
    q_poly = f"INTERSECTS(geom, {wkt}) AND {DURING}"
    tables, packed = kpip.polygon_edge_tables(parse_wkt(wkt))
    n_edges = len(tables[0])
    rng = np.random.default_rng(args.seed + 18)
    live = make_data(S18_LIVE, args.seed + 1801)
    x, y, w = live["geom__x"], live["geom__y"], live["weight"]
    dtg = live["dtg"].astype(np.int64)
    ts = S18_T0 + np.arange(S18_LIVE, dtype=np.int64)
    alive = np.zeros(S18_LIVE, bool)
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name

    # 1. the live window: journaled producer and consumer; the first
    # batch's rates decide the cuts
    sds = StreamingDataset(partitions=4)
    sds.attach_journal(root)
    sds.create_schema(name, S18_SPEC)
    write_s, poll_s = [], []

    def load(lo, hi):
        for b in range(lo, hi, S18_BATCH):
            rows = np.arange(b, min(b + S18_BATCH, hi))
            data, fids, tss = s18_live_batch(rows, ts, dtg, x, y, w)
            t1 = time.perf_counter()
            sds.write(name, data, fids, ts_ms=tss)
            t2 = time.perf_counter()
            if sds.poll(name) != len(rows):
                raise AssertionError("[slice18] a live batch did not apply whole")
            poll_s.append(time.perf_counter() - t2)
            write_s.append(t2 - t1)
            alive[rows] = True

    n_live, n_cold = S18_LIVE, S18_COLD_ROWS
    # the cold tier's ingest: slice 17's measured 2M rows in 0.905 s on the
    # card's host, taken twice (the build and the persistence's rebuild)
    cold_per_row = 2 * 0.905 / 2_000_000
    limit = S18_MARGIN * S18_BUDGET_S
    loaded, est0 = 0, None
    while loaded < n_live:
        load(loaded, loaded + S18_BATCH)
        loaded += S18_BATCH
        # the mean write + apply cost of the messages so far
        per_msg = (sum(write_s) + sum(poll_s)) / loaded

        def estimate():
            return (time.perf_counter() - t_phase + (n_live - loaded) * per_msg
                    + S18_PASSES * per_msg * n_live + S18_FIXED_S + cold_per_row * n_cold)

        if est0 is None:
            est0 = estimate()
        while estimate() > limit and n_cold > S18_COLD_FLOOR:
            n_cold = max(S18_COLD_FLOOR, n_cold // 2)
            log(f"[slice18] cut after {loaded} fids: cold tier {n_cold} rows (estimate "
                f"{estimate():.3f} s)")
        while estimate() > limit and n_live > max(S18_LIVE_FLOOR, loaded):
            n_live -= S18_BATCH
            log(f"[slice18] cut after {loaded} fids: live window {n_live} fids (estimate "
                f"{estimate():.3f} s)")
    log(f"[slice18] first batch: write {write_s[0] * 1e3:.3f} ms, poll {poll_s[0] * 1e3:.3f} "
        f"ms for {S18_BATCH} messages; the phase estimated at {est0:.3f} s after it, "
        f"{estimate():.3f} s after the load, against {S18_BUDGET_S} s; live window {n_live}, "
        f"cold tier {n_cold}")
    x, y, w, dtg, ts, alive = (a[:n_live] for a in (x, y, w, dtg, ts, alive))
    n_msgs = n_live
    write_rate = n_msgs / sum(write_s)
    apply_rate = n_msgs / sum(poll_s)

    # 2. the cold tier on the card: slice 1's shape, seed + 18; fids c<j>
    t1 = time.perf_counter()
    cold_data = make_data(n_cold, args.seed + 18)
    cold_fids = np.char.add("c", np.arange(n_cold).astype(str))
    cold = GeoDataset(n_shards=8)
    cold.create_schema(name, S18_SPEC)
    cold.insert(name, cold_data, fids=cold_fids)
    cold.flush(name)
    cold_s = time.perf_counter() - t1

    cache = sds.cache(name)
    t1 = time.perf_counter()
    cache._invalidate()
    cache.batch()
    rebuild_ms = (time.perf_counter() - t1) * 1e3

    # 3. standing count and 256^2 density, then moves, a stale update,
    # deletes and a poison message
    view = QUERY_BBOX
    view_q = "BBOX(geom, {}, {}, {}, {})".format(*view)
    sg = S18_STANDING_GRID
    checks = 0

    def tm_of(d):
        return time_mask({"dtg": d})

    def in_view(xx, yy):
        return (xx >= view[0]) & (xx <= view[2]) & (yy >= view[1]) & (yy <= view[3])

    def standing_check(step):
        nonlocal checks
        m = alive & in_view(x, y)
        n_want = int(m.sum())
        got = {}
        for k, sid in subs.items():
            p = sds.subscription_poll(sid)
            spec = sds.standing._groups[name][sds.standing._subs[sid][1]].spec
            got[k] = (sdl.decode_result(spec, p["result"]), p["updates"][-1]["kind"])
        n_fresh = sds.count(name, view_q)
        sds.prefer_device = False
        g_host = sds.density(name, view_q, bbox=view, width=sg, height=sg)
        sds.prefer_device = True
        g_card = sds.density(name, view_q, bbox=view, width=sg, height=sg)
        want = s17_grid_f64(x[m], y[m], view, sg, sg).astype(np.float32)
        if not (got["count"][0] == n_fresh == n_want
                and np.array_equal(got["density"][0], g_host)
                and np.array_equal(g_host, want)
                and np.array_equal(g_card, s18_grid_f32(x[m], y[m], view, sg, sg))
                and float(g_card.sum()) == n_want):
            raise AssertionError(f"[slice18] standing results diverge after {step}")
        checks += 1
        return {k: v[1] for k, v in got.items()}, int((g_card != g_host).sum())

    with config.SUBSCRIBE_VERIFY.scoped("true"):
        subs = {"count": sds.subscribe(name, "count", bbox=view),
                "density": sds.subscribe(name, "density", bbox=view, width=sg, height=sg)}
        kinds, cells = [], []
        k_, c_ = standing_check("subscribe")
        kinds.append(k_)
        cells.append(c_)
        moved = rng.choice(n_live, S18_MOVES, replace=False)
        moved.sort()
        mv = make_data(S18_MOVES, args.seed + 1802)
        x[moved], y[moved] = mv["geom__x"], mv["geom__y"]
        w[moved], dtg[moved] = mv["weight"], mv["dtg"].astype(np.int64)
        ts[moved] = S18_T0 + S18_LIVE + 1_000 + np.arange(S18_MOVES)
        data, fids, tss = s18_live_batch(moved, ts, dtg, x, y, w)
        t1 = time.perf_counter()
        sds.write(name, data, fids, ts_ms=tss)
        # a stale update of an unmoved fid: dropped by event-time order
        stale = int(np.setdiff1d(np.arange(n_live), moved)[7])
        sds.write(name, {"weight": [9.0], "dtg": [int(dtg[stale])], "geom": [(0.0, 0.0)]},
                  [s18_fid(stale)], ts_ms=[int(ts[stale]) - 1])
        applied = sds.poll(name)
        move_s = time.perf_counter() - t1
        if applied != S18_MOVES + 1 or cache._state[s18_fid(stale)][0] != ts[stale]:
            raise AssertionError(f"[slice18] the moves applied {applied}; the stale update "
                                 f"replaced {cache._state[s18_fid(stale)]}")
        k_, c_ = standing_check("moves")
        kinds.append(k_)
        cells.append(c_)
        deleted = rng.choice(np.setdiff1d(np.arange(n_live), moved), S18_DELETES,
                             replace=False)
        q0 = reg.counter(f"{metrics.STREAM_POLL_QUARANTINED}.{name}").value
        t1 = time.perf_counter()
        for i in deleted.tolist():
            sds.delete(name, s18_fid(i))
        sds._topics[name]._logs[0].append(b"\x07 not a geomessage")
        applied = sds.poll(name)
        delete_s = time.perf_counter() - t1
        alive[deleted] = False
        quarantined = reg.counter(f"{metrics.STREAM_POLL_QUARANTINED}.{name}").value - q0
        if applied != S18_DELETES or sds.quarantined.get(name) != 1 or quarantined != 1:
            raise AssertionError(f"[slice18] deletes applied {applied}, quarantined "
                                 f"{sds.quarantined} ({quarantined} counted)")
        k_, c_ = standing_check("deletes")
        kinds.append(k_)
        cells.append(c_)
    if len(cache) != int(alive.sum()):
        raise AssertionError(f"[slice18] the live window holds {len(cache)} fids, the oracle "
                             f"{int(alive.sum())}")
    log(f"[slice18] live window {n_live} fids in {len(write_s)} batches: write "
        f"{write_rate:.1f} messages/s, apply {apply_rate:.1f} messages/s, poll p50 "
        f"{float(np.median(poll_s)) * 1e3:.3f} ms a batch of {S18_BATCH} ("
        f"stream.apply timer p50 bucket {reg.timer(metrics.STREAM_APPLY).hist.quantile(0.5) * 1e3:.3f}"
        f" ms); batch() rebuild {rebuild_ms:.3f} ms; {S18_MOVES} moves + 1 stale update "
        f"{move_s * 1e3:.3f} ms (stale dropped), {S18_DELETES} deletes + 1 poison message "
        f"{delete_s * 1e3:.3f} ms (1 quarantined); cold tier {n_cold} rows in {cold_s:.3f} s")
    log(f"[slice18] standing count and {sg}x{sg} density: {checks} checks equal fresh calls "
        f"and the oracles; update kinds {kinds}; cells where the card's f32 grid differs from "
        f"the standing f64 one {cells}")

    # 4. the stream calls against NumPy oracles over the live state
    oracles = {}
    for label, q in (("bbox", q_box), ("polygon", q_poly)):
        tmk = alive & tm_of(dtg)
        if label == "bbox":
            m = tmk & in_view(x, y)
        else:
            m = np.zeros(n_live, bool)
            m[tmk] = s18_pip64(x[tmk], y[tmk], tables)
        rows = np.flatnonzero(m)
        n = sds.count(name, q)
        got = sds.query(name, q)
        g = sds.density(name, q, bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
        st = sds.stats(name, S18_STAT, q)
        ok = (n == len(rows) == got.n
              and fid_strs(got.columns["__fid__"]).tolist() == [s18_fid(i) for i in rows]
              and np.array_equal(got.columns["geom__x"], x[rows])
              and np.array_equal(got.columns["geom__y"], y[rows])
              and np.array_equal(got.columns["weight"], w[rows])
              and np.array_equal(got.columns["dtg"], dtg[rows])
              and np.array_equal(g, s18_grid_f32(x[rows], y[rows], QUERY_BBOX, WIDTH, HEIGHT))
              and (st.stats[0].count, float(st.stats[1].lo), float(st.stats[1].hi))
              == (len(rows), float(w[rows].min()), float(w[rows].max())))
        if not ok:
            raise AssertionError(f"[slice18] stream {label} calls differ from the oracle")
        oracles[label] = len(rows)
    grid_q = lambda: sds.density(name, q_box, bbox=QUERY_BBOX, width=WIDTH,  # noqa: E731
                                 height=HEIGHT)
    card = [timed(torch, grid_q)[1] for _ in range(3)]
    sds.prefer_device = False
    host = [timed(torch, grid_q)[1] for _ in range(3)]
    sds.prefer_device = True
    log(f"[slice18] stream count / query / 512x512 density / {S18_STAT} equal the oracles: "
        f"bbox + DURING {oracles['bbox']}, polygon + DURING {oracles['polygon']} rows; the "
        f"density on the card p50 {float(np.median(card)) * 1e3:.3f} ms against "
        f"density_grid_np {float(np.median(host)) * 1e3:.3f} ms (the window's mask and "
        f"upload included)")

    # 5. framed Avro: 10,000 records, one schema evolution, one tombstone
    cname = name + "_avro"
    sds.create_schema(cname, S18_SPEC)
    regy = SchemaRegistry()
    ser, ingest = attach_confluent(sds, cname, regy)
    ser2 = ConfluentSerializer(regy, cname, FeatureType.from_spec(cname, S18_SPEC + ",mmsi:Long"))
    cd = make_data(S18_CONFLUENT, args.seed + 1803)
    cx, cy, cw = cd["geom__x"], cd["geom__y"], cd["weight"]
    cdt = cd["dtg"].astype(np.int64)
    t1 = time.perf_counter()
    for i in range(S18_CONFLUENT):
        rec = {"weight": float(cw[i]), "dtg": int(cdt[i]),
               "geom": f"POINT ({float(cx[i])!r} {float(cy[i])!r})"}
        s = ser
        if i >= S18_CONFLUENT // 2:
            rec["mmsi"] = 200_000_000 + i
            s = ser2
        commit = i % S18_COMMIT == S18_COMMIT - 1
        if ingest(s.serialize(f"a{i}", rec), ts_ms=S18_T0 + i,
                  offset=i if commit else None) != f"a{i}":
            raise AssertionError(f"[slice18] Avro record {i} was not applied")
    ingest(None, fid="a3")
    sds.poll(cname)
    avro_s = time.perf_counter() - t1
    keep = np.ones(S18_CONFLUENT, bool)
    keep[3] = False
    cm = keep & tm_of(cdt) & in_view(cx, cy)
    if (len(sds.cache(cname)) != S18_CONFLUENT - 1 or sds.count(cname, q_box) != int(cm.sum())
            or len(regy.versions(cname)) != 2):
        raise AssertionError(f"[slice18] Avro ingest: {len(sds.cache(cname))} live")
    log(f"[slice18] {S18_CONFLUENT} framed-Avro records (schema ids {regy.versions(cname)}, "
        f"the second from record {S18_CONFLUENT // 2}) and a tombstone in {avro_s:.3f} s "
        f"({S18_CONFLUENT / avro_s:.1f} records/s); bbox count {int(cm.sum())} equals the "
        f"oracle")

    # 6. the journal: a fresh consumer on the same bus recovers the caches
    # and the offsets, and its next poll applies nothing twice
    sds._journal.close()
    t1 = time.perf_counter()
    sds2 = StreamingDataset(bus=sds.bus, partitions=4)
    sds2.attach_journal(root)
    replayed = sds2.recover()
    replay_s = time.perf_counter() - t1
    for nm in (name, cname):
        a, b = sds.cache(nm).batch(), sds2.cache(nm).batch()
        if not (a.n == b.n and sds2._offsets[nm] == sds._offsets[nm]
                and all(np.array_equal(a.columns[k], b.columns[k]) for k in a.columns)):
            raise AssertionError(f"[slice18] the recovered {nm} window differs")
    again = sds2.poll()
    # the journal's last committed broker offset: the external consumer
    # seeks past it
    resume = confluent_resume_offset(sds2, cname)
    if again != 0 or resume != S18_CONFLUENT - 1:
        raise AssertionError(f"[slice18] the recovered consumer applied {again} again; "
                             f"resume offset {resume}")
    log(f"[slice18] journal replay: {replayed} records in {replay_s:.3f} s "
        f"({len(sds2.cache(name)) + len(sds2.cache(cname))} live features); caches and "
        f"offsets equal; the next poll applied 0; resume offset {resume}")
    del sds, cache

    # 7. the Lambda store: half the window ages into the cold tier
    lam = LambdaDataset(persistent=cold, transient=sds2)
    now_ms = S18_T0 + n_live // 2 - 1 + lam.persist_age_ms
    aged = alive & (ts <= now_ms - lam.persist_age_ms)
    t1 = time.perf_counter()
    moved_n = lam.run_persistence(name, now_ms=now_ms)
    persist_s = time.perf_counter() - t1
    hot = alive & ~aged
    if moved_n != int(aged.sum()) or len(sds2.cache(name)) != int(hot.sum()):
        raise AssertionError(f"[slice18] run_persistence moved {moved_n}, the oracle "
                             f"{int(aged.sum())}")
    # the merged state, as the reference merges it: the hot tier's matches,
    # then the cold tier's matches whose fid is not among the hot matches
    # (a hot copy that no longer matches leaves its older cold copy in the
    # answer); a persisted shared fid replaced its original cold copy
    n_sh = min(S18_SHARED, n_live)
    gone = np.zeros(n_cold, bool)
    gone[:n_sh] = aged[:n_sh]
    cx_, cy_ = cold_data["geom__x"], cold_data["geom__y"]
    cw_, cd_ = cold_data["weight"], cold_data["dtg"].astype(np.int64)
    ax, ay, aw, ad = x[aged], y[aged], w[aged], dtg[aged]
    afid = np.array([s18_fid(i) for i in np.flatnonzero(aged)])
    lam_want = {}
    for label, q in (("bbox", q_box), ("polygon", q_poly)):
        hm = hot & tm_of(dtg)
        cm_ = ~gone & tm_of(cd_)
        am = tm_of(ad)
        if label == "bbox":
            hm &= in_view(x, y)
            cm_ &= in_view(cx_, cy_)
            am &= in_view(ax, ay)
        else:
            hsel = np.flatnonzero(hm)
            hm = np.zeros(n_live, bool)
            hm[hsel] = s18_pip64(x[hsel], y[hsel], tables)
            cm_ &= polygon_rows(cold_data, cm_, packed, n_edges)
            am &= polygon_rows({"geom__x": ax, "geom__y": ay}, am, packed, n_edges)
        cm_[:n_sh] &= ~hm[:n_sh]
        fids_w = np.concatenate([np.array([s18_fid(i) for i in np.flatnonzero(hm)], dtype=str),
                                 cold_fids[cm_], afid[am]])
        xs_w = np.concatenate([x[hm], cx_[cm_], ax[am]])
        ys_w = np.concatenate([y[hm], cy_[cm_], ay[am]])
        ws_w = np.concatenate([w[hm], cw_[cm_], aw[am]])
        lam_want[label] = (fids_w, xs_w, ys_w, ws_w)
    before = kpip.launches
    t1 = time.perf_counter()
    n_lam_poly = lam.count(name, q_poly)
    lam_poly_s = time.perf_counter() - t1
    pip_delta = kpip.launches - before
    t1 = time.perf_counter()
    n_lam_box = lam.count(name, q_box)
    lam_box_s = time.perf_counter() - t1
    for label, q in (("bbox", q_box), ("polygon", q_poly)):
        fids_w, xs_w, ys_w, ws_w = lam_want[label]
        got = lam.query(name, q)
        gf = fid_strs(got.columns["__fid__"])
        o_g, o_w = np.argsort(gf, kind="stable"), np.argsort(fids_w, kind="stable")
        g = lam.density(name, q, bbox=QUERY_BBOX, width=WIDTH, height=HEIGHT)
        st = lam.stats(name, S18_STAT, q)
        n_got = n_lam_box if label == "bbox" else n_lam_poly
        ok = (n_got == got.n == len(fids_w)
              and np.array_equal(gf[o_g], fids_w[o_w])
              and np.array_equal(got.columns["geom__x"][o_g], xs_w[o_w])
              and np.array_equal(got.columns["geom__y"][o_g], ys_w[o_w])
              and np.array_equal(got.columns["weight"][o_g], ws_w[o_w])
              and np.array_equal(g, s17_grid_f64(xs_w, ys_w, QUERY_BBOX, WIDTH, HEIGHT))
              and (st.stats[0].count, float(st.stats[1].lo), float(st.stats[1].hi))
              == (len(fids_w), float(ws_w.min()), float(ws_w.max())))
        if not ok:
            raise AssertionError(f"[slice18] merged {label} calls differ from the oracle: "
                                 f"count {n_got}, rows {got.n}, oracle {len(fids_w)}")
    if pip_delta <= 0:
        raise AssertionError("[slice18] the merged polygon count launched no pip.cu")
    launches = {"pip": kpip.launches, "density_grouped": kgrouped.launches}
    # pip.cu against its plain version on the cold tier's operands, not counted
    ex = cold._executor(name)
    cols = ex.scan_columns(cold._plan(name, q_poly), ["geom__x", "geom__y"])
    px, py = cols["geom__x"], cols["geom__y"]
    edges = torch.from_numpy(packed).cuda()
    got_k = kpip.pip_mask(px, py, edges, n_edges)
    got_p = kpip.pip_mask_plain(px, py, edges, n_edges)
    torch.cuda.synchronize()
    pip_err = int((got_k != got_p).sum())
    if pip_err:
        raise AssertionError(f"[slice18] pip.cu disagrees with its plain version on {pip_err}")
    log(f"[slice18] Lambda store: run_persistence moved {moved_n} of {n_live} fids in "
        f"{persist_s:.3f} s; merged count / query / 512x512 f64-mapped density / {S18_STAT} "
        f"equal the oracles (hot wins): bbox + DURING {n_lam_box} ({lam_box_s * 1e3:.3f} ms), "
        f"polygon + DURING {n_lam_poly} ({lam_poly_s * 1e3:.3f} ms, pip.cu +{pip_delta}); "
        f"pip.cu on the cold tier's {tuple(px.shape)} points equals its plain version")
    sds2._journal.close()
    del lam, sds2, cold, cold_data, cols, px, py, edges, got_k, got_p, ex
    tmp.cleanup()
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_phase
    log(f"[slice18] launches {launches}; the phase took {wall:.3f} s")
    if wall > S18_BUDGET_S:
        raise AssertionError(f"[slice18] the phase took {wall:.3f} s, over its {S18_BUDGET_S} s")
    return launches, wall


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
    ap.add_argument("--trip-rows", type=int, default=TRIP_ROWS,
                    help="pickups (and dropoffs) of slice 7's taxi schemas")
    ap.add_argument("--s10-child", metavar="ROOT", default=None,
                    help="(internal) slice 10's crash child: load ROOT, insert until killed")
    ap.add_argument("--s10-save-split", action="store_true",
                    help="only save slice 10's flat store and time each column's compression")
    args = ap.parse_args()
    if args.s10_child is not None:
        return s10_child(args.s10_child, args.seed)
    if args.s10_save_split:
        return s10_save_split(args.seed)
    t_start = time.perf_counter()

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
    # the Parquet tier (fs/storage.py) and the Arrow IO wait on this answer
    if importlib.util.find_spec("pyarrow") is None:
        log("[device] pyarrow: not installed")
    else:
        log(f"[device] pyarrow: installed, version {importlib.metadata.version('pyarrow')}")
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

    # -- 10. slice 8: density_curve and the query-axis batches ---------------
    s8_launches = slice8(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)

    # -- 13. slice 11: the aggregate cache on slice 1's store ------------------
    s11_flat = slice11(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped,
                       n_bbox, n_poly)
    # -- slice 13's deadline on the flat store ---------------------------------
    slice13_flat(ds)

    # -- 15. slice 14: tracing, the audit log, guards and explain -------------
    s14_flat, s14_wall, s14_p50 = slice14(torch, ds, queries, results, kpip, kgrouped,
                                          n_bbox)

    # -- 16. slice 15: the kernel registry, utilization, export and endpoints --
    s15_flat, _, _ = slice15(torch, ds, queries, results, kpip, kgrouped)

    # -- 17. slice 16: s3 keys, Json, the einsum rung and call-time knobs -----
    s16_flat, _ = slice16(args, torch, ds, data, results, paths, wkt, packed, n_edges, kpip,
                          kgrouped, n_bbox)

    # -- 18. slice 17: the serving scheduler, then standing queries ------------
    s17_flat, _ = slice17(args, torch, ds, data, results, wkt, kpip, kgrouped, n_bbox)

    # -- 19. slice 18: the streaming tier, on stores of its own ---------------
    s18_flat, _ = slice18(args, torch, wkt, kpip, kgrouped)

    # -- 5. slice 3 ---------------------------------------------------------
    _, extra, fids = slice3(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)

    # -- 6. slice 4 ---------------------------------------------------------
    slice4(args, torch, ds, data, extra, fids, wkt, packed, n_edges, kpip)

    # -- 7. slice 6: extent schemas beside slice 3's points -------------------
    slice6(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)

    # -- 11. slice 9's lifecycle on slice 1's store, before it is freed --------
    s9_flat = slice9_flat(args, torch, ds, data, wkt, packed, n_edges, kpip, kgrouped)

    # the earlier phases' stores and operands leave the card first
    del ds, data, extra, fids, ex, cols, px, py, o, ops_u, ops_w, got, want
    del edges, cx, cy, flat, wflat
    torch.cuda.empty_cache()

    # -- 12. slice 10: durable datasets, on a flat store of its own ----------
    s10_flat = slice10_flat(args, torch, wkt, packed, n_edges, kpip, kgrouped)
    torch.cuda.empty_cache()

    # -- 9. slice 7: joins and regions over NYC, on a dataset of its own -----
    kernels += slice7(args, torch, kpip, kgrouped)
    torch.cuda.empty_cache()

    # -- 8. slice 5, on a partitioned store of its own (slice 8's partitioned
    # calls run on it at the end) ---------------------------------------------
    _, s8_part, s9_part, s10_part, s11_part, (s13_part, (s14_part, s14_part_wall)) = slice5(
        args, torch, wkt, packed, n_edges, kpip, kgrouped)
    s14_wall += s14_part_wall
    log(f"[slice14] the phase took {s14_wall:.3f} s (flat and partitioned parts); warm "
        f"count p50 untraced {s14_p50[0]:.6f} ms, traced {s14_p50[1]:.6f} ms")
    if s14_wall > S14_BUDGET_S:
        raise AssertionError(f"[slice14] the phase took {s14_wall:.3f} s, over its "
                             f"{S14_BUDGET_S} s")
    for k in kernels:
        k["launches_slice8"] = s8_launches.get(k["name"], 0) + s8_part.get(k["name"], 0)
        k["launches_slice9"] = s9_flat.get(k["name"], 0) + s9_part.get(k["name"], 0)
        k["launches_slice10"] = s10_flat.get(k["name"], 0) + s10_part.get(k["name"], 0)
        k["launches_slice11"] = s11_flat.get(k["name"], 0) + s11_part.get(k["name"], 0)
        k["launches_slice13"] = s13_part.get(k["name"], 0)
        k["launches_slice14"] = s14_flat.get(k["name"], 0) + s14_part.get(k["name"], 0)
        k["launches_slice15"] = s15_flat.get(k["name"], 0)
        k["launches_slice16"] = s16_flat.get(k["name"], 0)
        k["launches_slice17"] = s17_flat.get(k["name"], 0)
        k["launches_slice18"] = s18_flat.get(k["name"], 0)
    if min(s14_flat.values()) <= 0:
        raise AssertionError(f"[slice14] a main-path kernel never launched traced: {s14_flat}")

    log(f"[main] chip_smoke wall {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
