"""Reproduce the JAX package's missing serving respawn on the CPU.

``tests/test_chaos.py::test_respawned_slot_rejects_stale_generation_continuations``
arms a seeded ``serving.slot.loop`` kill for slot 1 of a two-slot pool,
submits one wake-up ticket, and waits for slot 1's respawn. The reference
evaluates that fault point at the top of a loop iteration and after a
wake from ``cv.wait()``. A slot that passed the top point before the kill
was armed, and has not reached ``wait()`` when the wake-up's
``notify_all`` comes, misses it; its sibling takes the ticket, the slot
then waits with nothing to wake it, the kill never fires, and no respawn
comes. The window is the slot's first iteration-top ``supervise()``
round, unthrottled, which counts the healthy devices under the
scheduler's lock.

Runs the scenario ``--runs`` times as it is, then as often with slot 1's
iteration-top ``supervise`` delayed by ``--delay-ms`` (a slow first
health sweep), and prints one JSON line: per mode the runs, the misses and
how many missed runs fired no kill at all. Imports only the JAX package;
run it with ``JAX_PLATFORMS=cpu`` from the repository root:

    JAX_PLATFORMS=cpu python tools/reference_lost_wakeup.py --runs 200
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geomesa_tpu import GeoDataset, config  # noqa: E402
from geomesa_tpu.resilience import inject_faults  # noqa: E402
from geomesa_tpu.serving.scheduler import QueryScheduler  # noqa: E402


def scenario(ds, wait_s: float):
    """One run of the chaos test's respawn wait: (respawned, kill fired)."""
    with config.SERVING_EXECUTORS.scoped("2"), config.FAULT_INJECTION.scoped("true"), \
            inject_faults(seed=10) as inj:
        s = ds.serving.start()
        try:
            with s._cv:
                gen0 = s._slot_gen[1]
            rule = inj.fail("serving.slot.loop", SystemExit("chaos kill"), times=1,
                            where=lambda c: c.get("slot") == 1)
            s.submit(lambda: None, user="w", op="wake").result(timeout=30)
            deadline = time.monotonic() + wait_s
            while time.monotonic() < deadline:
                with s._cv:
                    if 1 in s._threads and s._slot_gen[1] > gen0:
                        return True, rule.hits > 0
                time.sleep(0.01)
            return False, rule.hits > 0
        finally:
            s.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--delay-ms", type=float, default=5.0)
    ap.add_argument("--wait-s", type=float, default=1.0, help="respawn wait per run")
    args = ap.parse_args()
    ds = GeoDataset()
    out = {}
    orig = QueryScheduler.supervise
    for mode in ("plain", "delayed"):
        if mode == "delayed":
            def slow(self, throttle=False):
                if throttle and getattr(self._tls, "slot", None) == 1:
                    time.sleep(args.delay_ms / 1e3)
                return orig(self, throttle)
            QueryScheduler.supervise = slow
        try:
            runs = [scenario(ds, args.wait_s) for _ in range(args.runs)]
        finally:
            QueryScheduler.supervise = orig
        missed = [fired for ok, fired in runs if not ok]
        out[mode] = {"runs": len(runs), "missed": len(missed),
                     "missed_without_kill": sum(1 for f in missed if not f)}
    out["delay_ms"] = args.delay_ms
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
