"""EnvPool plumbing throughput of the port: a trivial env through the
full shm + semaphore dispatch path, double-buffered; the twin of the
reference's ``tools/envpool_bench.py``.

Measures the acting plane's machinery ceiling (slab writes, ring
dispatch, process-shared semaphores, the worker's Python step loop) with
env cost ~zero — real envs add their own step time on top. The env is
the suite's :class:`~moolib_tpu_torch.bench.suite.TrivialEnv`. The
workers run on the host: there is no ``--device``.

Usage::

    python -m moolib_tpu_torch.tools.envpool_bench [--json OUT]
        [--config PROCS,BATCH ...] [--batches N]

One JSON line per config (default: 1 process at batch 32, 128 and 512);
each also lands a perfwatch trend row when ``MOOLIB_TRENDS`` names a
store. Top-level imports stay light (no torch): the pool's spawn workers
import this module again when it runs as ``__main__``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

CONFIGS = ((1, 32), (1, 128), (1, 512))
CMD = "python -m moolib_tpu_torch.tools.envpool_bench"


def bench(procs: int, bs: int, batches: Optional[int] = None) -> dict:
    """Env-steps/s and µs per batch of a double-buffered pool of
    ``procs`` workers at batch size ``bs`` over ``batches`` loop
    iterations (default: ~20000 env steps, at least 50)."""
    import numpy as np

    from ..bench.suite import TrivialEnv
    from ..envpool import EnvPool

    pool = EnvPool(TrivialEnv, num_processes=procs, batch_size=bs,
                   num_batches=2, name=f"envpool-bench-{procs}-{bs}")
    try:
        a = np.zeros(bs, np.int64)
        for b in (0, 1):
            pool.step(b, a).result(30)
        n = batches if batches is not None else max(50, 20000 // bs)
        t0 = time.perf_counter()
        f0 = pool.step(0, a)
        f1 = pool.step(1, a)
        for _ in range(n):
            f0.result(30)
            f0 = pool.step(0, a)
            f1.result(30)
            f1 = pool.step(1, a)
        f0.result(30)
        f1.result(30)
        dt = time.perf_counter() - t0
        total = 2 * n + 2
        return {
            "env_steps_per_sec": round(total * bs / dt, 0),
            "us_per_batch": round(dt / total * 1e6, 1),
        }
    finally:
        pool.close()


def main(argv=None) -> int:
    from ..bench.harness import append_device_trend

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--config", action="append", default=None,
                    metavar="PROCS,BATCH")
    ap.add_argument("--batches", type=int, default=None,
                    help="loop iterations per config (default ~20000 "
                         "env steps)")
    args = ap.parse_args(argv)
    configs = ([tuple(int(x) for x in c.split(",")) for c in args.config]
               if args.config else CONFIGS)
    results = {}
    for procs, bs in configs:
        key = f"p{procs}_b{bs}"
        results[key] = bench(procs, bs, args.batches)
        print(json.dumps({key: results[key]}), flush=True)
        append_device_trend(
            f"envpool_{key}_steps_per_sec",
            results[key]["env_steps_per_sec"], "env-steps/s", CMD,
            extra={"procs": procs, "batch_size": bs},
        )
    art = {
        "cmd": CMD,
        "host": f"{os.cpu_count()}-core host",
        "note": (
            "trivial-env ceiling of the acting plane: shm slab writes, "
            "ring dispatch, process-shared semaphores, worker Python "
            "env.step loop; real env cost adds on top"
        ),
        "results": results,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
