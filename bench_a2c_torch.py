"""A2C's learning bar over seeds: examples/a2c.py on CartPole at
LEARNING_r04.json's settings (80,000 env steps, log windows of 4,000),
scored by its bar: return > 100 in at least 10 of the last 20 windows,
and the last 10 windows' entropy inside (0.05, 0.69).

Runs the port's A2C once per seed, in order (a seed may repeat, to see
whether a run replays), and prints one JSON line per run; then one
summary line::

    python bench_a2c_torch.py --seeds 0,1,2,3 [--device cpu]

Or scores the printed rows of either package's A2C command line, one log
file per run (the rows are "steps N  return R  loss L  entropy E
updates U")::

    python -m moolib_tpu_torch.examples.a2c --seed 3 --total-steps 80000 \\
        > port3.log
    python bench_a2c_torch.py --score port3.log ...

The run is paced by wall clock (updates race env steps through the
asynchronous Accumulator), so the host's speed is part of the result.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from typing import List, Optional

STEPS = 80_000            # LEARNING_r04.json's run
WINDOW = 4_000            # A2CConfig.log_interval_steps
BAR = (100.0, 10, 20)     # return > 100 in >= 10 of the last 20 windows
ENTROPY = (0.05, 0.69)    # the reference test's bound, last 10 windows

_ROW = re.compile(r"steps\s+(\d+)\s+return\s+(\S+)\s+loss\s+(\S+)\s+"
                  r"entropy\s+(\S+)\s+updates\s+(\S+)")


def score(rows: List[dict]) -> dict:
    """The bar's reading of a run's log rows."""
    bar, need, last = BAR
    tail = [r["mean_episode_return"] for r in rows[-last:]]
    hits = sum(r > bar for r in tail)
    ents = [r["entropy"] for r in rows[-10:]]
    return dict(
        hits=hits, windows=len(tail),
        met=len(tail) == last and hits >= need,
        entropy_ok=bool(ents) and all(
            ENTROPY[0] < e < ENTROPY[1] for e in ents),
        updates=rows[-1]["updates"] if rows else 0,
        tail=[round(r, 2) for r in tail],
        entropy=[round(e, 4) for e in ents])


def run(seed: int, device: Optional[str] = None) -> dict:
    """The port's A2C at the bar's settings with ``seed``: the score,
    the wall time and the curve (env steps, return, entropy)."""
    from moolib_tpu_torch.examples import a2c

    t0 = time.perf_counter()
    rows = a2c.train(a2c.A2CConfig(total_steps=STEPS,
                                   log_interval_steps=WINDOW, seed=seed),
                     log_fn=lambda *a: None, device=device)
    wall = time.perf_counter() - t0
    return dict(seed=seed, wall_s=wall, **score(rows),
                dropped_unrolls=rows[-1]["dropped_unrolls"],
                curve=[(r["env_steps"], round(r["mean_episode_return"], 2),
                        round(r["entropy"], 4)) for r in rows])


def score_log(path: str) -> dict:
    """The bar's reading of one A2C command line's printed rows."""
    with open(path) as f:
        rows = [dict(env_steps=int(m[1]), mean_episode_return=float(m[2]),
                     total_loss=float(m[3]), entropy=float(m[4]),
                     updates=float(m[5]))
                for m in map(_ROW.search, f) if m]
    return dict(log=path, **score(rows))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=str, default="0",
                   help="comma-separated seeds, run in order")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    p.add_argument("--score", nargs="+", default=None,
                   help="score these A2C command-line logs instead")
    args = p.parse_args()
    if args.score:
        results = [score_log(path) for path in args.score]
    else:
        results = [run(int(s), args.device) for s in args.seeds.split(",")]
    for r in results:
        print(json.dumps(r), flush=True)
    print(json.dumps(dict(
        runs=len(results), met=sum(r["met"] for r in results),
        hits=[r["hits"] for r in results])))


if __name__ == "__main__":
    main()
