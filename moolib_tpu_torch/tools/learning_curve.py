"""Record a learning-curve artifact against the reference's integration
bar; the twin of the reference's ``tools/learning_curve.py``.

Runs the port's A2C example (the same code path ``python -m
moolib_tpu_torch.examples.a2c`` uses) on CartPole — the env the
reference's own integration test trains (reference:
test/integration/test_a2c.py:16-36 — A2C on CartPole, pass = return >
100 on >= 50% of the final log windows) — records every log row,
evaluates the bar, and writes the JSON artifact with the reference's
keys (plus ``device``).

The artifact goes under ``build/`` by default; no committed file is ever
written unless ``--json`` names it. The run is on the card unless
``--device cpu`` is given.

Usage::

    python -m moolib_tpu_torch.tools.learning_curve [--steps 80000] \\
        [--json OUT] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_JSON = os.path.join(REPO, "build", "learning_curve.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=80_000)
    ap.add_argument("--json", default=DEFAULT_JSON)
    ap.add_argument("--env", default="cartpole")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # Imported here: A2C's EnvPool spawns workers that import this module
    # as their main module, and they must not pull in torch.
    from ..examples.a2c import A2CConfig, train

    cfg = A2CConfig(env=args.env, total_steps=args.steps)
    t0 = time.perf_counter()
    rows = train(cfg, log_fn=lambda *a, **k: None, device=args.device)
    wall = time.perf_counter() - t0

    tail = [r["mean_episode_return"] for r in rows[-20:]]
    bar_hits = sum(r > 100 for r in tail)
    # An empty window must FAIL — a run too short to log anything has
    # measured nothing, not passed vacuously.
    passed = bool(tail) and bar_hits >= len(tail) / 2
    cmd = ["python -m moolib_tpu_torch.tools.learning_curve",
           f"--steps {args.steps}"]
    if args.device is not None:
        cmd.append(f"--device {args.device}")
    art = {
        "round": 4,
        "cmd": " ".join(cmd),
        "env": args.env,
        "algo": "A2C (moolib_tpu_torch/examples/a2c.py)",
        "device": args.device or "cuda",
        "total_steps": args.steps,
        "wall_s": round(wall, 1),
        "reference_bar": (
            "return > 100 on >= 50% of final log windows "
            "(ref test/integration/test_a2c.py:16-36)"
        ),
        "final_window_returns": [round(r, 1) for r in tail],
        "bar_hits": f"{bar_hits}/{len(tail)}",
        "passed": bool(passed),
        "curve": [
            {
                "env_steps": r["env_steps"],
                "mean_episode_return": round(r["mean_episode_return"], 2),
                "entropy": round(r.get("entropy", float("nan")), 4),
            }
            for r in rows
        ],
        "note": (
            "CartPole: the env and bar of the reference's own integration "
            "suite; ALE/ProcGen are not installed (env_packages_report)."
        ),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({k: art[k] for k in
                      ("passed", "bar_hits", "total_steps", "wall_s")}))
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
