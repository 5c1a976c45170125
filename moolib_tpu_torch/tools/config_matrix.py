"""Run all five BASELINE.md benchmark configs briefly and record the
coverage artifact; the twin of the reference's ``tools/config_matrix.py``.

BASELINE.md names five configs the framework must reproduce; this tool
drives each one end to end on the port's ``train`` functions (real env
packages when installed, the documented synthetic stand-ins otherwise)
for a bounded slice and records env steps, updates and the loss per
config:

1. IMPALA/V-trace single peer, Atari-shaped pixels (examples/vtrace).
2. A2C on Atari-shaped pixels (examples/a2c, pixel path).
3. IMPALA multi-peer elastic DP: TWO OS-process peers over one
   in-process broker sharing a virtual batch (the Accumulator plane end
   to end).
4. IMPALA on ProcGen (config_procgen.yaml shapes: 64x64x3, ResNet, 15
   actions).
5. R2D2-style LSTM on NetHack (config_nethack.yaml shapes: glyph+blstats
   dict obs, LSTM core shipped per unroll).

Every config runs on ``--device`` (the card unless ``cpu`` is given).
Configs 1, 4 and 5 start an EnvPool, whose spawn workers import this
module as their main module, and config 3's peers are spawn processes
too: torch and the package are imported inside the functions only.

Usage::

    python -m moolib_tpu_torch.tools.config_matrix [--seconds 60] \\
        [--json OUT] [--only N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import sys
import time


def _finite_losses(rows):
    # The final window can be update-free (an empty StatMean is NaN), so
    # the report takes the last FINITE loss.
    return [
        r["total_loss"] for r in rows
        if r.get("total_loss") is not None
        and math.isfinite(r["total_loss"])
    ]


def _vtrace_run(seconds, device, **overrides):
    from ..examples.vtrace.experiment import VtraceConfig, train

    cfg = VtraceConfig(
        total_steps=10**9, max_seconds=seconds,
        log_interval_steps=500, stats_interval=2.0, **overrides,
    )
    rows = train(cfg, log_fn=lambda *a, **k: None, device=device)
    if not rows:
        return {"ok": False, "error": "no log rows"}
    last = rows[-1]
    finite = _finite_losses(rows)
    updates = int(last.get("updates", 0))
    return {
        "ok": updates > 0 and bool(finite),
        "env_steps": int(last["env_steps"]),
        "updates": updates,
        "total_loss": round(finite[-1], 4) if finite else None,
    }


def config_1(seconds, device=None):
    """IMPALA/V-trace, single peer, Atari-shaped pixels."""
    return _vtrace_run(
        seconds, device, env="synthetic", model="resnet", num_actions=6,
        actor_batch_size=16, learn_batch_size=16, virtual_batch_size=16,
        num_actor_processes=1, unroll_length=20,
    )


def config_2(seconds, device=None):
    """A2C on Atari-shaped pixels (no Accumulator). A2CConfig has no
    wall-clock stop; bound by steps sized for a ~minute-scale CPU slice."""
    from ..examples.a2c import A2CConfig, train

    cfg = A2CConfig(
        env="synthetic", total_steps=2048, log_interval_steps=512,
    )
    rows = train(cfg, log_fn=lambda *a, **k: None, device=device)
    if not rows:
        return {"ok": False, "error": "no log rows"}
    finite = _finite_losses(rows)
    return {
        "ok": bool(finite),
        "env_steps": int(rows[-1]["env_steps"]),
        "updates": int(rows[-1].get("updates", 0)),
        "total_loss": round(finite[-1], 4) if finite else None,
    }


def _peer_main(broker_addr, name, seconds, device, q):
    try:
        from moolib_tpu_torch.examples.vtrace.experiment import (
            VtraceConfig, train,
        )

        cfg = VtraceConfig(
            env="cartpole", broker=broker_addr, group="cfgmatrix",
            actor_batch_size=8, learn_batch_size=8, virtual_batch_size=16,
            num_actor_processes=1, unroll_length=20,
            total_steps=10**9, max_seconds=seconds,
            log_interval_steps=500, stats_interval=2.0,
        )
        rows = train(cfg, log_fn=lambda *a, **k: None, device=device)
        last = rows[-1] if rows else {}
        finite = _finite_losses(rows)
        q.put((name, {
            "env_steps": int(last.get("env_steps", 0)),
            "updates": int(last.get("updates", 0)),
            "total_loss": round(finite[-1], 4) if finite else None,
        }))
    except Exception as e:
        q.put((name, {"error": f"{type(e).__name__}: {e}"}))


def config_3(seconds, device=None):
    """Elastic DP: two OS-process peers share one virtual batch via the
    Accumulator over a broker — both must train."""
    from ..examples.common import InProcessBroker

    broker = InProcessBroker()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        # daemon=False: the peers spawn EnvPool worker children themselves.
        ctx.Process(
            target=_peer_main,
            args=(broker.address, f"peer{i}", seconds, device, q),
        )
        for i in range(2)
    ]
    for p in procs:
        p.start()
    peers = {}
    harness_error = None
    try:
        for _ in range(2):
            name, res = q.get(timeout=seconds * 4 + 300)
            peers[name] = res
    except Exception as e:
        harness_error = f"{type(e).__name__}: {e}"
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    broker.close()
    ok = (
        harness_error is None
        and len(peers) == 2
        and all(
            isinstance(v, dict) and "error" not in v
            and v.get("updates", 0) > 0
            for v in peers.values()
        )
    )
    out = {"ok": ok, "peers": peers}
    if harness_error:
        out["harness_error"] = harness_error
    return out


def config_4(seconds, device=None):
    """IMPALA on ProcGen shapes (config_procgen.yaml)."""
    return _vtrace_run(
        seconds, device, env="procgen:coinrun", model="resnet",
        num_actions=15, actor_batch_size=16, learn_batch_size=16,
        virtual_batch_size=16, num_actor_processes=1, unroll_length=20,
    )


def config_5(seconds, device=None):
    """R2D2-style LSTM on NetHack shapes (config_nethack.yaml)."""
    return _vtrace_run(
        seconds, device, env="nethack", model="nethack", num_actions=23,
        actor_batch_size=8, learn_batch_size=8, virtual_batch_size=8,
        num_actor_processes=1, unroll_length=16, use_lstm=True,
    )


CONFIGS = {
    1: ("IMPALA/V-trace single peer, Atari-shaped", config_1),
    2: ("A2C, Atari-shaped pixels", config_2),
    3: ("IMPALA elastic DP, 2 OS-process peers", config_3),
    4: ("IMPALA ProcGen shapes (ResNet)", config_4),
    5: ("R2D2-style LSTM NetHack shapes", config_5),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    installed = {}
    for m in ("ale_py", "procgen", "nle"):
        try:
            __import__(m)
            installed[m] = True
        except ImportError:
            installed[m] = False

    cmd = ("python -m moolib_tpu_torch.tools.config_matrix "
           f"--seconds {args.seconds}")
    if args.device is not None:
        cmd += f" --device {args.device}"
    art = {
        "round": 4,
        "cmd": cmd,
        "device": args.device or "cuda",
        "env_packages_installed": installed,
        "note": (
            "synthetic stand-ins used where env packages are absent "
            "(documented shapes from config_procgen/config_nethack yamls)"
        ),
        "configs": {},
    }
    # --only merges into an existing artifact instead of clobbering it.
    if args.json and args.only is not None and os.path.exists(args.json):
        try:
            with open(args.json) as f:
                art["configs"] = json.load(f).get("configs", {})
        except (OSError, json.JSONDecodeError):
            pass
    for i, (label, fn) in CONFIGS.items():
        if args.only is not None and i != args.only:
            continue
        t0 = time.monotonic()
        try:
            res = fn(args.seconds, args.device)
        except Exception as e:
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
        res["label"] = label
        res["wall_s"] = round(time.monotonic() - t0, 1)
        art["configs"][str(i)] = res
        print(json.dumps({i: res}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
    bad = [i for i, r in art["configs"].items() if not r.get("ok")]
    print(json.dumps({"all_ok": not bad, "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
