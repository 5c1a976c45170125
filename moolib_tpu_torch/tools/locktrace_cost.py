"""What locktrace costs when it is on: a lock's creation and an
uncontended acquire/release, untraced and under
:class:`~moolib_tpu_torch.testing.locktrace.LockTrace`, then the seconds
of ``replica_kill(3)`` and ``fleet_bad_canary(5)`` (the two scenarios
whose gates are timed) untraced and traced, in turn for ``--rounds``.

Prints one JSON line: microseconds a lock created and an acquire with
its release (each the mean over ``--locks`` and ``--acquires``), and
each round's scenario seconds with the traced run's edge count.

Usage::

    python -m moolib_tpu_torch.tools.locktrace_cost [--locks 20000] \\
        [--acquires 200000] [--rounds 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def lock_costs(locks: int, acquires: int, traced: bool) -> dict:
    """Mean microseconds a ``threading.Lock()`` created and a ``with``
    acquire/release of one, with or without an active trace."""
    from ..testing.locktrace import LockTrace

    trace = LockTrace().activate() if traced else None
    try:
        t0 = time.perf_counter()
        for _ in range(locks):
            lock = threading.Lock()
        t1 = time.perf_counter()
        for _ in range(acquires):
            with lock:
                pass
        t2 = time.perf_counter()
    finally:
        if trace is not None:
            trace.deactivate()
    return {"create_us": (t1 - t0) / locks * 1e6,
            "acquire_us": (t2 - t1) / acquires * 1e6}


def scenario_seconds(traced: bool, device: str) -> dict:
    """Seconds of the two timed-gate scenarios, traced or not, and the
    traced run's observed edge count."""
    from ..testing.locktrace import LockTrace
    from ..testing.scenarios import SCENARIOS

    trace = LockTrace().activate() if traced else None
    t0 = time.perf_counter()
    try:
        SCENARIOS["replica_kill"](3, device=device)
        SCENARIOS["fleet_bad_canary"](5, device=device)
    finally:
        if trace is not None:
            trace.deactivate()
    out = {"seconds": time.perf_counter() - t0}
    if trace is not None:
        out["edges"] = len(trace.edges())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--locks", type=int, default=20000)
    ap.add_argument("--acquires", type=int, default=200000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cpu",
                    help="the scenarios' replicas' device")
    args = ap.parse_args(argv)

    from .. import set_log_level

    set_log_level("error")
    report = {
        "untraced": lock_costs(args.locks, args.acquires, False),
        "traced": lock_costs(args.locks, args.acquires, True),
        "scenarios": [
            {"untraced": scenario_seconds(False, args.device),
             "traced": scenario_seconds(True, args.device)}
            for _ in range(args.rounds)],
    }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
