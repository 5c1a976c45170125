"""chaosnet scenario runner of the port: seeded fault-injection soak for
the RPC/Group/Accumulator stack, durable state, the serving tier, the env
tier and the fleet; the twin of the reference's ``tools/chaos_soak.py``.

Runs the canonical chaos scenarios (:mod:`moolib_tpu_torch.testing.
scenarios` — the SAME implementations the tests pin, so the soak and the
tests cannot drift) against a live in-process cluster. Two modes:

- ``--smoke``: one pass over all eighteen scenarios (loss storm,
  partition+heal, leader loss, learner SIGKILL+restart, broker
  kill+standby promotion, straggler slow-link quorum commit, shm lane
  fallback, the three durable-state ones, serving replica-kill mid-load
  and router-partition, the env tier's worker SIGKILL mid-batch,
  SIGSTOP wedge vs the hung-step watchdog and poison-env quarantine, and
  the fleet tier's controller SIGKILL mid-rollout, bad-canary rollback
  and replica crash-loop).
- ``--seed N --minutes M``: the long-run soak — scenarios loop with
  seeds derived from ``N`` until the time budget is spent, so one
  invocation covers many distinct seeded schedules.
- ``--scenario GLOB`` restricts either mode to the scenarios matching
  an fnmatch pattern (an exact name still selects just that one).

``--device`` is the serving and fleet scenarios' replicas' device: the
card unless ``cpu`` is given. The other scenarios run numpy models on
the host.

Every scenario reports the plan's injected-event summary; a failure
prints the seed that produced it and a ready replay command — plus the
path of the incident bundle captured at the moment of failure (the
flight-recorder ring, spans, metrics, thread stacks and fingerprint of
the failing run), so a rare soak failure leaves evidence even when the
replay does not reproduce it. The runner enables flightrec auto-capture
for its whole pass (``--incident-dir``), so in-stack triggers (breaker
open, round-failure storm, worker budget exhaustion) also capture while
scenarios run. ``--locktrace`` runs the pass under instrumented locks
(:class:`~moolib_tpu_torch.testing.locktrace.LockTrace`): the observed
acquires-while-holding graph must be acyclic and inside
:func:`~moolib_tpu_torch.testing.locktrace.static_package_edges`, or the
pass fails. ``--restrack`` runs every scenario under the
:class:`~moolib_tpu_torch.testing.restrack.ResourceTracker`: a scenario
that leaves a thread, shm segment, Rpc or gauge registration of the
port unreleased fails. The JSON report aggregates per-scenario wall time
(``scenario_seconds``) and records bundle paths per failed scenario.

Usage::

    python -m moolib_tpu_torch.tools.chaos_soak --smoke [--device cpu]
    python -m moolib_tpu_torch.tools.chaos_soak --smoke --restrack
    python -m moolib_tpu_torch.tools.chaos_soak --smoke --locktrace
    python -m moolib_tpu_torch.tools.chaos_soak --smoke --scenario 'broker_*'
    python -m moolib_tpu_torch.tools.chaos_soak --seed 7 --minutes 10
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from fnmatch import fnmatchcase

REPLAY = "python -m moolib_tpu_torch.tools.chaos_soak"


def _takes_device(fn) -> bool:
    return "device" in inspect.signature(fn).parameters


def main(argv=None):
    # Imported here, not at the top: the env tier's EnvPool starts its
    # workers with spawn, and a spawn worker imports the main module
    # (this one, under ``python -m``). At the top, these imports would
    # put torch and the RPC stack into every env worker and its every
    # respawn, which the kill and wedge scenarios time.
    from ..flightrec import capture_incident, enable_auto_capture
    from ..rpc import RpcError
    from ..testing.scenarios import SCENARIOS

    # Scenario failures surface as AssertionError (invariant violations)
    # or, when a guarantee breaks badly enough that a wait expires first,
    # as the timeout/RPC errors the drives raise. All of them must
    # produce the seed + replay line and the JSON report — never a raw
    # traceback.
    failures = (AssertionError, RpcError, TimeoutError)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="base seed; soak iterations derive from it")
    parser.add_argument("--minutes", type=float, default=1.0,
                        help="soak time budget (ignored with --smoke)")
    parser.add_argument("--smoke", action="store_true",
                        help="one bounded pass over all scenarios")
    parser.add_argument("--scenario",
                        help="restrict to scenarios matching this fnmatch "
                             "glob (e.g. 'broker_*'; an exact name works "
                             f"too); known: {', '.join(sorted(SCENARIOS))}")
    parser.add_argument("--device", default=None,
                        help="the serving and fleet scenarios' replicas' "
                             "device (default: the card)")
    parser.add_argument("--incident-dir", default="incidents",
                        help="where incident bundles are written: the "
                             "scenario-failure capture, plus any in-stack "
                             "auto-capture trigger that fires during the "
                             "pass")
    parser.add_argument("--locktrace", action="store_true",
                        help="run under instrumented locks "
                             "(moolib_tpu_torch.testing.locktrace): record "
                             "the real acquires-while-holding graph, then "
                             "assert it is acyclic AND inside racelint's "
                             "static over-approximation")
    parser.add_argument("--restrack", action="store_true",
                        help="run under the resource tracker "
                             "(moolib_tpu_torch.testing.restrack): every "
                             "tracked acquisition (threads, SharedMemory, "
                             "Rpcs, gauge registrations) made by a scenario "
                             "must be released by its end; a leak fails the "
                             "scenario with the acquisition-site stack")
    args = parser.parse_args(argv)

    if args.scenario:
        names = sorted(n for n in SCENARIOS
                       if fnmatchcase(n, args.scenario))
        if not names:
            parser.error(
                f"--scenario {args.scenario!r} matches none of "
                f"{sorted(SCENARIOS)}"
            )
    else:
        names = sorted(SCENARIOS)

    # Black-box auto-capture for the whole pass: a breaker opening or a
    # worker exhausting its restart budget mid-scenario freezes a bundle
    # even when the scenario itself goes on to pass.
    enable_auto_capture(args.incident_dir)

    trace = None
    if args.locktrace:
        from ..testing.locktrace import LockTrace

        trace = LockTrace()
        trace.activate()

    tracker = None
    if args.restrack:
        from ..testing.restrack import ResourceTracker

        tracker = ResourceTracker()
        tracker.activate()

    dev_args = [] if args.device is None else ["--device", args.device]
    runs = []
    ok = True
    t_start = time.monotonic()
    deadline = (
        None if args.smoke else t_start + args.minutes * 60.0
    )
    iteration = 0
    while True:
        for name in names:
            seed = args.seed + 1000 * iteration + len(runs)
            fn = SCENARIOS[name]
            kwargs = {"device": args.device} if _takes_device(fn) else {}
            t0 = time.monotonic()
            tok = tracker.mark() if tracker is not None else 0
            try:
                summary = fn(seed, **kwargs)
                if tracker is not None:
                    # ResourceLeak is an AssertionError: a scenario that
                    # leaks fails exactly like an invariant violation.
                    tracker.assert_released(
                        since=tok, what=f"{name} seed={seed}"
                    )
                runs.append({
                    "scenario": name, "seed": seed, "ok": True,
                    "seconds": round(time.monotonic() - t0, 2),
                    "injected": summary,
                })
                print(f"ok   {name} seed={seed} "
                      f"({runs[-1]['seconds']}s) {summary}", flush=True)
            except failures as e:
                ok = False
                runs.append({
                    "scenario": name, "seed": seed, "ok": False,
                    "seconds": round(time.monotonic() - t0, 2),
                    "error": f"{type(e).__name__}: {e}",
                })
                print(f"FAIL {name} seed={seed}: "
                      f"{type(e).__name__}: {e}")
                print(" ".join(["  replay:", REPLAY, "--scenario", name,
                                "--seed", str(seed), "--smoke",
                                *dev_args]))
                # Freeze the black box at the moment of failure: the
                # bundle (event ring, spans, metrics, thread stacks)
                # is the evidence when the seeded replay does NOT
                # reproduce (live interleavings differ — see the
                # determinism contract in testing/chaos.py).
                try:
                    bundle_path = capture_incident(
                        "scenario_failure",
                        f"{name} seed={seed}: {type(e).__name__}: {e}",
                        out_dir=args.incident_dir,
                    )
                except Exception as ce:  # noqa: BLE001
                    # Sync CLI context (no task to cancel): a failed
                    # capture must not mask the scenario failure.
                    print(f"  (incident capture failed: {ce})")
                else:
                    runs[-1]["bundle"] = bundle_path
                    print(f"  incident bundle: {bundle_path}", flush=True)
            if deadline is not None and time.monotonic() > deadline:
                break
        iteration += 1
        if args.smoke or (deadline is not None
                          and time.monotonic() > deadline) or not ok:
            break
    restrack_report = None
    if tracker is not None:
        tracker.deactivate()
        restrack_report = {
            "tracked": tracker.mark(),
            "leaked": dict(tracker.counts()),
        }
        print(f"restrack: {restrack_report['tracked']} tracked "
              f"acquisition(s), leaked={restrack_report['leaked'] or 0}")
    locktrace_report = None
    if trace is not None:
        trace.deactivate()
        from ..testing.locktrace import (LockOrderViolation,
                                         static_package_edges)

        locktrace_report = {"edges": len(trace.edges())}
        try:
            trace.assert_acyclic()
            trace.assert_within(static_package_edges())
        except LockOrderViolation as e:
            ok = False
            locktrace_report["violation"] = str(e)
            print(f"FAIL locktrace: {e}")
        else:
            print(f"locktrace: {locktrace_report['edges']} observed "
                  "lock-order edge(s), acyclic, within the static graph")
    scenario_seconds = {}
    for r in runs:
        scenario_seconds[r["scenario"]] = round(
            scenario_seconds.get(r["scenario"], 0.0) + r["seconds"], 2
        )
    print(json.dumps({
        "ok": ok,
        "runs": len(runs),
        "failed": [r for r in runs if not r["ok"]],
        "total_seconds": round(time.monotonic() - t_start, 1),
        "scenario_seconds": scenario_seconds,
        **({"locktrace": locktrace_report} if locktrace_report else {}),
        **({"restrack": restrack_report} if restrack_report else {}),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
