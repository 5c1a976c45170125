"""perf: the one perfwatch CLI of the port — every benchmark behind one
front end; the twin of the reference's ``tools/perf.py``.

Suites:
    cpu-proxy   the reference's 15 hot-path rows on the port's modules
                (RPC echo/payload, loopback tree allreduce, batcher fill,
                envpool, serial, statestore, serving, fleet, the learner
                step under a Hotwatch window, the parity check); the
                serving, fleet and learner rows on ``--device``
    device      the card sweep (bench_torch.py, perf_sweep, attn_bench,
                bench_e2e_torch.py) via
                ``python -m moolib_tpu_torch.tools.chip_session``, feeding
                the same trend store

Usage::

    python -m moolib_tpu_torch.tools.perf --suite cpu-proxy --smoke
    python -m moolib_tpu_torch.tools.perf --suite cpu-proxy --smoke --device cpu
    python -m moolib_tpu_torch.tools.perf --only rpc_echo_latency_s
    python -m moolib_tpu_torch.tools.perf --list
    python -m moolib_tpu_torch.tools.perf --check-trends --trends STORE
    python -m moolib_tpu_torch.tools.perf --suite device -- --rehearse

Gate semantics (exit 1 on any): a benchmark errored (null row), a budget
breach (absolute guardrails, telemetry-histogram p50/p99 ceilings), or a
trend regression (latest vs trailing-window median outside the
noise-aware tolerance band). Every failure prints a reproduce command;
with ``--format=gha`` (auto-picked on GitHub runners) failures also emit
``::error`` workflow annotations. A usage error (an unknown benchmark)
exits 2.

Results append to the JSONL trend store (default
``build/perf/trends.jsonl``, ``--no-trends`` to skip).

Top-level imports stay light (no torch): the suite's EnvPool workers
import this module again when it runs as ``__main__``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TRENDS = os.path.join("build", "perf", "trends.jsonl")


def _gha(kind: str, msg: str) -> str:
    msg = (msg.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A"))
    return f"::{kind} title=perfwatch::{msg}"


def run_device_suite(args, passthrough) -> int:
    """The card sweep rides ``tools/chip_session.py``; ``MOOLIB_TRENDS``
    points its stages at the same store."""
    env = dict(os.environ)
    if not args.no_trends:
        env["MOOLIB_TRENDS"] = os.path.abspath(args.trends)
    cmd = [sys.executable, "-m", "moolib_tpu_torch.tools.chip_session"]
    if args.device is not None:
        cmd += ["--device", args.device]
    cmd += passthrough
    print(f"perf: device suite -> {' '.join(cmd)}", flush=True)
    return subprocess.run(cmd, cwd=REPO, env=env).returncode


def gate_trends(args):
    """THE trend gate, shared by --check-trends and the post-run path:
    ``(rows, regressions)`` for the store at ``args.trends`` (``([],
    [])`` when the store does not exist yet)."""
    from ..bench import detect_regressions, load_trends

    if not os.path.exists(args.trends):
        return [], []
    rows = load_trends(args.trends)
    return rows, detect_regressions(
        rows, window=args.window, min_history=args.min_history,
        tolerance=args.tolerance,
    )


def check_trends(args, fmt: str) -> int:
    """Gate an existing store, whole-store semantics: every metric's
    latest state counts — a regression in any series, or a series whose
    latest row is a null artifact (an errored run must not read as a
    green gate)."""
    rows, regs = gate_trends(args)
    latest = {}
    for r in rows:
        latest[(r.metric, bool(r.smoke))] = r
    nulls = sorted((r for r in latest.values() if r.value is None),
                   key=lambda r: r.metric)
    failures = [f"REGRESSION {r.message()}" for r in regs] + [
        f"NULL {r.metric}: latest row errored ({r.error}); "
        f"reproduce: {r.cmd or '<no cmd recorded>'}"
        for r in nulls
    ]
    for line in failures:
        print(_gha("error", line) if fmt == "gha" else line)
    print(f"perf: trend gate: {len(rows)} row(s), {len(regs)} "
          f"regression(s), {len(nulls)} trailing null(s)")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perf", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--suite", choices=("cpu-proxy", "device"),
                    default="cpu-proxy")
    ap.add_argument("--smoke", action="store_true",
                    help="short repeats / small sizes")
    ap.add_argument("--only", action="append", default=None, metavar="BENCH",
                    help="run only these benchmarks (repeatable / comma "
                         "lists); also the reproduce-command form")
    ap.add_argument("--device", default=None,
                    help="the device rows' device (default: the card)")
    ap.add_argument("--trends", default=os.path.join(REPO, DEFAULT_TRENDS),
                    help=f"JSONL trend store (default: {DEFAULT_TRENDS})")
    ap.add_argument("--no-trends", action="store_true",
                    help="do not append results or run the trend gate")
    ap.add_argument("--check-trends", action="store_true",
                    help="run no benchmarks; gate the existing store")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="suite wall-clock cap (default: 300 with --smoke); "
                         "benchmarks past the cap record null rows and fail "
                         "the gate")
    ap.add_argument("--no-budgets", action="store_true",
                    help="skip the absolute budget guardrails")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--min-history", type=int, default=3)
    ap.add_argument("--tolerance", type=float, default=0.15)
    ap.add_argument("--list", action="store_true", dest="list_benches",
                    help="list the suite catalogue and exit")
    ap.add_argument("--format", choices=("text", "gha"), default=None,
                    dest="fmt",
                    help="gha: GitHub ::error annotations on failures "
                         "(auto-picked when GITHUB_ACTIONS is set)")
    ap.add_argument("passthrough", nargs="*",
                    help="args after -- go to the device-suite orchestrator")
    args = ap.parse_args(argv)
    fmt = args.fmt or ("gha" if os.environ.get("GITHUB_ACTIONS") else "text")

    from ..bench import CPU_PROXY_SUITE, append_trend, evaluate_budgets

    if args.list_benches:
        for name, fn in CPU_PROXY_SUITE.items():
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:26s} {doc}")
        return 0

    if args.check_trends:
        return check_trends(args, fmt)

    if args.suite == "device":
        return run_device_suite(args, args.passthrough)

    only = None
    if args.only:
        only = [b for chunk in args.only for b in chunk.split(",") if b]
    max_seconds = args.max_seconds
    if max_seconds is None and args.smoke:
        max_seconds = 300.0

    from ..bench.suite import run_suite

    try:
        results = run_suite(
            smoke=args.smoke, only=only, max_seconds=max_seconds,
            log=lambda s: print(s, flush=True), device=args.device,
        )
    except ValueError as e:
        print(f"perf: error: {e}", file=sys.stderr)
        return 2

    failures = []
    nulls = [r for r in results if r.value is None]
    for r in nulls:
        failures.append(f"NULL {r.metric}: {r.error}; reproduce: {r.cmd}")

    breaches = []
    if not args.no_budgets:
        for r in results:
            breaches.extend(evaluate_budgets(r))
        for b in breaches:
            failures.append(f"BUDGET {b.message()}")

    regressions = []
    if not args.no_trends:
        for r in results:
            append_trend(args.trends, r)
        _rows, regressions = gate_trends(args)
        # Post-run gate: only THIS run's metrics can fail it. The shared
        # store also holds other series (device rows, un-run benchmarks)
        # whose stale latest row must not red an unrelated run —
        # whole-store semantics live in --check-trends.
        ran = {res.metric for res in results}
        regressions = [r for r in regressions if r.metric in ran]
        for r in regressions:
            failures.append(f"REGRESSION {r.message()}")

    for line in failures:
        print(_gha("error", line) if fmt == "gha" else line, flush=True)
    # The hand-written kernels this run launched (none if the suite never
    # loaded them): a caller in another process reads them here.
    kernels = sys.modules.get("moolib_tpu_torch.ops._kernels")
    print(json.dumps({
        "suite": args.suite,
        "smoke": bool(args.smoke),
        "results": len(results),
        "nulls": len(nulls),
        "budget_breaches": len(breaches),
        "regressions": len(regressions),
        "trends": None if args.no_trends else os.path.abspath(args.trends),
        "kernel_launches": {} if kernels is None else {
            k.name: k.launches for k in kernels.KERNELS},
    }), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
