"""Render a cohort's step-phase attribution (stepscope) as one report;
the twin of the reference's ``tools/stepscope_report.py``.

Every hot loop instrumented with
:class:`~moolib_tpu_torch.telemetry.StepScope` exports its phase ledgers
as ordinary ``stepscope_*`` registry series, so this tool needs no code
in the cohort itself: it reads registry snapshots from any of three
sources and reconstructs per-loop summaries with
:func:`~moolib_tpu_torch.telemetry.summarize_stepscope`:

- ``--connect`` — dial into a live cohort and crawl every reachable
  peer's ``__telemetry`` endpoint (the same crawl as
  :mod:`~moolib_tpu_torch.tools.telemetry_dump` /
  :mod:`~moolib_tpu_torch.tools.incident_report` —
  :func:`moolib_tpu_torch.flightrec.crawl_cohort`);
- ``--metrics FILE`` — a ``metrics.json`` previously written by
  ``telemetry_dump`` (``{peer: {series_id: series}}``);
- ``--bundles DIR`` — frozen ``__flightrec`` incident bundles: each
  bundle's ``metrics`` entry is a registry snapshot per telemetry
  source, so phase attribution survives the peer that produced it.

Outputs under ``--out``:

- ``report.json`` — ``{"peers": {peer: {loop: summary}}, "merged":
  {loop: summary}}``; each summary is step count, wall seconds,
  per-phase seconds, and the three derived critical-path fractions
  (``exposed_comms`` / ``host_blocked`` / ``env_wait``). Windowed gauge
  readings ride under ``"window"`` when the scrape caught a live loop.
- ``trace.json`` — Chrome-trace *composition* tracks: one track per
  peer, one row per loop, phases drawn back-to-back with widths
  proportional to cumulative seconds.
- stdout — the same report as aligned text tables.

The merged-cohort view deduplicates identical per-loop summaries first:
two peers in one OS process each merge the process-global registry into
their scrape, so a naive cross-peer sum would double-count every
global-registry loop.

``--smoke`` is the self-test: run a short instrumented A2C cohort
in-process on ``--device`` (the card unless ``cpu`` is given), assert
every loop's phase ledger sums to its measured wall time within
``--tolerance`` (default 5%), render the report from the live registry,
and append schema-valid ``stepscope_*_fraction`` rows to the
``--trends`` store (``build/perf/trends.jsonl`` by default), gated by
the same regression detector as the perf suite.

Usage::

    python -m moolib_tpu_torch.tools.stepscope_report --connect 127.0.0.1:4411 --out rep/
    python -m moolib_tpu_torch.tools.stepscope_report --metrics dump/metrics.json
    python -m moolib_tpu_torch.tools.stepscope_report --bundles incidents/ --out rep/
    python -m moolib_tpu_torch.tools.stepscope_report --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..telemetry import summarize_stepscope
from ..telemetry.stepscope import merge_summaries, phase_trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Ledger-closure tolerance for --smoke: |sum(phases) - wall| / wall.
DEFAULT_TOLERANCE = 0.05

SMOKE_CMD = "python -m moolib_tpu_torch.tools.stepscope_report --smoke"


# -- collection ---------------------------------------------------------------

def collect_live(connect, want, timeout: float, discover_seconds: float):
    """Crawl ``__telemetry`` across a live cohort -> ``{peer: summaries}``.

    Returns ``(peer_summaries, failed)``; peers whose scrape holds no
    ``stepscope_*`` series are reported with an empty summary dict so
    "reached but uninstrumented" is distinguishable from "unreachable".
    """
    from ..flightrec import crawl_cohort
    from ..rpc import Rpc
    from ..telemetry import Telemetry

    rpc = Rpc("stepscope-report",
              telemetry=Telemetry("stepscope", enabled=False))
    rpc.set_timeout(timeout)
    try:
        def scrape(peer):
            snap = rpc.sync(peer, "__telemetry")
            return summarize_stepscope(snap["metrics"]), snap.get("peers", [])

        def progress(peer, summaries):
            print(f"ok   {peer}: {len(summaries)} instrumented loop(s)")

        results, failed = crawl_cohort(
            rpc, connect, scrape, want=want,
            discover_seconds=discover_seconds, on_result=progress,
        )
        for peer, err in failed:
            print(f"FAIL {peer}: {err}", file=sys.stderr)
        return results, failed
    finally:
        rpc.close()


def collect_metrics_file(path: str):
    """Load a ``telemetry_dump`` ``metrics.json`` -> ``{peer: summaries}``."""
    with open(path) as f:
        dump = json.load(f)
    return {peer: summarize_stepscope(snap) for peer, snap in dump.items()}


def collect_bundles(bundles_dir: str):
    """Summarize the ``metrics`` entry of every incident bundle under
    ``bundles_dir``. Bundles carry one snapshot per telemetry source
    (the peer's own registry plus the merged process-global one); each
    source becomes its own "peer" keyed ``<bundle-peer>/<source>`` so
    attribution stays traceable to the registry that recorded it."""
    from ..flightrec import load_bundle

    out = {}
    for path in sorted(glob.glob(os.path.join(bundles_dir, "*.json"))):
        if os.path.basename(path) == "offsets.json":
            continue
        try:
            bundle = load_bundle(path)
        except ValueError as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            continue
        for src, snap in bundle["metrics"].items():
            summaries = summarize_stepscope(snap)
            if summaries:
                out[f"{bundle['peer']}/{src}"] = summaries
    return out


# -- rendering ----------------------------------------------------------------

def format_summary_table(title: str, summaries) -> str:
    """One aligned text table: a row per loop, columns for steps, wall,
    the derived fractions, and the top phases by share."""
    lines = [title]
    if not summaries:
        lines.append("  (no stepscope series)")
        return "\n".join(lines)
    header = (f"  {'loop':<18} {'steps':>8} {'wall_s':>10} "
              f"{'comms':>7} {'host':>7} {'env':>7}  phases")
    lines.append(header)
    for loop, s in sorted(summaries.items()):
        fr = s["fractions"]
        wall = s["wall_s"] if s["wall_s"] > 0.0 else 1e-9
        top = sorted(s["phases"].items(), key=lambda kv: -kv[1])[:4]
        phases = " ".join(f"{ph}={secs / wall:.0%}" for ph, secs in top)
        lines.append(
            f"  {loop:<18} {s['steps']:>8} {s['wall_s']:>10.3f} "
            f"{fr['exposed_comms']:>7.3f} {fr['host_blocked']:>7.3f} "
            f"{fr['env_wait']:>7.3f}  {phases}"
        )
        if "window" in s:
            win = s["window"]
            lines.append(
                "  " + " " * 18
                + f" window: comms={win.get('comms', 0.0):.3f} "
                f"host={win.get('host', 0.0):.3f} "
                f"env={win.get('env', 0.0):.3f} "
                f"attributed={win.get('attributed', 0.0):.3f} "
                f"overrun={win.get('ledger_overrun', 0.0):.3f}"
            )
    return "\n".join(lines)


def write_report(out: str, peer_summaries, merged) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump({"peers": peer_summaries, "merged": merged},
                  f, indent=2, sort_keys=True)
    with open(os.path.join(out, "trace.json"), "w") as f:
        json.dump(phase_trace(peer_summaries), f)
    print(f"wrote {out}/report.json, trace.json "
          f"({len(peer_summaries)} peer(s), {len(merged)} loop(s))")


# -- smoke --------------------------------------------------------------------

def check_ledger_closure(summaries, tolerance: float):
    """Assert every loop's cumulative phase ledger sums to its wall time
    within ``tolerance``. Returns the worst relative error seen."""
    worst = 0.0
    for loop, s in summaries.items():
        if s["steps"] == 0 or s["wall_s"] <= 0.0:
            continue
        err = abs(sum(s["phases"].values()) - s["wall_s"]) / s["wall_s"]
        worst = max(worst, err)
        assert err <= tolerance, (
            f"{loop}: phase ledger sums to "
            f"{sum(s['phases'].values()):.4f}s vs wall {s['wall_s']:.4f}s "
            f"({err:.1%} > {tolerance:.0%} tolerance)"
        )
    return worst


def smoke(args) -> int:
    """Self-test: short instrumented A2C cohort -> ledger-closure
    assertion -> report render -> detector-gated trend rows."""
    import tempfile

    from ..bench.trends import append_trend, detect_regressions, load_trends
    from ..examples.a2c import A2CConfig, train
    from ..telemetry import global_telemetry
    from ..telemetry.stepscope import trend_rows

    cfg = A2CConfig(total_steps=1500, log_interval_steps=500,
                    num_processes=2, batch_size=2, num_batches=2)
    train(cfg, log_fn=lambda s: None, device=args.device)

    summaries = summarize_stepscope(global_telemetry().snapshot())
    assert "a2c_learner" in summaries and "envpool" in summaries, (
        f"smoke loops missing from registry: {sorted(summaries)}"
    )
    assert summaries["a2c_learner"]["steps"] > 0
    worst = check_ledger_closure(summaries, args.tolerance)

    peer_summaries = {"smoke": summaries}
    merged = merge_summaries(peer_summaries)
    print(format_summary_table("stepscope smoke cohort:", merged))
    with tempfile.TemporaryDirectory() as out:
        write_report(out, peer_summaries, merged)
        # Re-load what we wrote: the render must round-trip as JSON.
        with open(os.path.join(out, "report.json")) as f:
            json.load(f)
        with open(os.path.join(out, "trace.json")) as f:
            trace = json.load(f)
        assert any(e.get("cat") == "stepscope"
                   for e in trace["traceEvents"]), "no phase tracks"

    rows = []
    for loop in ("a2c_learner", "envpool"):
        rows.extend(trend_rows(summaries[loop], smoke=True, cmd=SMOKE_CMD))
    os.makedirs(os.path.dirname(os.path.abspath(args.trends)),
                exist_ok=True)
    for row in rows:
        append_trend(args.trends, row)
    ran = {r.metric for r in rows}
    regressions = [
        r for r in detect_regressions(load_trends(args.trends))
        if r.metric in ran
    ]
    for r in regressions:
        print(f"REGRESSION {r.message()}", flush=True)
    print(f"STEPSCOPE SMOKE OK ({summaries['a2c_learner']['steps']} learner "
          f"steps, worst ledger closure {worst:.2%}, {len(rows)} trend "
          f"row(s) -> {os.path.relpath(args.trends, REPO)})"
          if not regressions else
          f"STEPSCOPE SMOKE: {len(regressions)} fraction regression(s)")
    return 1 if regressions else 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--connect", action="append",
                        help="address of any cohort peer (repeatable)")
    parser.add_argument("--peers",
                        help="comma-separated peer names to scrape "
                             "(default: every discovered peer)")
    parser.add_argument("--metrics",
                        help="metrics.json from telemetry_dump")
    parser.add_argument("--bundles",
                        help="directory of incident bundles to summarize")
    parser.add_argument("--out", default="stepscope_report",
                        help="output directory")
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="per-scrape RPC timeout (s)")
    parser.add_argument("--discover-seconds", type=float, default=2.0,
                        help="how long to wait for peer discovery")
    parser.add_argument("--smoke", action="store_true",
                        help="self-contained smoke (no cohort needed)")
    parser.add_argument("--trends",
                        default=os.path.join(REPO, "build", "perf",
                                             "trends.jsonl"),
                        help="trend store for --smoke fraction rows")
    parser.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                        help="--smoke ledger-closure tolerance (fraction)")
    parser.add_argument("--device", default=None,
                        help="--smoke's torch device (default: the card)")
    args = parser.parse_args(argv)

    if args.smoke:
        return smoke(args)
    sources = [bool(args.connect), bool(args.metrics), bool(args.bundles)]
    if sum(sources) != 1:
        parser.error("need exactly one of --connect, --metrics, --bundles")

    failed = []
    if args.connect:
        want = set(args.peers.split(",")) if args.peers else None
        peer_summaries, failed = collect_live(
            args.connect, want, args.timeout, args.discover_seconds)
    elif args.metrics:
        peer_summaries = collect_metrics_file(args.metrics)
    else:
        peer_summaries = collect_bundles(args.bundles)
    if not peer_summaries:
        print("error: no registry snapshots collected", file=sys.stderr)
        return 1

    merged = merge_summaries(peer_summaries)
    for peer in sorted(peer_summaries):
        print(format_summary_table(f"peer {peer}:", peer_summaries[peer]))
    print(format_summary_table("merged cohort:", merged))
    write_report(args.out, peer_summaries, merged)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
