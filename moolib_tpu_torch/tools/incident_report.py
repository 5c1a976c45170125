"""Crawl a live (or dying) cohort's ``__flightrec`` endpoints into one
clock-aligned, causally-ordered incident timeline; the twin of the
reference's ``tools/incident_report.py``.

Every :class:`~moolib_tpu_torch.rpc.Rpc` auto-defines ``__flightrec``,
so forensics on a running cohort needs no code in the cohort itself:
this tool dials in as one more peer, crawls every peer it can reach from
one address (the same crawl as
:mod:`moolib_tpu_torch.tools.telemetry_dump` —
:func:`moolib_tpu_torch.flightrec.crawl_cohort`), pulls each peer's
frozen bundle, estimates each peer's wall-clock offset NTP-style over
the ``op="time"`` sample (min-RTT of several pings), and writes:

- ``bundles/incident_<peer>_<ts>.json`` — every pulled bundle,
  validated against the strict schema (a peer running a different
  bundle version fails loudly, it does not silently pollute the merge);
- ``timeline.jsonl`` — ONE merged timeline: injected chaos faults, typed
  state-transition events (conn lifecycle, epochs, elections, round
  commits/rejects, breaker/drain/shed, worker supervision), and RPC
  call/handle spans from every peer, clock-aligned and causally ordered
  (a ``handle`` span never precedes its ``call`` span);
- ``trace.json`` — the same timeline as Chrome-trace JSON (load in
  Perfetto; merge metadata — offsets, ring-drop counts, causal
  adjustments — rides in ``otherData``);
- ``report.json`` — peers reached/failed, per-peer offsets and RTTs,
  record counts, any on-disk bundles the peers had already captured,
  and per-peer step-phase attribution (``stepscope``): each bundle's
  frozen ``metrics`` snapshot reconstructed into per-loop phase
  summaries with the derived ``exposed_comms`` / ``host_blocked`` /
  ``env_wait`` fractions, plus a deduplicated cohort-wide merge.

``--bundles DIR`` merges already-written bundle files instead of
crawling (the dead-cohort story: bundles pulled from shared disk); no
live clock samples exist there, so offsets are zero unless the optional
``offsets.json`` (peer -> offset_us) sits next to them. ``--capture``
additionally asks every crawled peer to freeze a bundle to ITS OWN disk
(``op="capture"``).

``--smoke`` is the self-test: an in-process cohort under a seeded
FaultPlan, deliberately driven through faults, crawled via a real
``--connect``, every bundle schema-validated, and the merged timeline
asserted non-empty with injected faults + state transitions + cross-peer
spans in causal order.

Usage::

    python -m moolib_tpu_torch.tools.incident_report --connect 127.0.0.1:4411 --out rep/
    python -m moolib_tpu_torch.tools.incident_report --bundles incidents/ --out rep/
    python -m moolib_tpu_torch.tools.incident_report --smoke
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..flightrec import (
    crawl_cohort,
    estimate_offset,
    load_bundle,
    merge_bundles,
    timeline_to_chrome,
    validate_bundle,
    write_bundle,
    write_timeline_jsonl,
)
from ..rpc import Rpc
from ..telemetry import Telemetry, summarize_stepscope
from ..telemetry.stepscope import merge_summaries


def collect_live(rpc: Rpc, connect, want, discover_seconds: float,
                 capture: bool):
    """Crawl ``__flightrec`` across the cohort. Returns
    ``(bundles, offsets, rtts, captured, failed)``."""
    offsets: "dict[str, int]" = {}
    rtts: "dict[str, int]" = {}
    captured: "dict[str, list]" = {}

    def scrape(peer):
        # Offset first: the time samples are minimal round-trips, best
        # taken before the (potentially large) snapshot pull warms
        # nothing and queues behind nothing.
        offsets[peer], rtts[peer] = estimate_offset(rpc, peer)
        snap = rpc.sync(peer, "__flightrec", op="snapshot")
        bundle = validate_bundle(snap["bundle"])
        captured[peer] = list(snap.get("captured", []))
        if capture:
            reply = rpc.sync(peer, "__flightrec", op="capture",
                             trigger="api", detail="incident_report --capture")
            captured[peer].append({"path": reply["path"], "trigger": "api",
                                   "detail": "incident_report --capture",
                                   "captured_at_us": None})
        return bundle, snap.get("peers", [])

    def progress(peer, bundle):
        print(f"ok   {peer}: {len(bundle['events'])} events, "
              f"{len(bundle['spans'])} spans, "
              f"offset {offsets[peer]}us (rtt {rtts[peer]}us)")

    bundles, failed = crawl_cohort(
        rpc, connect, scrape, want=want,
        discover_seconds=discover_seconds, on_result=progress,
    )
    for peer, err in failed:
        print(f"FAIL {peer}: {err}", file=sys.stderr)
    return bundles, offsets, rtts, captured, failed


def collect_offline(bundles_dir: str):
    """Load every ``*.json`` bundle under ``bundles_dir`` (strictly
    validated; an ``offsets.json`` beside them supplies offsets)."""
    bundles: "dict[str, dict]" = {}
    failed: "list[tuple[str, str]]" = []
    for path in sorted(glob.glob(os.path.join(bundles_dir, "*.json"))):
        if os.path.basename(path) == "offsets.json":
            continue
        try:
            b = load_bundle(path)
        except ValueError as e:
            print(f"FAIL {path}: {e}", file=sys.stderr)
            failed.append((path, str(e)))
            continue
        peer = b["peer"]
        if peer in bundles:
            # Two captures from one peer: keep the newest (the freshest
            # ring), note the older one as skipped.
            if b["captured_at_us"] <= bundles[peer]["captured_at_us"]:
                continue
        bundles[peer] = b
    offsets: "dict[str, int]" = {}
    off_path = os.path.join(bundles_dir, "offsets.json")
    if os.path.exists(off_path):
        with open(off_path) as f:
            offsets = {k: int(v) for k, v in json.load(f).items()}
    return bundles, offsets, failed


def write_report(out: str, bundles, offsets, rtts, captured, failed):
    os.makedirs(out, exist_ok=True)
    bundle_dir = os.path.join(out, "bundles")
    bundle_paths = {
        peer: write_bundle(b, bundle_dir) for peer, b in bundles.items()
    }
    timeline, meta = merge_bundles(bundles, offsets)
    write_timeline_jsonl(timeline, os.path.join(out, "timeline.jsonl"))
    with open(os.path.join(out, "trace.json"), "w") as f:
        json.dump(timeline_to_chrome(timeline, meta), f)
    # Step-phase attribution survives the peer: each bundle's frozen
    # metrics snapshot (one registry per telemetry source — the peer's
    # own plus the merged process-global one) reconstructs into per-loop
    # phase summaries, keyed <peer>/<source> so attribution stays
    # traceable to the registry that recorded it.
    stepscope = {}
    for peer, b in bundles.items():
        for src, snap in b["metrics"].items():
            summaries = summarize_stepscope(snap)
            if summaries:
                stepscope[f"{peer}/{src}"] = summaries
    report = {
        "peers": sorted(bundles),
        "failed": [{"peer": p, "error": e} for p, e in failed],
        "offsets_us": meta["offsets_us"],
        "rtts_us": rtts,
        "dropped": meta["dropped"],
        "causal_adjustments": meta["causal_adjustments"],
        "records": meta["records"],
        "events": sum(1 for r in timeline if r["type"] == "event"),
        "spans": sum(1 for r in timeline if r["type"] == "span"),
        "bundles": bundle_paths,
        "peer_captured": captured,
        "stepscope": stepscope,
        "stepscope_merged": merge_summaries(stepscope),
    }
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"wrote {out}/timeline.jsonl ({meta['records']} records), "
          f"trace.json, report.json, {len(bundle_paths)} bundle(s)")
    return report


def smoke() -> int:
    """Self-contained smoke: seeded faults -> crawl -> validated bundles
    -> non-empty causally-ordered merged timeline."""
    import tempfile

    from ..testing.chaos import ChaosNet, FaultPlan
    from ..telemetry import StepScope

    a = Rpc("smoke-a")
    b = Rpc("smoke-b")
    for r in (a, b):
        r.telemetry.set_tracing(True)
        r.set_timeout(5.0)
    b.define("echo", lambda x: x)
    # A phase scope on one peer: the pulled bundles must carry enough to
    # reconstruct step-phase attribution in report.json.
    scope = StepScope("smoke_loop", telemetry=a.telemetry)
    for _ in range(8):
        scope.observe_step(0.01, {"fwd_bwd": 0.007, "wire_wait": 0.002})
    # Both peers listen: only peers with a dialable address are
    # advertised to the crawler (connect-only lurkers are unreachable).
    a.listen("127.0.0.1:0")
    b.listen("127.0.0.1:0")
    a.connect(b.debug_info()["listen"][0])
    plan = FaultPlan(seed=7).drop("echo", count=2).delay(
        "echo", 0.01, count=3
    )
    try:
        with ChaosNet(plan, [a, b]) as net:
            for i in range(20):
                assert a.sync("smoke-b", "echo", i) == i
            net.kill_conns(a, "smoke-b")
            for i in range(5):
                assert a.sync("smoke-b", "echo", i) == i
        scraper = Rpc("smoke-scraper",
                      telemetry=Telemetry("scraper", enabled=False))
        scraper.set_timeout(10.0)
        try:
            with tempfile.TemporaryDirectory() as out:
                bundles, offsets, rtts, captured, failed = collect_live(
                    scraper, [a.debug_info()["listen"][0]],
                    want=None, discover_seconds=5.0, capture=False,
                )
                assert not failed, f"smoke crawl failures: {failed}"
                assert set(bundles) == {"smoke-a", "smoke-b"}, (
                    f"expected both peers, got {sorted(bundles)}"
                )
                report = write_report(out, bundles, offsets, rtts,
                                      captured, failed)
                ss = [s for s in report["stepscope"].values()
                      if "smoke_loop" in s]
                assert ss and ss[0]["smoke_loop"]["steps"] == 8, (
                    f"stepscope attribution missing: {report['stepscope']}"
                )
                merged_ss = report["stepscope_merged"]["smoke_loop"]
                assert merged_ss["fractions"]["exposed_comms"] > 0.1, merged_ss
                # Re-load what we wrote: the strict parser must accept it.
                for path in report["bundles"].values():
                    load_bundle(path)
                with open(os.path.join(out, "timeline.jsonl")) as f:
                    timeline = [json.loads(line) for line in f]
        finally:
            scraper.close()
    finally:
        scope.close()
        a.close()
        b.close()
    assert timeline, "merged timeline is empty"
    kinds = {r["kind"] for r in timeline if r["type"] == "event"}
    assert "chaos" in kinds, f"no injected-fault events on timeline: {kinds}"
    assert "conn_down" in kinds and "conn_up" in kinds, (
        f"conn lifecycle missing from timeline: {kinds}"
    )
    # Cross-peer spans in causal order: every call/handle pair sharing a
    # trace id has the caller first.
    calls = {r["trace_id"]: r["ts_us"] for r in timeline
             if r["type"] == "span" and r["name"].startswith("call ")}
    handles = [(r["trace_id"], r["ts_us"]) for r in timeline
               if r["type"] == "span" and r["name"].startswith("handle ")]
    shared = [h for h in handles if h[0] in calls]
    assert shared, "no cross-peer call/handle span pairs on the timeline"
    for tid, ts in shared:
        assert ts >= calls[tid], (
            f"handle span precedes its call span for trace {tid}"
        )
    ordered = [r["ts_us"] for r in timeline]
    assert ordered == sorted(ordered), "timeline is not time-ordered"
    print(f"INCIDENT SMOKE OK ({len(timeline)} records, "
          f"{len(shared)} causal span pairs, kinds={sorted(kinds)})")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--connect", action="append",
                        help="address of any cohort peer (repeatable)")
    parser.add_argument("--peers",
                        help="comma-separated peer names to pull "
                             "(default: crawl every discovered peer)")
    parser.add_argument("--bundles",
                        help="merge already-written bundle files from this "
                             "directory instead of crawling a live cohort")
    parser.add_argument("--out", default="incident_report",
                        help="output directory")
    parser.add_argument("--capture", action="store_true",
                        help="also ask every crawled peer to write a bundle "
                             "to its own disk (op=capture)")
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="per-scrape RPC timeout (s)")
    parser.add_argument("--discover-seconds", type=float, default=2.0,
                        help="how long to wait for peer discovery")
    parser.add_argument("--smoke", action="store_true",
                        help="self-contained smoke (no cohort needed)")
    args = parser.parse_args(argv)

    if args.smoke:
        return smoke()
    if bool(args.connect) == bool(args.bundles):
        parser.error("need exactly one of --connect or --bundles")

    if args.bundles:
        bundles, offsets, failed = collect_offline(args.bundles)
        rtts, captured = {}, {}
    else:
        # The reporter is one more peer on the plane; its own telemetry
        # is off so the evidence does not include the act of collecting.
        rpc = Rpc("incident-report",
                  telemetry=Telemetry("report", enabled=False))
        rpc.set_timeout(args.timeout)
        try:
            want = set(args.peers.split(",")) if args.peers else None
            bundles, offsets, rtts, captured, failed = collect_live(
                rpc, args.connect, want, args.discover_seconds,
                args.capture,
            )
        finally:
            rpc.close()
    if not bundles:
        print("error: no bundles collected", file=sys.stderr)
        return 1
    write_report(args.out, bundles, offsets, rtts, captured, failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
