"""Scrape a live cohort's ``__telemetry`` endpoints into one merged dump;
the twin of the reference's ``tools/telemetry_dump.py``.

Every :class:`~moolib_tpu_torch.rpc.Rpc` auto-defines ``__telemetry``,
so observability of a running cohort needs no code in the cohort itself:
this tool dials in as one more peer, scrapes every peer it can see, and
writes

- ``metrics.json`` — ``{peer_name: {series_id: series}}``, the JSON
  snapshot of each peer's registry (process-global metrics merged in by
  the serving peer);
- ``<peer>.prom`` — the Prometheus text exposition per peer (with
  ``--prometheus``), validated through the strict parser so a format
  regression fails the scrape loudly;
- ``trace.json`` — with ``--spans``, every peer's Chrome-trace export
  merged onto ONE timeline (load in Perfetto / chrome://tracing): RPC
  call/handle spans correlated by trace id across peers, chaosnet
  injection instants, and the ``torch.profiler`` capture windows
  (:mod:`moolib_tpu_torch.flightrec.capture`). Peers in one OS process
  each merge the process-global buffer into their export; identical
  events are deduplicated here so shared tracks appear once. Per-peer
  span-ring eviction counts are carried through into the merged
  export's ``otherData`` so a truncated timeline is labeled. Peers with
  ``stepscope_*`` series additionally get a ``stepscope <peer>``
  composition track — per-loop phase bars reconstructed from the
  metrics snapshot (where step time went; the span tracks carry when);
- ``bundles/incident_<peer>_<ts>.json`` — with ``--bundle``, each
  peer's ``__flightrec`` snapshot written in the incident-bundle format
  (the same versioned, strictly-validated schema
  :mod:`moolib_tpu_torch.tools.incident_report` pulls and merges).

Peers are discovered by crawling: every ``__telemetry`` reply advertises
the serving peer's dialable neighbours, so dialing into ONE cohort
member (or its broker) reaches the whole connected cohort. The crawl
itself is :func:`moolib_tpu_torch.flightrec.crawl_cohort` — the one
implementation this tool shares with ``incident_report`` and
``stepscope_report``. ``--peers`` pins the exact set to scrape instead.

Usage::

    python -m moolib_tpu_torch.tools.telemetry_dump --connect 127.0.0.1:4411 --out dump/
    python -m moolib_tpu_torch.tools.telemetry_dump --connect host:4411 \
        --peers a,b --spans --prometheus --bundle --out dump/
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys

from ..flightrec import crawl_cohort, validate_bundle, write_bundle
from ..rpc import Rpc
from ..telemetry import Telemetry, parse_prometheus, summarize_stepscope
from ..telemetry.stepscope import phase_trace


def merge_chrome_traces(traces: "list[tuple[str, dict]]") -> dict:
    """Merge per-peer Chrome-trace dicts onto one timeline.

    Tracks (Chrome ``pid`` ints) are re-keyed by their ``process_name``
    metadata so the same logical track scraped via two peers in one OS
    process lands on one merged track; non-metadata events are
    deduplicated exactly (two peers exporting the shared process-global
    buffer must not double every chaos instant). Per-peer span-ring
    eviction counts (``otherData.spans_dropped``) are aggregated so the
    merged export still labels truncation."""
    track_ids: "dict[str, int]" = {}
    events: "list[dict]" = []
    seen: "set[str]" = set()
    dropped: "dict[str, int]" = {}
    for peer, trace in traces:
        other = trace.get("otherData") or {}
        if "spans_dropped" in other:
            dropped[peer] = int(other["spans_dropped"])
        names = {
            ev["pid"]: ev["args"]["name"]
            for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "process_name"
        }
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue
            track = names.get(ev["pid"], f"pid{ev['pid']}")
            if track not in track_ids:
                track_ids[track] = len(track_ids) + 1
                events.append({
                    "name": "process_name", "ph": "M",
                    "pid": track_ids[track], "tid": 0,
                    "args": {"name": track},
                })
            out = dict(ev)
            out["pid"] = track_ids[track]
            key = json.dumps(out, sort_keys=True, default=str)
            if key in seen:
                continue
            seen.add(key)
            events.append(out)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"spans_dropped": dropped}}


def scrape(rpc: Rpc, peer: str, spans: bool, prometheus: bool,
           bundle: bool):
    """One peer's full scrape: (json snapshot, prom text or None, bundle
    or None). The per-scrape deadline is the scraper Rpc's call timeout
    (set_timeout)."""
    snap = rpc.sync(peer, "__telemetry", spans=spans)
    prom = None
    if prometheus:
        prom = rpc.sync(peer, "__telemetry", fmt="prometheus")
        parse_prometheus(prom)  # format regression -> loud failure
    bun = None
    if bundle:
        reply = rpc.sync(peer, "__flightrec", op="snapshot")
        bun = validate_bundle(reply["bundle"])
    return snap, prom, bun


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--connect", action="append", required=True,
                        help="address of any cohort peer (repeatable)")
    parser.add_argument("--peers",
                        help="comma-separated peer names to scrape "
                             "(default: every discovered peer)")
    parser.add_argument("--out", default="telemetry_dump",
                        help="output directory")
    parser.add_argument("--spans", action="store_true",
                        help="also scrape trace spans -> trace.json")
    parser.add_argument("--prometheus", action="store_true",
                        help="also write per-peer .prom text expositions")
    parser.add_argument("--bundle", action="store_true",
                        help="also pull each peer's __flightrec snapshot "
                             "and write it in the incident-bundle format "
                             "(bundles/incident_<peer>_<ts>.json)")
    parser.add_argument("--timeout", type=float, default=10.0,
                        help="per-scrape RPC timeout (s)")
    parser.add_argument("--discover-seconds", type=float, default=2.0,
                        help="how long to wait for peer discovery")
    args = parser.parse_args(argv)

    # The scraper is one more peer on the plane; its own telemetry is off
    # so the dump doesn't include the act of dumping.
    rpc = Rpc("telemetry-dump", telemetry=Telemetry("dump", enabled=False))
    rpc.set_timeout(args.timeout)
    try:
        want = set(args.peers.split(",")) if args.peers else None
        os.makedirs(args.out, exist_ok=True)
        prom_files: "set[str]" = set()

        def scrape_one(peer):
            result = scrape(rpc, peer, args.spans, args.prometheus,
                            args.bundle)
            snap = result[0]
            return result, snap.get("peers", [])

        def progress(peer, result):
            snap, prom, bun = result
            if prom is not None:
                # Peer names come off the wire (crawled from remote
                # replies) — never let one name a path outside --out, and
                # never let two distinct names ("a:b" vs "a_b") silently
                # share one file.
                safe = re.sub(r"[^A-Za-z0-9._-]", "_", peer).lstrip(".")
                safe = safe or "peer"
                if safe in prom_files:
                    digest = hashlib.sha1(peer.encode()).hexdigest()[:8]
                    safe = f"{safe}-{digest}"
                prom_files.add(safe)
                with open(os.path.join(args.out, f"{safe}.prom"), "w") as f:
                    f.write(prom)
            print(f"ok   {peer}: {len(snap['metrics'])} series"
                  + (f", {sum(1 for e in snap['trace']['traceEvents'] if e.get('ph') != 'M')} spans"
                     if args.spans and "trace" in snap else "")
                  + (f", bundle ({len(bun['events'])} events)"
                     if bun is not None else ""))

        results, failed = crawl_cohort(
            rpc, args.connect, scrape_one, want=want,
            discover_seconds=args.discover_seconds, on_result=progress,
        )
        for peer, err in failed:
            # A dark peer is a finding, not a reason to lose everyone
            # else's data — the crawl already continued past it.
            print(f"FAIL {peer}: {err}", file=sys.stderr)
        if not results and not failed:
            print(f"error: no peers discovered via {args.connect}",
                  file=sys.stderr)
            return 1

        metrics = {peer: snap["metrics"]
                   for peer, (snap, _p, _b) in results.items()}
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2, sort_keys=True)
        if args.spans:
            traces = [(peer, snap["trace"])
                      for peer, (snap, _p, _b) in results.items()
                      if "trace" in snap]
            merged = merge_chrome_traces(traces)
            # Step-phase composition tracks ride the same merged file:
            # per-loop phase bars reconstructed from each peer's
            # stepscope series (pids offset past the span tracks).
            stepscope = {
                peer: s for peer, s in (
                    (p, summarize_stepscope(m)) for p, m in metrics.items()
                ) if s
            }
            if stepscope:
                pid_base = max(
                    (e["pid"] for e in merged["traceEvents"]), default=0
                )
                comp = phase_trace(stepscope, pid_base=pid_base)
                merged["traceEvents"].extend(comp["traceEvents"])
            with open(os.path.join(args.out, "trace.json"), "w") as f:
                json.dump(merged, f)
            n = sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
            print(f"wrote {args.out}/trace.json ({n} merged events)")
        if args.bundle:
            bundle_dir = os.path.join(args.out, "bundles")
            for peer, (_s, _p, bun) in results.items():
                if bun is not None:
                    write_bundle(bun, bundle_dir)
            print(f"wrote {bundle_dir}/ "
                  f"({sum(1 for r in results.values() if r[2] is not None)} "
                  "incident bundles)")
        print(f"wrote {args.out}/metrics.json "
              f"({len(metrics)}/{len(results) + len(failed)} peers)")
        return 1 if failed or not metrics else 0
    finally:
        rpc.close()


if __name__ == "__main__":
    sys.exit(main())
