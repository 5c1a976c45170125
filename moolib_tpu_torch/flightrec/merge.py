"""Cross-peer merge: clock alignment + one causally-ordered timeline; the
counterpart of :mod:`moolib_tpu.flightrec.merge`.

1. **Clock alignment** (:func:`estimate_offset`): the offset of a peer
   relative to this process is estimated NTP-style over its
   ``__flightrec`` ``op="time"`` endpoint: sample ``t0 -> server_time ->
   t1`` a few times, keep the minimum-RTT sample, and take ``offset =
   server_time - (t0 + t1) / 2``. ``rpc`` is a
   :class:`~moolib_tpu_torch.rpc.Rpc` (or anything with
   ``sync(peer, endpoint, **kwargs)``).
2. **Merge** (:func:`merge_bundles`): every event/span timestamp is
   mapped into the local clock (``ts - offset``) and the whole set is
   sorted into one sequence.
3. **Causal repair**: spans sharing a trace id are clamped — a
   ``handle X`` span never precedes its ``call X`` span — and the number
   of adjustments is reported.

The merged timeline exports as JSONL (one record per line, stable order)
and as Chrome-trace JSON.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.trace import Span, now_us, spans_to_chrome

__all__ = [
    "estimate_offset",
    "merge_bundles",
    "timeline_to_chrome",
    "write_timeline_jsonl",
]


def estimate_offset(rpc, peer: str, samples: int = 5) -> Tuple[int, int]:
    """Estimate ``peer``'s wall-clock offset relative to this process.

    Returns ``(offset_us, rtt_us)`` from the minimum-RTT sample:
    ``peer_time ~= local_time + offset_us``. Wall clocks on BOTH ends by
    design — the offset maps the peer's span/event placements (which are
    wall-clock, :func:`moolib_tpu_torch.telemetry.trace.now_us`) into the
    local frame; a monotonic clock has no shared zero to estimate."""
    if samples < 1:
        raise ValueError(f"need samples >= 1, got {samples!r}")
    best: Optional[Tuple[int, int]] = None
    for _ in range(samples):
        t0 = now_us()
        reply = rpc.sync(peer, "__flightrec", op="time")
        t1 = now_us()
        rtt = t1 - t0
        offset = int(reply["time_us"]) - (t0 + t1) // 2
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    return best


_TYPE_ORDER = {"event": 0, "span": 1, "instant": 2}


def merge_bundles(
    bundles: Dict[str, Dict[str, Any]],
    offsets: Optional[Dict[str, int]] = None,
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """Merge per-peer bundles into one aligned timeline.

    ``bundles`` maps peer name -> validated bundle; ``offsets`` maps
    peer name -> offset_us from :func:`estimate_offset` (missing peers
    align with offset 0 — the offline story for bundles pulled from
    shared disk). Returns ``(timeline, meta)``: the timeline is a list
    of records sorted by aligned timestamp —

    - ``{"type": "event", "ts_us", "peer", "src", "kind", "fields"}``
    - ``{"type": "span", "ts_us", "peer", "src", "name", "cat",
      "dur_us", "tid", "trace_id", "args"}``
    - ``{"type": "instant", ...}`` (trace instants, e.g. chaos marks)

    ``peer`` is the bundle's owner, ``src`` the recording track within
    it (a peer's bundle carries the process-global track too — two
    same-process peers therefore pull identical copies of the shared
    track, which are deduplicated here exactly, keyed on pre-alignment
    content, attributed to the alphabetically-first puller). ``meta``
    reports offsets used, per-peer drop counts, the dedup count, and the
    causal-repair count.
    """
    offsets = offsets or {}
    timeline: List[Dict[str, Any]] = []
    dropped: Dict[str, Dict[str, int]] = {}
    seen: set = set()
    deduped = 0
    for peer in sorted(bundles):
        bundle = bundles[peer]
        off = int(offsets.get(peer, 0))
        dropped[peer] = {
            "events_dropped": bundle["events_dropped"],
            "spans_dropped": bundle["spans_dropped"],
        }
        for e in bundle["events"]:
            key = ("e", e["pid"], e["seq"], e["ts_us"], e["kind"],
                   json.dumps(e["fields"], sort_keys=True))
            if key in seen:
                deduped += 1
                continue
            seen.add(key)
            timeline.append({
                "type": "event", "ts_us": e["ts_us"] - off, "peer": peer,
                "src": e["pid"], "kind": e["kind"], "fields": e["fields"],
            })
        for s in bundle["spans"]:
            key = ("s", s["pid"], s["ts"], s["dur"], s["name"], s["ph"],
                   s["tid"], s["trace_id"],
                   json.dumps(s["args"], sort_keys=True))
            if key in seen:
                deduped += 1
                continue
            seen.add(key)
            timeline.append({
                "type": "span" if s["ph"] == "X" else "instant",
                "ts_us": s["ts"] - off, "peer": peer, "src": s["pid"],
                "name": s["name"], "cat": s["cat"], "dur_us": s["dur"],
                "tid": s["tid"], "trace_id": s["trace_id"],
                "args": s["args"],
            })
    # Causal repair: within one trace id, the handler side provably
    # happened after the caller started — clamp residual-skew inversions.
    starts: Dict[str, int] = {}
    for rec in timeline:
        tid = rec.get("trace_id")
        if tid and rec["type"] == "span" and rec["name"].startswith("call "):
            starts[tid] = min(starts.get(tid, rec["ts_us"]), rec["ts_us"])
    adjusted = 0
    for rec in timeline:
        tid = rec.get("trace_id")
        if (tid and rec["type"] == "span"
                and rec["name"].startswith("handle ")
                and tid in starts and rec["ts_us"] < starts[tid]):
            rec["ts_us"] = starts[tid] + 1
            rec["causal_adjusted"] = True
            adjusted += 1
    timeline.sort(key=lambda r: (
        r["ts_us"], r["peer"], _TYPE_ORDER[r["type"]],
        r.get("kind") or r.get("name") or "",
    ))
    meta = {
        "peers": sorted(bundles),
        "offsets_us": {p: int(offsets.get(p, 0)) for p in sorted(bundles)},
        "dropped": dropped,
        "deduplicated": deduped,
        "causal_adjustments": adjusted,
        "records": len(timeline),
    }
    return timeline, meta


def timeline_to_chrome(timeline: List[Dict[str, Any]],
                       meta: Optional[Dict[str, Any]] = None,
                       ) -> Dict[str, Any]:
    """Render a merged timeline as Chrome-trace JSON. Tracks are named
    ``peer/src`` (one process track per recording source per peer);
    flightrec events become instants in the ``flightrec`` category;
    merge metadata (offsets, drop counts) rides in ``otherData`` so a
    truncated or realigned timeline is labeled in the viewer."""
    spans: List[Span] = []
    for rec in timeline:
        pid = (rec["peer"] if rec["src"] in ("", rec["peer"])
               else f"{rec['peer']}/{rec['src']}")
        if rec["type"] == "event":
            args = dict(rec["fields"])
            args["peer"] = rec["peer"]
            spans.append(Span(rec["kind"], "flightrec", "i", rec["ts_us"],
                              0, pid, 0, None, args))
        else:
            spans.append(Span(
                rec["name"], rec["cat"],
                "X" if rec["type"] == "span" else "i",
                rec["ts_us"], rec["dur_us"], pid, rec["tid"],
                rec["trace_id"], rec["args"],
            ))
    trace = spans_to_chrome(spans)
    if meta is not None:
        trace["otherData"] = dict(meta)
    return trace


def write_timeline_jsonl(timeline: List[Dict[str, Any]], path: str) -> None:
    """One record per line, in timeline order — greppable, diffable, and
    streamable (the JSONL twin of the Chrome export)."""
    with open(path, "w") as f:
        for rec in timeline:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
