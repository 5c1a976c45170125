"""Versioned on-disk incident bundles: freeze one process's story; the
counterpart of :mod:`moolib_tpu.flightrec.bundle`, with the same schema,
version and key sets.

A bundle is everything one process can say about itself at a moment of
interest, as strict JSON:

- the flight-recorder event ring with its eviction count,
- the trace-span ring (Chrome-trace-shaped span dicts) with *its*
  eviction count, so a truncated timeline is labeled,
- a metrics snapshot per source registry (the component's own and the
  process-global one, keyed by telemetry name),
- every thread's stack at capture time (``faulthandler``),
- a config/env fingerprint (python/platform/pid/argv + the ``MOOLIB``,
  ``TORCH``, ``PYTORCH``, ``CUDA`` and ``NCCL`` environment) so a bundle
  names the build that wrote it.

The format is versioned and *strictly* validated on load: unknown keys,
a wrong version, an unknown event kind, or mis-shaped spans are
rejected with ``ValueError``. ``write -> load`` round-trips to an
identical object.
"""

from __future__ import annotations

import faulthandler
import json
import os
import platform
import re
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

from .events import KINDS, check_event_fields

__all__ = [
    "BUNDLE_SCHEMA",
    "BUNDLE_VERSION",
    "snapshot_bundle",
    "validate_bundle",
    "write_bundle",
    "load_bundle",
    "shift_bundle_ts",
]

BUNDLE_SCHEMA = "flightrec-bundle"
BUNDLE_VERSION = 1

_TOP_KEYS = frozenset((
    "schema", "version", "peer", "captured_at_us", "trigger", "events",
    "spans", "events_dropped", "spans_dropped", "metrics", "stacks",
    "fingerprint",
))
_EVENT_KEYS = frozenset(("seq", "ts_us", "kind", "pid", "fields"))
_SPAN_KEYS = frozenset(
    ("name", "cat", "ph", "ts", "dur", "pid", "tid", "trace_id", "args")
)
_ENV_PREFIXES = ("MOOLIB", "TORCH", "PYTORCH", "CUDA", "NCCL")


def _thread_stacks() -> str:
    """Every thread's current stack, via faulthandler (it needs a real
    fd, so dump through a temp file)."""
    with tempfile.TemporaryFile() as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read().decode("utf-8", errors="replace")


def _fingerprint() -> Dict[str, Any]:
    return {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "env": {
            k: v for k, v in sorted(os.environ.items())
            if k.split("_")[0] in _ENV_PREFIXES
        },
    }


def _span_dicts(telemetry) -> List[Dict[str, Any]]:
    return [
        {"name": s.name, "cat": s.cat, "ph": s.ph, "ts": s.ts, "dur": s.dur,
         "pid": s.pid, "tid": s.tid, "trace_id": s.trace_id,
         "args": dict(s.args) if s.args else {}}
        for s in telemetry.traces.spans()
    ]


def snapshot_bundle(telemetry=None, trigger: str = "api", detail: str = "",
                    include_global: bool = True) -> Dict[str, Any]:
    """Freeze a bundle dict from live telemetry state.

    ``telemetry`` defaults to the process-global instance; with
    ``include_global`` (default) the global recorder/span/metric state is
    merged in alongside a peer-owned telemetry, so a per-Rpc bundle still
    carries the peer-less components (env pools, chaos plans, batchers).
    The result is JSON-clean by construction (sanitized through one
    dumps/loads pass, non-JSON leaves stringified) so ``write -> load``
    is identity.
    """
    from ..telemetry import global_telemetry

    tel = telemetry if telemetry is not None else global_telemetry()
    gt = global_telemetry()
    sources = [tel]
    if include_global and tel is not gt:
        sources.append(gt)
    events: List[Dict[str, Any]] = []
    spans: List[Dict[str, Any]] = []
    metrics: Dict[str, Any] = {}
    events_dropped = 0
    spans_dropped = 0
    for src in sources:
        events.extend(src.flight.events())
        spans.extend(_span_dicts(src))
        events_dropped += src.flight.dropped
        spans_dropped += src.traces.dropped
        metrics[src.name or "local"] = src.snapshot()
    events.sort(key=lambda e: (e["ts_us"], e["pid"], e["seq"]))
    spans.sort(key=lambda s: (s["ts"], s["pid"], s["name"]))
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "version": BUNDLE_VERSION,
        "peer": tel.name or "local",
        "captured_at_us": int(time.time() * 1e6),
        "trigger": {"kind": str(trigger), "detail": str(detail)},
        "events": events,
        "spans": spans,
        "events_dropped": events_dropped,
        "spans_dropped": spans_dropped,
        "metrics": metrics,
        "stacks": _thread_stacks(),
        "fingerprint": _fingerprint(),
    }
    # One sanitize pass: span args (and any future payload) may carry
    # non-JSON leaves; stringify them NOW so the written file, the wire
    # copy, and the validator all see the same object.
    return json.loads(json.dumps(bundle, default=str))


def shift_bundle_ts(bundle: Dict[str, Any], shift_us: int) -> Dict[str, Any]:
    """Return a copy with every wall-clock placement (events, spans,
    captured_at) shifted by ``shift_us`` — how a peer with a skewed
    clock would have written the same bundle. Backs the clock-alignment
    tests and the ``Rpc.set_flightrec_skew`` test hook."""
    out = json.loads(json.dumps(bundle))
    shift = int(shift_us)
    out["captured_at_us"] += shift
    for e in out["events"]:
        e["ts_us"] += shift
    for s in out["spans"]:
        s["ts"] += shift
    return out


def _fail(msg: str) -> None:
    raise ValueError(f"invalid flightrec bundle: {msg}")


def validate_bundle(bundle: Any) -> Dict[str, Any]:
    """Strict schema check; returns ``bundle`` or raises ``ValueError``.

    Exact top-level key set, pinned schema/version, typed events (kind
    and field names checked against :data:`~moolib_tpu_torch.flightrec.events.KINDS`),
    Chrome-shaped spans, per-source metrics snapshots."""
    if not isinstance(bundle, dict):
        _fail(f"expected an object, got {type(bundle).__name__}")
    keys = set(bundle)
    if keys != _TOP_KEYS:
        extra, missing = keys - _TOP_KEYS, _TOP_KEYS - keys
        _fail(f"top-level keys diverge (extra={sorted(extra)}, "
              f"missing={sorted(missing)})")
    if bundle["schema"] != BUNDLE_SCHEMA:
        _fail(f"schema {bundle['schema']!r} != {BUNDLE_SCHEMA!r}")
    if bundle["version"] != BUNDLE_VERSION:
        _fail(f"version {bundle['version']!r} != {BUNDLE_VERSION}")
    if not isinstance(bundle["peer"], str) or not bundle["peer"]:
        _fail("peer must be a non-empty string")
    if not isinstance(bundle["captured_at_us"], int):
        _fail("captured_at_us must be an int")
    trig = bundle["trigger"]
    if (not isinstance(trig, dict) or set(trig) != {"kind", "detail"}
            or not all(isinstance(v, str) for v in trig.values())):
        _fail("trigger must be {kind: str, detail: str}")
    for field in ("events_dropped", "spans_dropped"):
        if not isinstance(bundle[field], int) or bundle[field] < 0:
            _fail(f"{field} must be a non-negative int")
    for field in ("events", "spans"):
        if not isinstance(bundle[field], list):
            _fail(f"{field} must be a list, "
                  f"got {type(bundle[field]).__name__}")
    for i, e in enumerate(bundle["events"]):
        if not isinstance(e, dict) or set(e) != _EVENT_KEYS:
            _fail(f"event[{i}] keys must be exactly {sorted(_EVENT_KEYS)}")
        if not isinstance(e["ts_us"], int) or not isinstance(e["seq"], int):
            _fail(f"event[{i}] seq/ts_us must be ints")
        if e["kind"] not in KINDS:
            _fail(f"event[{i}] has unknown kind {e['kind']!r}")
        try:
            check_event_fields(e["kind"], e["fields"])
        except ValueError as err:
            _fail(f"event[{i}]: {err}")
    for i, s in enumerate(bundle["spans"]):
        if not isinstance(s, dict) or set(s) != _SPAN_KEYS:
            _fail(f"span[{i}] keys must be exactly {sorted(_SPAN_KEYS)}")
        if s["ph"] not in ("X", "i"):
            _fail(f"span[{i}] ph {s['ph']!r} not in ('X', 'i')")
        if not isinstance(s["ts"], int) or not isinstance(s["dur"], int):
            _fail(f"span[{i}] ts/dur must be ints")
    if not isinstance(bundle["metrics"], dict):
        _fail("metrics must be an object of per-source snapshots")
    for src, snap in bundle["metrics"].items():
        if not isinstance(snap, dict) or not all(
            isinstance(series, dict) and "type" in series
            for series in snap.values()
        ):
            _fail(f"metrics[{src!r}] is not a registry snapshot")
    if not isinstance(bundle["stacks"], str):
        _fail("stacks must be a string")
    fp = bundle["fingerprint"]
    if not isinstance(fp, dict) or not {"python", "pid", "env"} <= set(fp):
        _fail("fingerprint must carry at least python/pid/env")
    return bundle


_FNAME_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def bundle_filename(bundle: Dict[str, Any]) -> str:
    """Canonical on-disk name — peer names come off the wire, so they
    are sanitized and must never name a path outside the target dir."""
    peer = _FNAME_SAFE.sub("_", bundle["peer"]).lstrip(".") or "peer"
    return f"incident_{peer}_{bundle['captured_at_us']}.json"


def write_bundle(bundle: Dict[str, Any], out_dir: str) -> str:
    """Validate and write ``bundle`` under ``out_dir``; returns the path.
    Written atomically (tmp + rename) so a crash mid-capture can never
    leave a half bundle that poisons a later merge."""
    validate_bundle(bundle)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, bundle_filename(bundle))
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(bundle, f, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_bundle(path: str) -> Dict[str, Any]:
    """Read + strictly validate one bundle file."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"invalid flightrec bundle {path!r}: {e}")
    return validate_bundle(obj)
