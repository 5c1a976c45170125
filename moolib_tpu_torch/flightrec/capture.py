"""Incident capture: trigger taxonomy, rate limiting, auto-capture; the
counterpart of :mod:`moolib_tpu.flightrec.capture`.

An *incident* is a moment the black box should freeze: the recorder ring
is cheap and always on, but a bundle (:mod:`~moolib_tpu_torch.flightrec.
bundle`) is written only when a trigger fires. The reference's trigger
kinds: ``scenario_failure`` (a chaos scenario broke an invariant),
``round_failure_storm`` (consecutive failed Accumulator rounds),
``breaker_open`` (a serving circuit breaker opened),
``worker_budget_exhausted`` (an EnvPool worker slot spent its restart
budget) and ``api`` (an explicit :func:`capture_incident`).

Auto-capture (every trigger except the explicit API) is **off** unless a
destination is configured — set ``MOOLIB_TPU_INCIDENT_DIR`` or call
:func:`enable_auto_capture` — so tests do not litter the tree with
bundles. Auto triggers are rate-limited per trigger kind, and
:func:`maybe_capture` *never raises into the host path*: a failed
capture is logged and dropped.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
import time
from typing import Any, Dict, List, Optional

from .bundle import snapshot_bundle, write_bundle
from ..utils.logging import get_logger

log = get_logger("flightrec")

__all__ = [
    "capture_incident",
    "maybe_capture",
    "enable_auto_capture",
    "disable_auto_capture",
    "auto_capture_dir",
    "recent_captures",
]

_lock = threading.Lock()
_auto_dir: Optional[str] = None
_last_auto: Dict[str, float] = {}  # trigger kind -> monotonic stamp
_recent: List[Dict[str, Any]] = []
_RECENT_CAP = 64
#: Minimum seconds between two auto-captures of the SAME trigger kind.
AUTO_CAPTURE_INTERVAL_S = 30.0


def enable_auto_capture(out_dir: str) -> None:
    """Turn trigger-driven capture on, writing bundles under ``out_dir``
    (overrides ``MOOLIB_TPU_INCIDENT_DIR`` for this process)."""
    global _auto_dir
    with _lock:
        _auto_dir = str(out_dir)


def disable_auto_capture() -> None:
    global _auto_dir
    with _lock:
        _auto_dir = None
        _last_auto.clear()


def auto_capture_dir() -> Optional[str]:
    """The active auto-capture destination, or None when auto-capture is
    off. ``enable_auto_capture`` wins over ``MOOLIB_TPU_INCIDENT_DIR``."""
    with _lock:
        if _auto_dir is not None:
            return _auto_dir
    return os.environ.get("MOOLIB_TPU_INCIDENT_DIR") or None


def recent_captures() -> List[Dict[str, Any]]:
    """This process's captured bundles, newest last: ``{path, trigger,
    detail, captured_at_us}`` records — advertised on the ``__flightrec``
    endpoint so a crawler can find on-disk evidence too."""
    with _lock:
        return [dict(r) for r in _recent]


def capture_incident(trigger: str, detail: str = "", telemetry=None,
                     out_dir: Optional[str] = None) -> str:
    """Freeze a bundle NOW and write it to disk; returns the path.

    The trigger is recorded as an ``incident`` event *first*, so the
    bundle (and any later cross-peer merge) shows the trigger on the
    timeline itself. ``out_dir`` defaults to the auto-capture dir, then
    ``incidents/``.
    """
    from ..telemetry import global_telemetry

    tel = telemetry if telemetry is not None else global_telemetry()
    fr = tel.flight
    if fr.on:
        fr.record("incident", trigger=str(trigger), detail=str(detail))
    if out_dir is None:
        out_dir = auto_capture_dir() or "incidents"
    bundle = snapshot_bundle(tel, trigger=trigger, detail=detail)
    path = write_bundle(bundle, out_dir)
    tel.registry.counter(
        "flightrec_incidents_total", trigger=str(trigger)
    ).inc()
    with _lock:
        _recent.append({
            "path": path, "trigger": str(trigger), "detail": str(detail),
            "captured_at_us": bundle["captured_at_us"],
        })
        del _recent[:-_RECENT_CAP]
    log.warning("incident bundle captured (%s): %s", trigger, path)
    return path


def maybe_capture(trigger: str, detail: str = "", telemetry=None) -> (
        Optional[str]):
    """Auto-capture path for in-stack triggers: no-op unless auto-capture
    is configured, rate-limited per trigger kind, and guaranteed never to
    raise into the calling seam (cancellation excepted). Returns the
    bundle path, or None when skipped/failed."""
    out_dir = auto_capture_dir()
    if out_dir is None:
        return None
    now = time.monotonic()
    with _lock:
        last = _last_auto.get(trigger)
        if last is not None and now - last < AUTO_CAPTURE_INTERVAL_S:
            return None
        _last_auto[trigger] = now
    try:
        return capture_incident(trigger, detail, telemetry=telemetry,
                                out_dir=out_dir)
    except (asyncio.CancelledError, concurrent.futures.CancelledError):
        raise  # never swallow task cancellation
    except Exception as e:
        log.error("incident auto-capture (%s) failed: %s", trigger, e)
        return None
