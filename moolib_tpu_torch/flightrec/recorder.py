"""The black-box flight recorder: a bounded ring of typed state events;
the counterpart of :mod:`moolib_tpu.flightrec.recorder`.

Always on by default (the evidence must exist *before* anyone knows it
will be needed), disabled with ``MOOLIB_TPU_FLIGHTREC=0`` or
:meth:`FlightRecorder.set_enabled`. Instrument seams read
``recorder.on`` and branch, so the disabled cost per seam is one
attribute load; the enabled cost is near zero in steady state because
every recorded kind is a *state transition* or a periodic stamp, not a
per-message path.

Events are typed against :data:`~moolib_tpu_torch.flightrec.events.KINDS`
at record time. Timestamps are wall-clock microseconds, the clock of
:mod:`~moolib_tpu_torch.telemetry.trace`'s spans, so a merged timeline
places events and spans on one axis.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .events import check_event_fields

__all__ = ["FlightRecorder"]


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off", "")


class FlightRecorder:
    """Lock-cheap bounded ring of typed, timestamped state transitions.

    One per :class:`~moolib_tpu_torch.telemetry.Telemetry` (so one per
    peer, plus the process-global one for peer-less components), reached
    as ``telemetry.flight`` at every seam that already has telemetry
    plumbed. Oldest events are evicted first; evictions are counted in
    :attr:`dropped` so a truncated ring is labeled in the bundle, never
    silently misleading.
    """

    def __init__(self, name: str = "", capacity: int = 4096,
                 enabled: Optional[bool] = None):
        self.name = name
        self.on = (
            _env_flag("MOOLIB_TPU_FLIGHTREC", True)
            if enabled is None else bool(enabled)
        )
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._events: deque = deque(maxlen=self._capacity)
        self._seq = 0
        self._dropped = 0

    def set_enabled(self, on: bool = True) -> None:
        self.on = bool(on)

    def record(self, kind: str, ts_us: Optional[int] = None, /,
               **fields: Any) -> None:
        """Record one typed event. Validates (kind, fields) against the
        schema; tuple field values are coerced to lists so the event is
        JSON-clean by construction (bundle round-trips are identical)."""
        check_event_fields(kind, fields)
        clean = {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in fields.items()
        }
        if ts_us is None:
            ts_us = int(time.time() * 1e6)
        with self._lock:
            if len(self._events) == self._capacity:
                self._dropped += 1
            self._events.append(
                {"seq": self._seq, "ts_us": int(ts_us), "kind": kind,
                 "pid": self.name, "fields": clean}
            )
            self._seq += 1

    # -- views ---------------------------------------------------------------

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first (entries are copied — the
        bundle writer may mutate timestamps for clock-skew tests)."""
        with self._lock:
            return [dict(e, fields=dict(e["fields"])) for e in self._events]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
