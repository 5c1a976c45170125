"""Trace spans: a bounded buffer exportable as Chrome-trace/Perfetto JSON;
the counterpart of :mod:`moolib_tpu.telemetry.trace`.

Spans from several peers (RPC call/handle spans sharing a **trace id**,
injected-fault instants, step-phase attribution tracks) merge into one
timeline. Span timestamps are wall-clock microseconds (``time.time()``),
the one clock different hosts share well enough to merge, and the same
clock as the reference's, so spans of the two packages merge too;
durations are measured with the monotonic clock, so a span's extent is
immune to wall-clock steps even though its placement is not.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Span", "TraceBuffer", "now_us"]


def now_us() -> int:
    """Wall-clock microseconds — the shared axis of the merged timeline."""
    return int(time.time() * 1e6)


class Span:
    """One trace event (Chrome-trace ``X`` complete or ``i`` instant)."""

    __slots__ = ("name", "cat", "ph", "ts", "dur", "pid", "tid",
                 "trace_id", "args")

    def __init__(self, name: str, cat: str, ph: str, ts: int, dur: int,
                 pid: str, tid: int, trace_id: Optional[str],
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.pid = pid
        self.tid = tid
        self.trace_id = trace_id
        self.args = args

    def to_event(self, pid_map: Dict[str, int]) -> Dict[str, Any]:
        args = dict(self.args) if self.args else {}
        if self.trace_id is not None:
            args["trace_id"] = self.trace_id
        ev: Dict[str, Any] = {
            "name": self.name,
            "cat": self.cat,
            "ph": self.ph,
            "ts": self.ts,
            "pid": pid_map[self.pid],
            "tid": self.tid,
            "args": args,
        }
        if self.ph == "X":
            ev["dur"] = self.dur
        else:
            ev["s"] = "p"  # instant scope: process
        return ev


class TraceBuffer:
    """Bounded span ring (oldest spans evicted first).

    Recording is append-under-lock; owners gate recording on their
    ``Telemetry.tracing`` flag, so an idle buffer costs nothing.
    Evictions are **counted**: :attr:`dropped` and the
    ``trace_spans_dropped_total`` counter (``drop_counter``, wired by
    :class:`~moolib_tpu_torch.telemetry.Telemetry`) record how many spans a
    full ring discarded, and the count rides the Chrome-trace export
    metadata — a truncated timeline is labeled, never misleading.
    """

    def __init__(self, capacity: int = 65536, drop_counter=None):
        self._lock = threading.Lock()
        self._capacity = int(capacity)
        self._spans: deque = deque(maxlen=self._capacity)
        self._dropped = 0
        self._drop_counter = drop_counter  # anything with .inc(), or None

    def _append(self, span: Span) -> None:
        dc = None
        with self._lock:
            if len(self._spans) == self._capacity:
                self._dropped += 1
                dc = self._drop_counter
            self._spans.append(span)
        if dc is not None:
            dc.inc()  # the counter has its own lock; keep ours a leaf

    def add_span(self, name: str, cat: str, pid: str, ts_us: int,
                 dur_us: int, trace_id: Optional[str] = None,
                 tid: int = 0, args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete (``ph=X``) span."""
        self._append(Span(name, cat, "X", int(ts_us), max(0, int(dur_us)),
                          pid, tid, trace_id, args))

    def add_instant(self, name: str, cat: str, pid: str,
                    ts_us: Optional[int] = None,
                    trace_id: Optional[str] = None,
                    args: Optional[Dict[str, Any]] = None) -> None:
        """Record an instant (``ph=i``) event — chaos injections etc."""
        self._append(
            Span(name, cat, "i", now_us() if ts_us is None else int(ts_us),
                 0, pid, 0, trace_id, args)
        )

    @property
    def dropped(self) -> int:
        """Spans evicted by ring overflow since construction/clear."""
        with self._lock:
            return self._dropped

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def __len__(self) -> int:
        return len(self._spans)

    def chrome_trace(self) -> Dict[str, Any]:
        """Export as a Chrome-trace JSON object (load in Perfetto /
        chrome://tracing). ``pid`` strings (peer names) are mapped to
        stable small ints with ``process_name`` metadata events so every
        peer renders as its own named process track. Eviction counts ride
        in ``otherData`` so a truncated export is labeled."""
        spans = sorted(self.spans(), key=lambda s: (s.ts, s.pid, s.name))
        return spans_to_chrome(spans, dropped=self.dropped)


def spans_to_chrome(spans: List[Span],
                    dropped: Optional[int] = None) -> Dict[str, Any]:
    """Shared Chrome-trace assembly for one buffer or a cross-peer merge
    (concatenate the peers' span lists first).
    ``dropped`` (when given) labels the export with the span-ring
    eviction count in ``otherData`` — a truncated timeline must say so."""
    pid_map: Dict[str, int] = {}
    for s in spans:
        if s.pid not in pid_map:
            pid_map[s.pid] = len(pid_map) + 1
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": name},
        }
        for name, pid in sorted(pid_map.items(), key=lambda kv: kv[1])
    ]
    events.extend(s.to_event(pid_map) for s in spans)
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped is not None:
        trace["otherData"] = {"spans_dropped": int(dropped)}
    return trace
