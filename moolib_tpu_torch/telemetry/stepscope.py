"""stepscope — step-phase attribution for the hot loops; the counterpart
of :mod:`moolib_tpu.telemetry.stepscope`.

Where does a step's wall time go? Every hot loop (learner step, serving
replica cycle, and in the reference the accumulator gradient round and
the envpool batch) answers with a *phase ledger*: a per-step mapping
``phase -> seconds`` that sums to the measured step wall time.
Unattributed time lands in the reserved ``other`` phase so the ledger
always closes; double-counted time (overlapping ``note`` additions)
surfaces as the ``ledger_overrun_fraction`` gauge instead of silently
corrupting the attributed fractions.

On top of the ledgers a small critical-path analyzer derives three
fractions, each over a sliding window of recent steps (time-weighted:
window phase seconds / window wall seconds):

- ``stepscope_exposed_comms_fraction`` — time the host spent *blocked*
  on collective results (``grad_allreduce`` + ``wire_wait`` phases).
- ``stepscope_host_blocked_fraction`` — host/device serialization
  (``host_sync`` + ``staging`` + ``local_reduce`` + ``checkpoint``).
- ``stepscope_env_wait_fraction`` — input starvation (``env_wait`` +
  ``batch_fill``; for serving loops ``queue_wait`` + ``linger``).

Usage, single-owner-thread loop (the common case)::

    scope = StepScope("impala_learner")
    while training:
        with scope.step():
            with scope.phase("staging"):
                batch = stage_batch(host_batch, "cuda")
            state, metrics = train_step(state, batch)  # stepscope=scope
            with scope.phase("host_sync"):
                loss = float(metrics["total_loss"])

On the card, a phase around launches measures their dispatch; the
device time surfaces in whichever phase first reads a result back
(``host_sync`` above).

``phase`` context managers nest: a child's time is attributed to the
child only (self-time semantics), so wrapping a whole region and then a
sub-region inside it never double-counts. Producers whose steps overlap
in time or complete on another thread (the serving replica's worker)
use the thread-safe low-level API instead::

    scope.observe_step(wall_s, {"queue_wait": w, "infer": s}, ts_us=t0)

Cost discipline: the context managers are gated on a single attribute
snapshot taken at ``step()`` entry (so a mid-step ``Telemetry.on`` flip
can never unbalance the phase stack); disabled mode is one attribute
load + branch per seam. The derived fractions are ordinary registry
gauges, so they appear in scrapes and incident bundles' ``metrics``
snapshots; every ``flight_every`` steps a typed ``step_phases`` flight
event additionally stamps the composition onto the incident timeline.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .registry import FRACTION_EDGES
from .trace import now_us

__all__ = [
    "StepScope",
    "PHASE_CLASS",
    "OTHER_PHASE",
    "FRACTION_GAUGES",
    "STEPSCOPE_TREND_TOLERANCE",
    "summarize_metrics",
    "merge_summaries",
    "phase_trace",
    "trend_rows",
]

#: The reserved residual phase: wall time no explicit phase claimed.
OTHER_PHASE = "other"

#: phase name -> critical-path class. Phases outside this table (fwd_bwd,
#: act, optimizer, infer, other, ...) are compute/residual and contribute
#: to no derived fraction.
PHASE_CLASS: Dict[str, str] = {
    # Host blocked on collective results — the overlap target.
    "grad_allreduce": "comms",
    "wire_wait": "comms",
    # Host/device serialization.
    "host_sync": "host",
    "staging": "host",
    "local_reduce": "host",
    "checkpoint": "host",
    # Input starvation (env tier and serving queue alike).
    "env_wait": "env",
    "batch_fill": "env",
    "queue_wait": "env",
    "linger": "env",
}

_CLASSES = ("comms", "host", "env")

#: derived-fraction class -> exported gauge name (per-loop label).
FRACTION_GAUGES: Dict[str, str] = {
    "comms": "stepscope_exposed_comms_fraction",
    "host": "stepscope_host_blocked_fraction",
    "env": "stepscope_env_wait_fraction",
}

#: Default trend tolerance for the fraction rows. Fractions are noisy at
#: smoke scale (tens of steps on a shared CPU runner), so the band is
#: wide — the detector's MAD floor tightens it automatically once the
#: trend store accumulates stable history.
STEPSCOPE_TREND_TOLERANCE = 0.5


class _StepCM:
    """Reusable ``with scope.step():`` context manager (no per-step
    allocation beyond the ledger dict itself)."""

    __slots__ = ("_s",)

    def __init__(self, scope: "StepScope"):
        self._s = scope

    def __enter__(self) -> "_StepCM":
        s = self._s
        # Snapshot the gate ONCE per step: a mid-step Telemetry.on flip
        # can't unbalance the phase stack or produce a torn ledger.
        s._active = s._tel.on
        if not s._active:
            return self
        s._ledger = {}
        s._stack.clear()
        s._step_ts_us = now_us() if s._tel.tracing else 0
        s._step_t0 = time.monotonic()
        return self

    def __exit__(self, *exc: Any) -> bool:
        s = self._s
        if not s._active:
            return False
        s._active = False
        wall = time.monotonic() - s._step_t0
        s._finish_step(wall, s._ledger, s._step_ts_us)
        return False


class _PhaseCM:
    """Reusable ``with scope.phase(name):`` context manager. Nesting is
    self-time: a child's duration is subtracted from its parent's
    attribution, so the ledger never double-counts nested regions."""

    __slots__ = ("_s", "name")

    def __init__(self, scope: "StepScope", name: str):
        self._s = scope
        self.name = name

    def __enter__(self) -> "_PhaseCM":
        s = self._s
        if not s._active:
            return self
        # [name, t0, child_seconds]
        s._stack.append([self.name, time.monotonic(), 0.0])
        return self

    def __exit__(self, *exc: Any) -> bool:
        s = self._s
        if not s._active or not s._stack:
            return False
        frame = s._stack.pop()
        dt = time.monotonic() - frame[1]
        self_dt = dt - frame[2]
        if self_dt > 0.0:
            led = s._ledger
            led[frame[0]] = led.get(frame[0], 0.0) + self_dt
        if s._stack:
            s._stack[-1][2] += dt
        return False


class StepScope:
    """Per-loop phase attribution: context managers on the owner thread,
    :meth:`observe_step` for overlapping/off-thread producers, derived
    critical-path fractions as windowed registry gauges.

    Threading contract: ``_active`` / ``_stack`` /
    ``_ledger`` / ``_step_t0`` / ``_step_ts_us`` belong to the loop's
    owner thread and are NEVER touched under ``_lock``; the cumulative
    and windowed aggregates live only under ``_lock``. Registry metric
    objects are internally thread-safe and are recorded outside the
    scope lock.
    """

    def __init__(self, loop: str, telemetry=None, window: int = 32,
                 flight_every: int = 64):
        if telemetry is None:
            from . import global_telemetry
            telemetry = global_telemetry()
        self.loop = str(loop)
        self._tel = telemetry
        self._window = max(1, int(window))
        self._flight_every = max(1, int(flight_every))
        self._pid = telemetry.name or "stepscope"
        self._closed = False

        # Owner-thread step state (see class docstring).
        self._active = False
        self._stack: List[List[Any]] = []
        self._ledger: Dict[str, float] = {}
        self._step_t0 = 0.0
        self._step_ts_us = 0

        # Shared aggregates — guarded by _lock.
        self._lock = threading.Lock()
        self._steps = 0
        self._cum_wall = 0.0
        self._cum: Dict[str, float] = {}
        # (wall, comms, host, env, attributed, overrun) per recent step.
        self._win: Deque[Tuple[float, ...]] = deque()
        self._win_sums = [0.0] * 6

        # Metrics. Phase-labeled counter/histogram pairs are cached
        # per phase name; creation races are benign (the registry's
        # get-or-create is idempotent and returns the same object).
        reg = telemetry.registry
        self._m_steps = reg.counter("stepscope_steps_total", loop=self.loop)
        self._m_wall = reg.counter(
            "stepscope_wall_seconds_total", loop=self.loop
        )
        self._m_step_s = reg.histogram(
            "stepscope_step_seconds", loop=self.loop
        )
        self._g_fraction = {
            cls: reg.gauge(name, loop=self.loop)
            for cls, name in FRACTION_GAUGES.items()
        }
        self._g_attributed = reg.gauge(
            "stepscope_attributed_fraction", loop=self.loop
        )
        self._g_overrun = reg.gauge(
            "stepscope_ledger_overrun_fraction", loop=self.loop
        )
        self._phase_m: Dict[str, Tuple[Any, Any]] = {}
        self._phase_cm: Dict[str, _PhaseCM] = {}
        self._step_cm = _StepCM(self)

    # -- owner-thread API ----------------------------------------------------

    def step(self) -> _StepCM:
        """Context manager spanning one loop iteration."""
        return self._step_cm

    def phase(self, name: str) -> _PhaseCM:
        """Context manager attributing a region of the current step to
        ``name``. No-op outside a ``step()`` (or when telemetry was off
        at step entry)."""
        cm = self._phase_cm.get(name)
        if cm is None:
            cm = self._phase_cm.setdefault(name, _PhaseCM(self, name))
        return cm

    def note(self, name: str, seconds: float) -> None:
        """Attribute ``seconds`` of externally measured time (a callback
        duration, a wait the caller already timed) to the current step.
        Owner-thread only; no-op outside an active step."""
        if not self._active or seconds <= 0.0:
            return
        led = self._ledger
        led[name] = led.get(name, 0.0) + float(seconds)

    # -- thread-safe low-level API -------------------------------------------

    def observe_step(self, wall_s: float, phases: Dict[str, float],
                     ts_us: Optional[int] = None) -> None:
        """Record one completed step with an externally measured ledger.

        For producers whose steps overlap in wall time (double-buffered
        envpool batches) or finish on another thread (accumulator round
        callbacks): the caller stamps its own clocks and hands the
        finished ledger over. Thread-safe; gated on ``Telemetry.on``.
        """
        if not self._tel.on:
            return
        self._finish_step(
            max(float(wall_s), 0.0),
            {k: float(v) for k, v in phases.items() if v > 0.0},
            int(ts_us) if ts_us else 0,
        )

    # -- ingestion -----------------------------------------------------------

    def _phase_metrics(self, name: str) -> Tuple[Any, Any]:
        m = self._phase_m.get(name)
        if m is None:
            reg = self._tel.registry
            m = (
                reg.counter(
                    "stepscope_phase_seconds_total",
                    loop=self.loop, phase=name,
                ),
                reg.histogram(
                    "stepscope_phase_fraction", edges=FRACTION_EDGES,
                    loop=self.loop, phase=name,
                ),
            )
            self._phase_m[name] = m
        return m

    def _finish_step(self, wall: float, ledger: Dict[str, float],
                     ts_us: int) -> None:
        wall = max(wall, 1e-9)
        explicit = sum(ledger.values())
        residual = wall - explicit
        if residual > 0.0:
            ledger = dict(ledger)
            ledger[OTHER_PHASE] = ledger.get(OTHER_PHASE, 0.0) + residual
        overrun = -residual if residual < 0.0 else 0.0
        attributed = min(explicit / wall, 1.0)

        tel = self._tel
        if tel.tracing and ts_us:
            # Attribution track: phases drawn back-to-back from step
            # start in ledger (completion) order. It shows composition,
            # not exact in-step placement — the ordinary span tracks
            # carry placement.
            t = ts_us
            for name, secs in ledger.items():
                dur = int(secs * 1e6)
                tel.traces.add_span(
                    f"phase {name}", "stepscope", pid=self._pid,
                    ts_us=t, dur_us=dur, args={"loop": self.loop},
                )
                t += dur

        self._m_steps.inc()
        self._m_wall.inc(wall)
        self._m_step_s.observe(wall)
        by_class = dict.fromkeys(_CLASSES, 0.0)
        for name, secs in ledger.items():
            ctr, hist = self._phase_metrics(name)
            ctr.inc(secs)
            hist.observe(min(secs / wall, 1.0))
            cls = PHASE_CLASS.get(name)
            if cls is not None:
                by_class[cls] += secs

        row = (wall, by_class["comms"], by_class["host"], by_class["env"],
               explicit if residual > 0.0 else wall, overrun)
        flight_fields: Optional[Dict[str, Any]] = None
        with self._lock:
            self._steps += 1
            self._cum_wall += wall
            cum = self._cum
            for name, secs in ledger.items():
                cum[name] = cum.get(name, 0.0) + secs
            win, sums = self._win, self._win_sums
            win.append(row)
            for i, v in enumerate(row):
                sums[i] += v
            if len(win) > self._window:
                old = win.popleft()
                for i, v in enumerate(old):
                    sums[i] -= v
            wall_sum = sums[0] if sums[0] > 0.0 else 1e-9
            fractions = {
                "comms": sums[1] / wall_sum,
                "host": sums[2] / wall_sum,
                "env": sums[3] / wall_sum,
            }
            self._g_fraction["comms"].set(fractions["comms"])
            self._g_fraction["host"].set(fractions["host"])
            self._g_fraction["env"].set(fractions["env"])
            self._g_attributed.set(sums[4] / wall_sum)
            self._g_overrun.set(sums[5] / wall_sum)
            if self._steps % self._flight_every == 0:
                flight_fields = {
                    "loop": self.loop,
                    "steps": self._steps,
                    "wall_s": self._cum_wall,
                    "exposed_comms": fractions["comms"],
                    "host_blocked": fractions["host"],
                    "env_wait": fractions["env"],
                }
        if flight_fields is not None and tel.flight.on:
            tel.flight.record("step_phases", **flight_fields)

    # -- exports -------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Cumulative attribution summary: loop, step count, total wall
        seconds, per-phase seconds, and lifetime class fractions."""
        with self._lock:
            steps = self._steps
            wall = self._cum_wall
            phases = dict(self._cum)
        return _summarize(self.loop, steps, wall, phases)

    def close(self) -> None:
        """Unregister the per-loop gauges so a closed component's scope
        doesn't linger in the scrape as a stale reading. Counters and
        histograms stay (cumulative series survive their producer, like
        every other registry counter). Idempotent."""
        if self._closed:
            return
        self._closed = True
        reg = self._tel.registry
        for name in FRACTION_GAUGES.values():
            reg.unregister(name, loop=self.loop)
        reg.unregister("stepscope_attributed_fraction", loop=self.loop)
        reg.unregister("stepscope_ledger_overrun_fraction", loop=self.loop)


# -- snapshot analysis (tools / reports) -------------------------------------

def _summarize(loop: str, steps: int, wall: float,
               phases: Dict[str, float]) -> Dict[str, Any]:
    wall_div = wall if wall > 0.0 else 1e-9
    by_class = dict.fromkeys(_CLASSES, 0.0)
    for name, secs in phases.items():
        cls = PHASE_CLASS.get(name)
        if cls is not None:
            by_class[cls] += secs
    return {
        "loop": loop,
        "steps": steps,
        "wall_s": wall,
        "phases": dict(sorted(phases.items())),
        "fractions": {
            "exposed_comms": by_class["comms"] / wall_div,
            "host_blocked": by_class["host"] / wall_div,
            "env_wait": by_class["env"] / wall_div,
        },
    }


_SERIES_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
                        r"(?:\{(?P<labels>.*)\})?$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_series_id(sid: str) -> Tuple[str, Dict[str, str]]:
    m = _SERIES_RE.match(sid)
    if m is None:
        return sid, {}
    labels: Dict[str, str] = {}
    raw = m.group("labels")
    if raw:
        for k, v in _LABEL_PAIR_RE.findall(raw):
            labels[k] = (
                v.replace('\\"', '"').replace("\\n", "\n")
                .replace("\\\\", "\\")
            )
    return m.group("name"), labels


def summarize_metrics(
    snapshot: Dict[str, Dict[str, Any]],
) -> Dict[str, Dict[str, Any]]:
    """Reconstruct per-loop phase summaries from a registry snapshot
    (live scrape or a flightrec bundle's ``metrics`` entry).

    Returns ``{loop: summary}`` with the same shape as
    :meth:`StepScope.summary`, computed from the cumulative
    ``stepscope_*_total`` series — so it works on a dead peer's frozen
    bundle exactly as on a live scrape. The windowed gauges, when
    present, ride along under ``"window"``.
    """
    steps: Dict[str, int] = {}
    wall: Dict[str, float] = {}
    phases: Dict[str, Dict[str, float]] = {}
    window: Dict[str, Dict[str, float]] = {}
    gauge_keys = {v: k for k, v in FRACTION_GAUGES.items()}
    gauge_keys["stepscope_attributed_fraction"] = "attributed"
    gauge_keys["stepscope_ledger_overrun_fraction"] = "ledger_overrun"
    for sid, series in snapshot.items():
        if not sid.startswith("stepscope_"):
            continue
        name, labels = _parse_series_id(sid)
        loop = labels.get("loop")
        if loop is None:
            continue
        value = series.get("value", 0.0)
        if name == "stepscope_steps_total":
            steps[loop] = steps.get(loop, 0) + int(value)
        elif name == "stepscope_wall_seconds_total":
            wall[loop] = wall.get(loop, 0.0) + float(value)
        elif name == "stepscope_phase_seconds_total":
            phase = labels.get("phase", OTHER_PHASE)
            d = phases.setdefault(loop, {})
            d[phase] = d.get(phase, 0.0) + float(value)
        elif name in gauge_keys:
            window.setdefault(loop, {})[gauge_keys[name]] = float(value)
    out: Dict[str, Dict[str, Any]] = {}
    for loop in sorted(set(steps) | set(wall) | set(phases)):
        s = _summarize(loop, steps.get(loop, 0), wall.get(loop, 0.0),
                       phases.get(loop, {}))
        if loop in window:
            s["window"] = window[loop]
        out[loop] = s
    return out


def merge_summaries(
    peer_summaries: Dict[str, Dict[str, Dict[str, Any]]],
) -> Dict[str, Dict[str, Any]]:
    """Merge ``{peer: {loop: summary}}`` into one cohort-wide
    ``{loop: summary}`` view.

    Identical per-loop summaries are counted once before summing: two
    peers sharing one OS process each merge the process-global registry
    into their scrape, so a naive cross-peer sum would double-count
    every global-registry loop (the examples' training loops, local env
    pools)."""
    seen = set()
    agg: Dict[str, Dict[str, Any]] = {}
    for peer in sorted(peer_summaries):
        for loop, s in peer_summaries[peer].items():
            key = (loop, s["steps"], round(s["wall_s"], 9),
                   tuple(sorted((k, round(v, 9))
                                for k, v in s["phases"].items())))
            if key in seen:
                continue
            seen.add(key)
            a = agg.setdefault(loop, {"steps": 0, "wall_s": 0.0,
                                      "phases": {}})
            a["steps"] += s["steps"]
            a["wall_s"] += s["wall_s"]
            for ph, secs in s["phases"].items():
                a["phases"][ph] = a["phases"].get(ph, 0.0) + secs
    return {
        loop: _summarize(loop, a["steps"], a["wall_s"], a["phases"])
        for loop, a in sorted(agg.items())
    }


def phase_trace(peer_summaries: Dict[str, Dict[str, Dict[str, Any]]],
                pid_base: int = 0) -> Dict[str, Any]:
    """Chrome-trace *composition* tracks from ``{peer: {loop: summary}}``:
    one track (pid) per peer, one row (tid) per loop, phases drawn
    back-to-back with widths proportional to cumulative seconds. Shows
    where step time went, not when — the span timeline
    (``TraceBuffer.chrome_trace``) carries placement. ``pid_base``
    offsets track ids when appending onto an existing merged trace."""
    events: List[Dict[str, Any]] = []
    for i, peer in enumerate(sorted(peer_summaries), start=1):
        pid = pid_base + i
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"stepscope {peer}"}})
        for tid, (loop, s) in enumerate(
                sorted(peer_summaries[peer].items()), start=1):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": loop}})
            t = 0
            for ph, secs in sorted(s["phases"].items(),
                                   key=lambda kv: -kv[1]):
                dur = max(int(secs * 1e6), 1)
                events.append({
                    "name": f"phase {ph}", "cat": "stepscope", "ph": "X",
                    "pid": pid, "tid": tid, "ts": t, "dur": dur,
                    "args": {"loop": loop, "seconds": secs,
                             "share": secs / max(s["wall_s"], 1e-9)},
                })
                t += dur
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"view": "stepscope composition"}}


def trend_rows(summary: Dict[str, Any], *, smoke: bool, cmd: str,
               suite: str = "stepscope",
               tol: float = STEPSCOPE_TREND_TOLERANCE,
               extra: Optional[Dict[str, Any]] = None) -> List[Any]:
    """Build schema-valid :class:`~moolib_tpu_torch.bench.harness.BenchResult`
    rows from one loop summary — one per derived fraction, unit
    ``fraction``, direction ``lower`` (a growing exposed-comms or
    host-blocked share is a step-composition regression even when
    headline throughput holds). The loop name is part of the metric
    (``stepscope_<loop>_<class>_fraction``): the detector baselines each
    metric as one series, and an envpool's env-wait share must never
    share a baseline with a learner's."""
    from ..bench.harness import BenchResult

    base_extra = {"loop": summary["loop"], "steps": summary["steps"]}
    if extra:
        base_extra.update(extra)
    rows: List[Any] = []
    for key, value in summary["fractions"].items():
        rows.append(
            BenchResult(
                metric=f"stepscope_{summary['loop']}_{key}_fraction",
                value=float(value),
                unit="fraction",
                direction="lower",
                suite=suite,
                smoke=bool(smoke),
                cmd=cmd,
                tol=tol,
                extra=dict(base_extra),
            )
        )
    return rows
