"""Unified telemetry: metrics registry, trace spans, step-phase attribution
and the flight recorder; the counterpart of :mod:`moolib_tpu.telemetry`.

Every component records into a :class:`Telemetry` object, whose
registry exports JSON snapshots and Prometheus text, whose span buffer
exports Chrome-trace JSON, and whose flight recorder feeds incident
bundles (:mod:`moolib_tpu_torch.flightrec`).

Two independent switches, both cheap to consult, read from the
reference's environment variables:

- ``Telemetry.on`` (default **on**, env ``MOOLIB_TPU_TELEMETRY=0`` to
  disable): gates hot-path metric recording. Disabled mode is a single
  attribute check per seam.
- ``Telemetry.tracing`` (default **off**, env ``MOOLIB_TPU_TRACE=1`` to
  enable): gates span recording (and, once the RPC layer is ported,
  trace-id propagation through its wire metadata).

Ownership: a component with a peer identity owns a private
``Telemetry``; components without one (the serving replica with no RPC
binding, the examples' training loops) record into the process-global
instance from :func:`global_telemetry`.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

from .registry import (
    DEFAULT_TIME_EDGES,
    EXPORT_QUANTILES,
    FRACTION_EDGES,
    Counter,
    Gauge,
    Histogram,
    Registry,
    RollingQuantile,
    parse_prometheus,
    quantile_from_export,
)
from .trace import Span, TraceBuffer, now_us, spans_to_chrome
# Imported AFTER .registry/.trace: the flightrec package imports
# moolib_tpu_torch.telemetry.trace, which is satisfied mid-cycle only because
# those submodules are already in sys.modules by this line.
from ..flightrec.recorder import FlightRecorder
from .stepscope import (
    PHASE_CLASS,
    StepScope,
    summarize_metrics as summarize_stepscope,
)

__all__ = [
    "Telemetry",
    "FlightRecorder",
    "StepScope",
    "PHASE_CLASS",
    "summarize_stepscope",
    "Registry",
    "Counter",
    "Gauge",
    "Histogram",
    "RollingQuantile",
    "TraceBuffer",
    "Span",
    "DEFAULT_TIME_EDGES",
    "EXPORT_QUANTILES",
    "FRACTION_EDGES",
    "global_telemetry",
    "parse_prometheus",
    "quantile_from_export",
    "publish_metrics",
    "now_us",
    "spans_to_chrome",
]


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off", "")


class Telemetry:
    """A metrics :class:`Registry` plus a span :class:`TraceBuffer` under
    two cheap gates (``on`` for metrics, ``tracing`` for spans)."""

    def __init__(self, name: str = "", enabled: Optional[bool] = None,
                 tracing: Optional[bool] = None):
        self.name = name
        self.registry = Registry()
        # Span-ring evictions are counted (trace_spans_dropped_total) and
        # labeled on the Chrome export, so a truncated timeline can never
        # masquerade as a complete one.
        self.traces = TraceBuffer(
            drop_counter=self.registry.counter("trace_spans_dropped_total")
        )
        # The black-box flight recorder rides the same ownership model as
        # the registry/span buffer: one typed state-transition ring per
        # telemetry identity, its own gate (`flight.on`, default on, env
        # MOOLIB_TPU_FLIGHTREC=0), frozen into incident bundles by
        # moolib_tpu_torch.flightrec.capture.
        self.flight = FlightRecorder(name)
        self.on = (
            _env_flag("MOOLIB_TPU_TELEMETRY", True)
            if enabled is None else bool(enabled)
        )
        self.tracing = (
            _env_flag("MOOLIB_TPU_TRACE", False)
            if tracing is None else bool(tracing)
        )

    def set_enabled(self, on: bool = True) -> None:
        self.on = bool(on)

    def set_tracing(self, on: bool = True) -> None:
        self.tracing = bool(on)

    # -- exports --------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return self.registry.snapshot()

    def prometheus(self) -> str:
        return self.registry.prometheus()

    def chrome_trace(self) -> Dict[str, Any]:
        return self.traces.chrome_trace()


_global_lock = threading.Lock()
_global: Optional[Telemetry] = None


def global_telemetry() -> Telemetry:
    """The process-global :class:`Telemetry` — home of everything without
    a peer identity (batchers, env pools, chaos plans, example training
    loops). Every ``__telemetry`` scrape merges it in, so any peer's
    scrape shows the whole process."""
    global _global
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = Telemetry("global")
    return _global


_METRIC_SAFE = re.compile(r"[^a-zA-Z0-9_:]")


def publish_metrics(row: Dict[str, Any], prefix: str = "train",
                    registry: Optional[Registry] = None, **labels) -> None:
    """Publish a row of training metrics as gauges (``{prefix}_{key}``).

    The examples' bridge from their per-interval log rows into the
    scrapeable registry: any numeric value becomes a gauge set, non-numeric
    values are skipped. Keys are sanitized to metric-name charset."""
    reg = registry if registry is not None else global_telemetry().registry
    for k, v in row.items():
        if isinstance(v, bool):
            v = float(v)
        try:
            f = float(v)
        except (TypeError, ValueError):
            continue
        name = f"{prefix}_{_METRIC_SAFE.sub('_', str(k))}"
        reg.gauge(name, **labels).set(f)
