"""Telemetry smoke of the port: live scrape validation + disabled-mode
overhead budget; the twin of the reference's ``tools/telemetry_smoke.py``.

Three checks, all on the host (no device work: the flag ``--device`` is
not taken) and bounded well under 30s:

1. **Scrape round-trip** — a live two-Rpc cohort serves echo traffic,
   then both peers are scraped over the wire in JSON and Prometheus text
   form. The text form must survive the strict parser
   (:func:`moolib_tpu_torch.telemetry.parse_prometheus`), per-endpoint latency
   histograms must be non-empty with monotone cumulative buckets, and
   the JSON/Prometheus views must agree on the counter samples.
2. **Trace propagation** — with tracing enabled, a call's caller and
   handler spans (scraped from *different* peers) share a trace id in
   the exported Chrome-trace JSON.
3. **Disabled-mode overhead budget** — instrument sites gate on one
   attribute check (``telemetry.on``); this measures that gate's cost
   directly and asserts a conservative per-call multiple of it stays
   under ``--budget`` (default 5%) of the measured live echo latency.
   The gate is measured in isolation (not echo-vs-echo A/B) so the
   check is immune to loopback-latency noise: the signal is ~20ns/gate
   against a ~100µs call floor. The live enabled-vs-disabled wall times
   are printed for the record.

A fourth check holds the flight recorder's disabled mode to silence.
:func:`run_checks` runs them all and returns the readings.

Usage::

    python -m moolib_tpu_torch.tools.telemetry_smoke [--calls 200] [--budget 0.05]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..rpc import Rpc
from ..telemetry import Telemetry, parse_prometheus

# Upper bound on telemetry.on gate consultations per echo call across
# both peers (client dispatch + response, server dispatch + respond,
# bytes in/out on each side, timeout wheel) — counted generously so the
# budget check stays conservative as seams are added.
GATES_PER_CALL = 32
# Upper bound on flight-recorder (flight.on) gate consultations per echo
# call. The recorder's seams are state TRANSITIONS (conn lifecycle,
# resend, timeout, election...), none of which fire on a healthy echo —
# but the budget charges a generous per-call multiple of the gate anyway
# so the disabled-mode guarantee covers pathological paths too.
FLIGHT_GATES_PER_CALL = 8
# Phase regions per charged stepscope step. The budget bills one fully
# disabled ``scope.step()`` containing this many ``scope.phase()``
# context managers per echo call — generous: no instrumented hot loop
# wraps more than ~6 phases per step (docs/observability.md), and a
# real step does far more work than a loopback echo.
STEPSCOPE_PHASES_PER_CALL = 8


def _echo_cohort(tracing: bool):
    a = Rpc("smoke-a")
    b = Rpc("smoke-b")
    if tracing:
        a.telemetry.set_tracing(True)
        b.telemetry.set_tracing(True)
    b.define("echo", lambda x: x)
    # OS-assigned port: a fixed port turns a busy host (parallel CI
    # jobs, leftover processes) into a spurious red gate.
    b.listen("127.0.0.1:0")
    a.connect(b.debug_info()["listen"][0])
    return a, b


def _drive(a: Rpc, calls: int) -> float:
    t0 = time.perf_counter()
    for i in range(calls):
        assert a.sync("smoke-b", "echo", i) == i
    return time.perf_counter() - t0


def check_scrape(calls: int) -> float:
    """Live scrape round-trip + trace propagation. Returns the measured
    per-call echo latency (telemetry fully on), for the report."""
    a, b = _echo_cohort(tracing=True)
    try:
        elapsed = _drive(a, calls)
        for target, scraper in (("smoke-b", a), ("smoke-a", b)):
            snap = scraper.sync(target, "__telemetry")
            prom_text = scraper.sync(target, "__telemetry", fmt="prometheus")
            prom = parse_prometheus(prom_text)  # must parse
            assert snap["name"] == target, snap["name"]
            metrics = snap["metrics"]
            hist_key = (
                'rpc_server_handle_seconds{endpoint="echo"}'
                if target == "smoke-b"
                else 'rpc_client_latency_seconds{endpoint="echo"}'
            )
            hist = metrics[hist_key]
            assert hist["count"] >= calls, (hist_key, hist["count"])
            cum = hist["buckets"]
            assert all(x <= y for x, y in zip(cum, cum[1:])), (
                f"{target}: non-monotone cumulative buckets"
            )
            # JSON and text expositions are two views of one registry.
            # Only the echo-labeled series are quiesced between the two
            # scrapes (the scrapes themselves move the wire counters and
            # the __telemetry endpoint's own series), so exact agreement
            # is asserted on those.
            for sid, series in metrics.items():
                if series["type"] == "counter" and 'endpoint="echo"' in sid:
                    assert sid in prom and prom[sid] == series["value"], (
                        f"{target}: {sid} json={series['value']} "
                        f"prom={prom.get(sid)}"
                    )
        # Caller + handler spans of one call share a trace id across the
        # two peers' exports.
        trace_a = b.sync("smoke-a", "__telemetry", spans=True)["trace"]
        trace_b = a.sync("smoke-b", "__telemetry", spans=True)["trace"]
        def _ids(trace, name):
            return {
                ev["args"]["trace_id"]
                for ev in trace["traceEvents"]
                if ev.get("name") == name and "trace_id" in ev.get("args", {})
            }
        shared = _ids(trace_a, "call echo") & _ids(trace_b, "handle echo")
        assert len(shared) >= calls, (
            f"only {len(shared)} trace ids shared caller->handler"
        )
        json.dumps(trace_a)  # exported trace must be plain JSON
        return elapsed / calls
    finally:
        a.close()
        b.close()


def measure_disabled_echo(calls: int) -> float:
    """Per-call echo latency with telemetry disabled on both peers."""
    a, b = _echo_cohort(tracing=False)
    a.telemetry.set_enabled(False)
    b.telemetry.set_enabled(False)
    try:
        return _drive(a, calls) / calls
    finally:
        a.close()
        b.close()


def _measure_gate_ns(gated, iters: int) -> float:
    """Cost of one disabled instrument-site gate on ``gated.on``
    (attribute load + branch), in seconds — measured against an
    identical loop without the gate so loop overhead cancels. ONE
    protocol for both gate families: they share the budget, so they
    must share the measurement."""

    def loop_with_gate(n):
        t0 = time.perf_counter()
        for _ in range(n):
            if gated.on:
                raise AssertionError("gate should be off")
        return time.perf_counter() - t0

    def loop_bare(n):
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return time.perf_counter() - t0

    with_gate = min(loop_with_gate(iters) for _ in range(3))
    bare = min(loop_bare(iters) for _ in range(3))
    return max(0.0, (with_gate - bare) / iters)


def measure_gate_ns(iters: int = 200_000) -> float:
    """One disabled telemetry gate (``Telemetry.on``)."""
    return _measure_gate_ns(Telemetry("gatebench", enabled=False), iters)


def measure_flight_gate_ns(iters: int = 200_000) -> float:
    """One disabled flight-recorder gate (``flight.on``) — the same
    one-attribute-check discipline, measured by the same protocol."""
    fr = Telemetry("gatebench").flight
    fr.set_enabled(False)
    return _measure_gate_ns(fr, iters)


def measure_stepscope_step_ns(iters: int = 20_000) -> float:
    """One fully disabled stepscope step — ``scope.step()`` wrapping
    :data:`STEPSCOPE_PHASES_PER_CALL` phase regions — in seconds.

    Unlike the bare gates above, the disabled cost here is the whole
    context-manager machinery (``__enter__``/``__exit__`` dispatch plus
    the one-attribute ``_active`` branch inside each), because that is
    exactly what rides an instrumented loop when telemetry is off."""
    from ..telemetry import StepScope

    scope = StepScope("gatebench", telemetry=Telemetry("gatebench",
                                                       enabled=False))
    phases = [scope.phase(f"p{i}") for i in range(STEPSCOPE_PHASES_PER_CALL)]

    def loop_instrumented(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with scope.step():
                for cm in phases:
                    with cm:
                        pass
        return time.perf_counter() - t0

    def loop_bare(n):
        t0 = time.perf_counter()
        for _ in range(n):
            for cm in phases:
                pass
        return time.perf_counter() - t0

    instrumented = min(loop_instrumented(iters) for _ in range(3))
    bare = min(loop_bare(iters) for _ in range(3))
    scope.close()
    return max(0.0, (instrumented - bare) / iters)


def check_flightrec_disabled_cleanliness(calls: int = 20) -> None:
    """With the recorder gated off, an echo cohort's rings must stay
    EMPTY through live traffic (the disabled mode is silence, not merely
    cheapness). The recorders are disabled BEFORE listen/connect — the
    greeting's conn_up lands on the Rpc IO thread and would race a
    disable issued after the dial."""
    a = Rpc("smoke-a")
    b = Rpc("smoke-b")
    a.telemetry.flight.set_enabled(False)
    b.telemetry.flight.set_enabled(False)
    b.define("echo", lambda x: x)
    b.listen("127.0.0.1:0")
    a.connect(b.debug_info()["listen"][0])
    try:
        _drive(a, calls)
        assert len(a.telemetry.flight) == 0, (
            f"disabled recorder captured {len(a.telemetry.flight)} events"
        )
        assert len(b.telemetry.flight) == 0, (
            f"disabled recorder captured {len(b.telemetry.flight)} events"
        )
    finally:
        a.close()
        b.close()


def run_checks(calls: int = 200, budget: float = 0.05,
               log=print) -> dict:
    """The smoke's checks in order; raises ``AssertionError`` at the
    first that fails. Returns the readings: per-call echo seconds with
    telemetry on and off, the gate costs, and the overhead fraction."""
    log("== scrape round-trip + trace propagation ==")
    per_call_on = check_scrape(calls)
    log(f"ok   scraped both peers; echo {per_call_on * 1e6:.0f}us/call "
        f"(telemetry+tracing ON)")

    log("== flightrec disabled-mode cleanliness ==")
    check_flightrec_disabled_cleanliness()
    log("ok   disabled recorder stayed empty through live traffic")

    log("== disabled-mode overhead ==")
    per_call_off = measure_disabled_echo(calls)
    gate = measure_gate_ns()
    fgate = measure_flight_gate_ns()
    sstep = measure_stepscope_step_ns()
    # One budget for ALL gate families: the telemetry gates, the
    # flight-recorder gates, and one fully disabled stepscope step must
    # together stay under the echo-latency fraction.
    overhead = GATES_PER_CALL * gate + FLIGHT_GATES_PER_CALL * fgate + sstep
    frac = overhead / per_call_off
    log(f"echo {per_call_off * 1e6:.0f}us/call (telemetry OFF); "
        f"gate {gate * 1e9:.1f}ns x{GATES_PER_CALL} + "
        f"flight gate {fgate * 1e9:.1f}ns x{FLIGHT_GATES_PER_CALL} + "
        f"stepscope step {sstep * 1e9:.0f}ns "
        f"(x{STEPSCOPE_PHASES_PER_CALL} phases) = "
        f"{overhead * 1e6:.3f}us/call -> {frac * 100:.3f}% "
        f"(budget {budget * 100:.0f}%)")
    assert frac < budget, (
        f"disabled-mode instrumentation overhead {frac * 100:.2f}% "
        f"exceeds the {budget * 100:.0f}% budget"
    )
    log(f"for the record: enabled/disabled wall ratio "
        f"{per_call_on / per_call_off:.2f}x (includes tracing)")
    return {"echo_on_s": per_call_on, "echo_off_s": per_call_off,
            "gate_s": gate, "flight_gate_s": fgate,
            "stepscope_step_s": sstep, "overhead_s": overhead,
            "overhead_frac": frac, "budget": budget}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--calls", type=int, default=200,
                        help="echo calls per cohort run")
    parser.add_argument("--budget", type=float, default=0.05,
                        help="disabled-mode overhead budget (fraction)")
    args = parser.parse_args(argv)
    readings = run_checks(args.calls, args.budget)
    print(json.dumps(readings))
    print("TELEMETRY SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
