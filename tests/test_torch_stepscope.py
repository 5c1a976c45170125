"""Port parity: StepScope's phase ledgers and their snapshot analysis
(summarize_metrics, merge_summaries, phase_trace, trend_rows) in
moolib_tpu_torch against moolib_tpu.

Two layers. The same seeded ``observe_step`` sequence (explicit walls,
phases and span timestamps) goes to a reference scope and a port scope,
each on a fresh Telemetry, and every export must be equal. Then the
ledger-arithmetic cases of the reference's own tests (nesting and self
time, the ``other`` residual, overrun, the window, the gate) run against
both packages under one fake ``time.monotonic`` clock. Tolerance: exact
equality between the packages (the same float operations in the same
order); within a package the cases use the reference tests' own checks.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

import moolib_tpu.telemetry as ref_tel
import moolib_tpu.telemetry.stepscope as ref_ss
import moolib_tpu_torch.telemetry as port_tel
import moolib_tpu_torch.telemetry.stepscope as port_ss


def _pkg(tel, ss):
    return types.SimpleNamespace(
        Telemetry=tel.Telemetry, StepScope=tel.StepScope,
        Registry=tel.Registry, summarize=tel.summarize_stepscope,
        merge_summaries=ss.merge_summaries, phase_trace=ss.phase_trace,
        trend_rows=ss.trend_rows, FRACTION_GAUGES=ss.FRACTION_GAUGES)


REF, PORT = _pkg(ref_tel, ref_ss), _pkg(port_tel, port_ss)


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def pkg(request):
    return request.param


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both packages: each reads
    ``time.monotonic`` from the shared ``time`` module at call time."""
    clk = FakeClock()
    monkeypatch.setattr(time, "monotonic", clk)
    return clk


# -- the same observations through both packages -----------------------------

PHASES = ("fwd_bwd", "optimizer", "host_sync", "staging", "queue_wait",
          "linger", "infer", "grad_allreduce", "env_wait")


def _observe(pkg, seed, loop="learner", name="peer-a"):
    """A seeded observe_step sequence (some steps overrun their wall) into
    a fresh Telemetry with tracing on; returns (telemetry, scope)."""
    rng = np.random.default_rng(seed)
    tel = pkg.Telemetry(name, enabled=True, tracing=True)
    scope = pkg.StepScope(loop, telemetry=tel, window=5, flight_every=3)
    for i in range(17):
        chosen = rng.choice(PHASES, size=int(rng.integers(1, 5)),
                            replace=False)
        phases = {str(p): float(rng.exponential(0.01)) for p in chosen}
        phases["zero"] = 0.0  # dropped: only positive phases count
        wall = float(sum(phases.values()) * rng.uniform(0.8, 1.5))
        scope.observe_step(wall, phases, ts_us=1_000_000 + 50_000 * i)
    return tel, scope


def _flight(tel):
    return [{k: v for k, v in e.items() if k != "ts_us"}
            for e in tel.flight.events()]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observe_step_sequence_matches_reference(seed):
    (rt, rs), (pt, ps) = _observe(REF, seed), _observe(PORT, seed)
    assert json.dumps(ps.summary()) == json.dumps(rs.summary())
    assert json.dumps(pt.snapshot()) == json.dumps(rt.snapshot())
    assert pt.prometheus() == rt.prometheus()
    assert json.dumps(pt.chrome_trace()) == json.dumps(rt.chrome_trace())
    assert _flight(pt) == _flight(rt)
    assert [e["fields"]["steps"] for e in _flight(pt)] == [3, 6, 9, 12, 15]
    got = PORT.summarize(pt.snapshot())
    assert json.dumps(got) == json.dumps(REF.summarize(rt.snapshot()))
    live = ps.summary()
    window = got["learner"].pop("window")
    assert got["learner"] == live
    assert set(window) == {"comms", "host", "env", "attributed",
                           "ledger_overrun"}
    # The ledger closes: phases (with the residual "other") sum to wall
    # within the overrun the gauge reports.
    assert sum(live["phases"].values()) >= live["wall_s"] - 1e-12


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_trace_and_trend_rows_match_reference(seed):
    summaries = {}
    for pkg in (REF, PORT):
        peers = {}
        for i, name in enumerate(("peer-a", "peer-b", "peer-c")):
            tel, _ = _observe(pkg, seed + (i % 2), loop=f"loop{i % 2}",
                              name=name)
            peers[name] = pkg.summarize(tel.snapshot())
        summaries[pkg is PORT] = peers
    ref_peers, port_peers = summaries[False], summaries[True]
    merged = PORT.merge_summaries(port_peers)
    assert json.dumps(merged) == json.dumps(REF.merge_summaries(ref_peers))
    # peer-c repeats peer-a's loop0 summary: counted once.
    assert merged["loop0"]["steps"] == 17
    assert json.dumps(PORT.phase_trace(port_peers, pid_base=3)) == \
        json.dumps(REF.phase_trace(ref_peers, pid_base=3))
    rows = [[{k: v for k, v in r.to_row().items() if k not in ("env", "t")}
             for r in pkg.trend_rows(s["loop0"], smoke=True, cmd="c",
                                     extra={"seed": seed})]
            for pkg, s in ((REF, ref_peers["peer-a"]),
                           (PORT, port_peers["peer-a"]))]
    assert rows[0] == rows[1]
    assert [r["metric"] for r in rows[1]] == [
        "stepscope_loop0_exposed_comms_fraction",
        "stepscope_loop0_host_blocked_fraction",
        "stepscope_loop0_env_wait_fraction"]


# -- the reference's ledger-arithmetic cases, against both packages ----------


def _scope(pkg, **kw):
    return pkg.StepScope(kw.pop("loop", "loop"),
                         telemetry=kw.pop("telemetry", None)
                         or pkg.Telemetry("t"), **kw)


def test_nested_phases_self_time_and_other_residual(pkg, clock):
    scope = _scope(pkg)
    with scope.step():
        with scope.phase("grad_allreduce"):
            clock.advance(0.3)
            with scope.phase("host_sync"):
                clock.advance(0.5)
            clock.advance(0.2)
        clock.advance(1.0)  # unattributed -> "other"
    s = scope.summary()
    assert s["phases"] == pytest.approx(
        {"grad_allreduce": 0.5, "host_sync": 0.5, "other": 1.0})
    assert s["wall_s"] == pytest.approx(2.0)
    assert s["fractions"]["exposed_comms"] == pytest.approx(0.25)
    assert s["fractions"]["host_blocked"] == pytest.approx(0.25)
    assert s["fractions"]["env_wait"] == 0.0
    assert sum(s["phases"].values()) == pytest.approx(s["wall_s"])


def test_repeated_phase_accumulates_and_gauges_track_window(pkg, clock):
    scope = _scope(pkg, window=2)
    reg = scope._tel.registry
    for comms in (0.8, 0.2, 0.4):
        with scope.step():
            with scope.phase("wire_wait"):
                clock.advance(comms)
            with scope.phase("wire_wait"):
                clock.advance(0.0)
            clock.advance(1.0 - comms)
    g = reg.snapshot()[f'{pkg.FRACTION_GAUGES["comms"]}{{loop="loop"}}']
    assert g["value"] == pytest.approx(0.3)
    assert scope.summary()["phases"]["wire_wait"] == pytest.approx(1.4)
    assert scope.summary()["fractions"]["exposed_comms"] == pytest.approx(
        1.4 / 3.0)


def test_note_overrun_surfaces_as_gauge_not_corrupt_fractions(pkg, clock):
    scope = _scope(pkg)
    with scope.step():
        clock.advance(1.0)
        scope.note("host_sync", 1.5)
    snap = scope._tel.snapshot()
    assert snap['stepscope_ledger_overrun_fraction{loop="loop"}'][
        "value"] == pytest.approx(0.5)
    assert snap['stepscope_attributed_fraction{loop="loop"}'][
        "value"] == pytest.approx(1.0)
    s = scope.summary()
    assert "other" not in s["phases"]
    assert s["fractions"]["host_blocked"] == pytest.approx(1.5)


def test_observe_step_threadsafe_aggregation(pkg, clock):
    scope = _scope(pkg)
    n, per = 8, 50

    def worker():
        for _ in range(per):
            scope.observe_step(0.01, {"env_wait": 0.004, "staging": 0.002})

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    s = scope.summary()
    assert s["steps"] == n * per
    assert s["wall_s"] == pytest.approx(n * per * 0.01)
    assert s["phases"]["env_wait"] == pytest.approx(n * per * 0.004)
    assert s["fractions"]["env_wait"] == pytest.approx(0.4)
    assert s["fractions"]["host_blocked"] == pytest.approx(0.2)


def test_gate_off_records_nothing_and_mid_step_flip_is_safe(pkg, clock):
    tel = pkg.Telemetry("t", enabled=False)
    scope = _scope(pkg, telemetry=tel)
    with scope.step():
        with scope.phase("env_wait"):
            clock.advance(1.0)
    scope.observe_step(1.0, {"env_wait": 1.0})
    assert scope.summary()["steps"] == 0
    with scope.step():
        tel.set_enabled(True)
        with scope.phase("env_wait"):
            clock.advance(1.0)
    assert scope.summary()["steps"] == 0
    with scope.step():
        with scope.phase("env_wait"):
            clock.advance(1.0)
    assert scope.summary()["steps"] == 1
    with scope.step():
        tel.set_enabled(False)
        with scope.phase("env_wait"):
            clock.advance(1.0)
    assert scope.summary()["steps"] == 2


def test_phase_outside_a_step_is_a_no_op(pkg, clock):
    scope = _scope(pkg)
    with scope.phase("fwd_bwd"):
        clock.advance(1.0)
    scope.note("host_sync", 1.0)
    assert scope.summary()["steps"] == 0
    assert scope.phase("fwd_bwd") is scope.phase("fwd_bwd")


def test_close_unregisters_gauges_keeps_cumulative_series(pkg, clock):
    scope = _scope(pkg)
    with scope.step():
        with scope.phase("env_wait"):
            clock.advance(0.5)
    scope.close()
    scope.close()  # idempotent
    snap = scope._tel.snapshot()
    assert not any("fraction{" in sid and "phase_fraction" not in sid
                   for sid in snap), sorted(snap)
    assert snap['stepscope_steps_total{loop="loop"}']["value"] == 1
    assert 'stepscope_phase_seconds_total{loop="loop",phase="env_wait"}' \
        in snap


def test_flight_events_and_trace_spans(pkg, clock):
    tel = pkg.Telemetry("t", tracing=True)
    scope = _scope(pkg, telemetry=tel, flight_every=2)
    for i in range(4):
        scope.observe_step(1.0, {"grad_allreduce": 0.25}, ts_us=1000 * i)
    events = [e for e in tel.flight.events() if e["kind"] == "step_phases"]
    assert [e["fields"]["steps"] for e in events] == [2, 4]
    assert events[-1]["fields"]["loop"] == "loop"
    assert events[-1]["fields"]["exposed_comms"] == pytest.approx(0.25)
    assert events[-1]["fields"]["wall_s"] == pytest.approx(4.0)
    trace = tel.chrome_trace()
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "stepscope"}
    assert names == {"phase grad_allreduce", "phase other"}


def test_summarize_metrics_matches_live_summary(pkg, clock):
    tel = pkg.Telemetry("t")
    scope = _scope(pkg, telemetry=tel)
    for _ in range(3):
        scope.observe_step(2.0, {"wire_wait": 0.5, "host_sync": 0.25,
                                 "queue_wait": 0.25})
    live = scope.summary()
    recon = pkg.summarize(tel.snapshot())["loop"]
    window = recon.pop("window")
    assert recon == live
    assert window["comms"] == pytest.approx(0.25)
    assert window["attributed"] == pytest.approx(0.5)
    assert window["ledger_overrun"] == 0.0
    scope.close()
    assert pkg.summarize(tel.snapshot())["loop"] == live


def test_merge_summaries_dedups_shared_global_registry(pkg, clock):
    tel = pkg.Telemetry("t")
    scope = _scope(pkg, telemetry=tel)
    scope.observe_step(1.0, {"env_wait": 0.5})
    one = pkg.summarize(tel.snapshot())
    merged = pkg.merge_summaries({"peer-a": one, "peer-b": one})
    assert merged["loop"]["steps"] == 1
    assert merged["loop"]["fractions"]["env_wait"] == pytest.approx(0.5)
    scope.observe_step(1.0, {"env_wait": 0.5})
    two = pkg.summarize(tel.snapshot())
    merged = pkg.merge_summaries({"peer-a": one, "peer-b": two})
    assert merged["loop"]["steps"] == 3


def test_phase_trace_composition_tracks(pkg, clock):
    tel = pkg.Telemetry("t")
    scope = _scope(pkg, telemetry=tel)
    scope.observe_step(1.0, {"env_wait": 0.75, "staging": 0.25})
    trace = pkg.phase_trace({"p": pkg.summarize(tel.snapshot())},
                            pid_base=7)
    bars = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in bars} == {"phase env_wait", "phase staging"}
    assert all(e["pid"] == 8 for e in bars)
    by_name = {e["name"]: e for e in bars}
    assert by_name["phase env_wait"]["dur"] == 750_000
    assert by_name["phase staging"]["ts"] == 750_000
    json.dumps(trace)


def test_malicious_phase_names_bounded_by_cardinality_guard(pkg, clock):
    tel = pkg.Telemetry("t")
    tel.registry = pkg.Registry(label_cardinality=8)
    scope = _scope(pkg, telemetry=tel)
    for i in range(50):
        scope.observe_step(0.01, {f"phase{i}": 0.01})
    phase_series = [sid for sid in tel.snapshot()
                    if sid.startswith("stepscope_phase_seconds_total")]
    assert len(phase_series) <= 9
    assert any('phase="other"' in sid for sid in phase_series)
