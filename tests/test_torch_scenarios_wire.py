"""Port parity: the wire and elastic chaos scenarios
(moolib_tpu_torch.testing.scenarios) and the soak runner
(moolib_tpu_torch.tools.chaos_soak).

Each scenario runs on the port's Rpc, Broker, Group and Accumulator with
the seed of its reference test (tests/test_chaos.py) and must return the
summary that test asserts. Where the reference pins an exact summary, two
runs of one seed must also give the same injected-event log. The
scenarios' models and payloads are numpy, as in the reference. The env
and serving tiers' scenarios are in test_torch_scenarios_env.py and
test_torch_scenarios_serving.py: spread over three files, xdist's
--dist loadfile runs them in three workers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from moolib_tpu_torch.flightrec import disable_auto_capture, load_bundle
from moolib_tpu_torch.testing import chaos, scenarios

REPO_ROOT = Path(__file__).resolve().parent.parent


def replayed(monkeypatch, name, seed, **kwargs):
    """Run scenario ``name`` twice with ``seed``; return the two runs'
    (summary, event log of the first plan the run made). Both are equal
    for a scenario whose only injections are scripted."""
    made = []

    def recording(base):
        class Recording(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)
        return Recording

    monkeypatch.setattr(scenarios, "FaultPlan", recording(chaos.FaultPlan))
    monkeypatch.setattr(scenarios, "ProcFaultPlan",
                        recording(chaos.ProcFaultPlan))
    runs = []
    for _ in range(2):
        del made[:]
        summary = scenarios.SCENARIOS[name](seed, **kwargs)
        runs.append((summary, [tuple(e) for e in made[0].events]))
    return runs


def test_drop_storm_scenario():
    summary = scenarios.scenario_drop_storm(seed=31)
    assert summary.get("drop", 0) >= 1, summary


def test_partition_heal_scenario():
    summary = scenarios.scenario_partition_heal(seed=23)
    assert summary.get("partitioned", 0) >= 1, summary


def test_leader_loss_scenario():
    summary = scenarios.scenario_leader_loss(seed=47)
    assert summary.get("conn_kill", 0) == 1, summary


def test_straggler_quorum_scenario():
    summary = scenarios.scenario_straggler_quorum(seed=505)
    assert set(summary) <= {"delay"}, summary
    assert summary.get("delay", 0) >= 1, summary


@pytest.mark.parametrize("name, seed, want", [
    ("learner_restart", 303, {"conn_kill": 1}),
    ("broker_failover", 404, {"conn_kill": 1}),
    ("shm_lane_fallback", 606, {"conn_kill": 2}),
])
def test_pinned_wire_scenario_replays_its_log(monkeypatch, tmp_path, name,
                                              seed, want):
    kwargs = {"tmpdir": str(tmp_path)} if name == "learner_restart" else {}
    (s1, log1), (s2, log2) = replayed(monkeypatch, name, seed, **kwargs)
    assert s1 == s2 == want
    assert log1 == log2 and [e[1] for e in log1] == ["conn_kill"] * sum(
        want.values())


def _soak(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.chaos_soak", *args],
        cwd=str(cwd), capture_output=True, text=True, timeout=180,
        env={**os.environ, "PYTHONPATH": str(REPO_ROOT)},
    )


def test_chaos_soak_smoke_under_restrack(tmp_path):
    """The CPU smoke of the soak: one scenario under the resource
    tracker, its summary, the tracker's line and the JSON report."""
    proc = _soak("--smoke", "--scenario", "drop_storm", "--device", "cpu",
                 "--restrack", "--incident-dir", str(tmp_path / "inc"),
                 cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("ok   drop_storm seed=0 "), lines
    assert any(ln.startswith("restrack: ") and "leaked=0" in ln
               for ln in lines), lines
    report = json.loads(lines[-1])
    assert report["ok"] and report["runs"] == 1 and not report["failed"]
    assert report["restrack"]["tracked"] > 0
    assert report["restrack"]["leaked"] == {}
    assert set(report["scenario_seconds"]) == {"drop_storm"}


def test_chaos_soak_failure_prints_replay_and_captures_bundle(
        tmp_path, monkeypatch, capsys):
    """A failing scenario leaves an incident bundle: its path printed
    next to the replay command and recorded in the JSON report."""
    from moolib_tpu_torch.tools import chaos_soak as soak

    def zz_fail(seed):
        raise AssertionError(f"deliberate failure (seed={seed})")

    monkeypatch.setitem(scenarios.SCENARIOS, "zz_fail", zz_fail)
    try:
        rc = soak.main(["--smoke", "--scenario", "zz_fail", "--seed", "5",
                        "--device", "cpu",
                        "--incident-dir", str(tmp_path / "inc")])
    finally:
        disable_auto_capture()  # main() enabled auto-capture globally
    assert rc == 1
    out = capsys.readouterr().out
    assert ("replay: python -m moolib_tpu_torch.tools.chaos_soak "
            "--scenario zz_fail --seed 5 --smoke --device cpu") in out
    assert "incident bundle:" in out
    report = json.loads(out.strip().splitlines()[-1])
    (failure,) = report["failed"]
    assert failure["scenario"] == "zz_fail" and failure["seed"] == 5
    bundle = load_bundle(failure["bundle"])
    assert bundle["trigger"]["kind"] == "scenario_failure"
    assert "zz_fail" in bundle["trigger"]["detail"]
