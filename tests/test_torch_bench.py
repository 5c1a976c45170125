"""bench_torch.py and the port's train-step timing, on the CPU at a
small size (the numbers are the CPU's: only the card's count)."""

import json
import math

import pytest
import torch

import bench_torch
from moolib_tpu_torch import (
    ClippedAdam,
    ImpalaNet,
    make_impala_train_step,
    make_train_state,
)
from moolib_tpu_torch.utils.benchmark import WARMUP_STEPS, time_train_step

KEYS = {"metric", "value", "unit", "vs_baseline", "mfu",
        "model_tflops_per_sec_per_chip", "device_kind"}


def test_bench_prints_one_line_of_the_stated_keys(capsys):
    line = bench_torch.main(device="cpu", batch=2, iters=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == KEYS
    assert line["metric"] == "impala_train_env_steps_per_sec_per_chip"
    assert line["unit"] == "env-steps/s/chip"
    assert line["value"] > 0 and line["model_tflops_per_sec_per_chip"] > 0
    # No peak for the CPU, and no figure of another chip to compare with.
    assert line["device_kind"] == "cpu"
    assert line["mfu"] is None and line["vs_baseline"] is None


def test_bench_batch_is_bench_pys():
    b = bench_torch.make_batch(3, 2, 6, "cpu")
    assert b["obs"].shape == (4, 2, 84, 84, 4)
    assert b["obs"].dtype == torch.uint8
    assert b["done"].shape == (4, 2) and b["done"].dtype == torch.bool
    assert b["actions"].shape == (3, 2) and int(b["actions"].max()) < 6
    assert not b["behavior_logits"].any() and b["core_state"] == ()


def _state(lr=1e-3):
    net = ImpalaNet(6, (16, 16, 4), channels=(4, 4, 4), hidden_size=8,
                    device="cpu", generator=torch.Generator().manual_seed(0))
    return make_train_state(net, ClippedAdam(net.parameters(), lr))


def test_time_train_step_chains_warmup_and_timed_steps(tmp_path):
    batch = bench_torch.make_batch(2, 2, 6, "cpu")
    batch["obs"] = batch["obs"][:, :, :16, :16]
    state, seconds, warmup_s = time_train_step(
        make_impala_train_step(), _state(), batch, iters=3,
        trace_dir=str(tmp_path))
    assert state.step == WARMUP_STEPS + 3
    assert seconds > 0 and warmup_s > 0
    assert json.loads((tmp_path / "train_step.json").read_text())


def test_time_train_step_refuses_non_finite_parameters():
    batch = bench_torch.make_batch(2, 2, 6, "cpu")
    batch["obs"] = batch["obs"][:, :, :16, :16]
    state = _state()
    with torch.no_grad():
        state.model.policy.weight.fill_(math.inf)
    with pytest.raises(RuntimeError, match="not finite"):
        time_train_step(make_impala_train_step(), state, batch, iters=1)


def test_bench_allreduce_at_two_peers_prints_the_reference_keys(capsys):
    """bench_allreduce_torch.py's tree sweep on the CPU at 2 peers and
    2**10 floats: one JSON line of bench_allreduce.py's keys, each result
    checked by the workers (the sum of the ranks)."""
    import bench_allreduce_torch

    rows = bench_allreduce_torch.bench_rpc_tree(2, (2**10,), timeout=120.0)
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in out] == rows
    (row,) = rows
    assert set(row) == {"plane", "peers", "mb", "ms", "gbps"}
    assert row["plane"] == "dcn_rpc_tree" and row["peers"] == 2
    assert row["mb"] == round(2**10 * 4 / 1e6, 2)
    assert row["ms"] > 0 and row["gbps"] > 0


def test_bench_e2e_prints_one_line_of_the_references_keys(capsys):
    """bench_e2e_torch.py's loop on the CPU, at a small batch: one JSON
    line of bench_e2e.py's keys on stdout (the rate is the CPU's), and
    the loop's phase ledger on stderr."""
    import bench_e2e_torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the test processes run side by side
    try:
        line = bench_e2e_torch.main(duration=20.0, device="cpu", batch=4)
    finally:
        torch.set_num_threads(threads)
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == {"metric", "value", "unit", "total_env_steps",
                         "wall_s", "learner_only_gap_note"}
    assert line["metric"] == "impala_e2e_env_steps_per_sec"
    assert line["value"] > 0 and line["total_env_steps"] > 0
    child = json.loads(captured.err.strip().splitlines()[-1])
    phases = child["vtrace_learner"]["phases"]
    assert {"env_wait", "act", "host_sync", "fwd_bwd"} <= set(phases)
    assert child["envpool_worker_deaths"] == 0


def test_bench_on_a_dp_world_of_two_cpu_ranks_prints_one_line(capsys):
    """bench.py's multi-chip branch: B a rank, split over a world of two
    CPU ranks, the rate divided by them."""
    line = bench_torch.main(batch=1, iters=1, devices=["cpu", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert set(line) == KEYS | {"chips"} and line["chips"] == 2
    assert line["metric"] == "impala_train_env_steps_per_sec_per_chip"
    assert line["value"] > 0 and line["model_tflops_per_sec_per_chip"] > 0
    assert line["device_kind"] == "cpu" and line["mfu"] is None


_PROBE_CHILD = r"""
import json, sys
from moolib_tpu_torch.utils import benchmark
if sys.argv[1] == "hang":
    benchmark._PROBE_CODE = "import time; time.sleep(60)"
    benchmark._PROBE_MIN_TIMEOUT = 1.0
    benchmark.wait_for_device("m", probe_interval=2.0)
    print("not reached")
elif sys.argv[1] == "watchdog":
    benchmark.install_watchdog("m", default_seconds=0.5)
    import time; time.sleep(30)
    print("not reached")
else:
    print(json.dumps(benchmark.wait_for_device("m")))
"""


def _probe_child(mode, **env):
    import os
    import subprocess
    import sys
    from pathlib import Path

    return subprocess.run(
        [sys.executable, "-c", _PROBE_CHILD, mode],
        cwd=str(Path(__file__).resolve().parent.parent), capture_output=True,
        text=True, timeout=120, env={**os.environ, **env})


def test_wait_for_device_returns_what_the_probe_child_counted():
    proc = _probe_child("ok")
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["attempts"] == 1 and got["waited_s"] >= 0
    want = torch.cuda.device_count()
    assert got["n_devices"] == want
    assert got["platform"] == ("cuda" if want else "cpu")


def test_wait_for_device_gives_up_with_a_null_line_and_exit_3():
    """A probe child that hangs is killed at its timeout; with the budget
    spent (0: one probe) the run prints the null-value line and exits 3."""
    proc = _probe_child("hang", MOOLIB_BENCH_BUDGET="0")
    assert proc.returncode == 3, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert "not reached" not in lines
    got = json.loads(lines[-1])
    assert got["metric"] == "m" and got["value"] is None
    assert got["attempts"] == 1
    assert "timed out" in got["last_probe_error"]


def test_watchdog_prints_its_json_line_and_exits_3():
    proc = _probe_child("watchdog")
    assert proc.returncode == 3, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["metric"] == "m" and got["value"] is None
    assert "watchdog fired after 0.5s" in got["error"]


def test_watchdog_is_off_at_zero_and_cancels(monkeypatch):
    from moolib_tpu_torch.utils.benchmark import install_watchdog

    monkeypatch.setenv("MOOLIB_BENCH_WATCHDOG", "0")
    assert install_watchdog("m") is None
    monkeypatch.setenv("MOOLIB_BENCH_WATCHDOG", "60")
    timer = install_watchdog("m")
    assert timer.daemon and timer.interval == 60.0
    timer.cancel()
    timer.join(5)
    assert not timer.is_alive()


def test_watchdog_without_a_variable_keeps_its_seconds(monkeypatch):
    """``env_var=None`` (the dp world's start): no variable moves or
    disables it."""
    from moolib_tpu_torch.utils.benchmark import install_watchdog

    monkeypatch.setenv("MOOLIB_BENCH_WATCHDOG", "0")
    timer = install_watchdog("m", default_seconds=42.0, env_var=None)
    assert timer.daemon and timer.interval == 42.0
    timer.cancel()
    timer.join(5)
    assert not timer.is_alive()
