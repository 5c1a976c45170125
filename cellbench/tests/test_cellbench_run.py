"""The command's shape: no result without a card or without the
program, the result line's keys in order, and the reduction of a trace."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cellbench import tracing
from cellbench.loops.learn import Record, p95
from cellbench.lookup import Cell, reader
from cellbench.tests.pending import PendingCell

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "impala_learn_b256", "--seed", str(2 ** 33 + 1),
        "--seconds", "1", "--trace", "0"]


def _card():
    import torch

    return torch.cuda.is_available()


def test_without_a_card_it_prints_no_result_and_fails():
    if _card():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "cellbench/run.py", *ARGS],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "cellbench/run.py", *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


def _record(trace=None, cell=None):
    cell = cell or PendingCell()
    rec = Record(config=cell.config, mix=cell.traffic, device_name="x",
                 peaks={"bf16": 989e12, "f32": 165e12,
                        "hbm_bytes_per_s": 3.35e12})
    rec.setup_s, rec.steps, rec.window_s = 10.0, 40, 2.0
    rec.step_ms = [50.0] * 38 + [60.0, 70.0]
    rec.window_batches = [0, 1] * 20
    rec.shapes = [{"frames": 2048 * 8, "batch": 8, "pairs": 8_000_000}] * 2
    rec.phase_ms = {"fwd_bwd": 30.0, "optimizer": 5.0}
    rec.trace = trace
    rec.trace_batches = [0, 1]
    return cell, rec


def test_the_result_line_has_its_keys_with_check_last():
    from cellbench import run

    cell, rec = _record(cell=Cell("impala_learn_b256"))
    found = {"nonfinite_losses": 0, "first_loss_gap": 1e-9}
    line, _ = run.result(cell, rec, found, 123, False, "card")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert set(line["metrics"]) == {"learn_env_steps_per_s",
                                    "learn_step_p95_ms", "setup_s"}
    assert line["metrics"]["learn_env_steps_per_s"]["value"] == \
        20 * 256 * 40 / 2.0
    # A limit without its number is not correct.
    assert line["correct"] is False
    assert line["device"]["memory_peak_bytes"] == 123
    json.dumps(line, allow_nan=False)


def test_p95_is_the_tail_of_every_step():
    assert p95(list(range(1, 101))) == pytest.approx(95.95)


def test_a_trace_reduces_to_busy_time_gaps_and_classes():
    tr = tracing.Trace(steps=2)
    tr.device = [("cudnn_convolve_fprop", 0, 100), ("flash_fwd_wgmma_kernel",
                                                    100, 150),
                 ("max_pool_backward_nhwc", 170, 200),
                 ("elementwise", 190, 210)]
    tr.host = [("fwd_bwd", 0, 160), ("optimizer", 160, 300)]
    busy, window, gaps = tr.busy_and_gaps()
    assert busy == pytest.approx(190e-9) and window == pytest.approx(210e-9)
    assert gaps == [(pytest.approx(20e-9), "fwd_bwd")]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["conv forward", pytest.approx(100e-9)]
    assert b["idle_gaps"] == [["fwd_bwd", pytest.approx(20e-9)]]
    cell, rec = _record(tr)
    assert reader("device_idle_share")(rec) == pytest.approx(100 * 20 / 210)
    assert reader("conv_device_ms")(rec) == pytest.approx(100e-9 * 1e3 / 2)
    share = reader("attn_roofline")(rec)
    assert 0 < share


@pytest.mark.parametrize("name", ["conv_device_ms", "attn_roofline",
                                  "pool_roofline", "device_idle_share"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    _, rec = _record(None)
    assert reader(name)(rec) is None
    _, rec = _record(tracing.Trace(steps=1))
    assert reader(name)(rec) is None


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_wgrad_implicit_gemm", "conv weight gradient"),
    ("void cudnn::dgrad_engine", "conv data gradient"),
    ("void flash_bwd_dq_kernel<float>", "flash kernels"),
    ("void at::native::max_pool_backward_nhwc", "max-pool"),
    ("Memcpy DtoH (Device -> Pinned)", "copies and fills"),
    ("void at::native::vectorized_elementwise_kernel",
     "elementwise and other"),
])
def test_kernel_classes(name, cls):
    assert tracing.kernel_class(name) == cls
