"""The port's benchmark tools on the CPU: ``time_chained``'s protocol,
``find_batch_size`` (against the reference's sweep on one fake clock),
``attention_flops`` and the roofline's per-layer numbers against the
reference's, and small runs of ``attn_bench``, ``perf_sweep``,
``envpool_bench``, ``chip_session --rehearse`` and ``telemetry_smoke``'s
checks. No test holds a wall-clock budget."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test processes run side by side: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- time_chained -------------------------------------------------------------


def test_time_chained_protocol():
    from moolib_tpu_torch.utils.benchmark import time_chained

    calls = []

    def step(c):
        calls.append(1)
        a, b = c
        return (a * 1.000001 + 1e-7, b + a.sum())  # b depends on a

    carry = (torch.ones((8, 8)), torch.zeros(()))
    out, dt, first_s = time_chained(step, carry, iters=5)
    assert dt > 0 and first_s > 0
    # The first call and the timed run, each iters data-dependent
    # applications on the previous one's result.
    assert len(calls) == 10
    want = torch.ones((8, 8))
    b = torch.zeros(())
    for _ in range(10):
        want, b = want * 1.000001 + 1e-7, b + want.sum()
    torch.testing.assert_close(out[0], want)
    torch.testing.assert_close(out[1], b)


def test_time_chained_raises_on_a_non_finite_carry():
    from moolib_tpu_torch.utils.benchmark import time_chained

    with pytest.raises(RuntimeError, match="not finite"):
        time_chained(lambda c: c * float("inf"), torch.ones(3), iters=2)


def test_time_chained_takes_a_warmup_a_fingerprint_and_a_trace(tmp_path):
    """time_train_step's form of the protocol: its own warm-up count, a
    fingerprint of a carry with no tensor leaf, and a trace of the timed
    applications only."""
    from moolib_tpu_torch.utils.benchmark import time_chained

    class Box:
        def __init__(self, x):
            self.x = x

    reads = []

    def fingerprint(box):
        reads.append(box.x.clone())
        return float(box.x.sum())

    trace = tmp_path / "sub" / "chained.json"
    out, dt, warm_s = time_chained(
        lambda b: Box(b.x + 1.0), Box(torch.zeros(2)), 3, warmup=1,
        fingerprint=fingerprint, device=torch.device("cpu"),
        trace_path=str(trace))
    assert dt > 0 and warm_s > 0
    # One warm-up application, then three timed; one read after each span.
    torch.testing.assert_close(out.x, torch.full((2,), 4.0))
    assert [float(r[0]) for r in reads] == [1.0, 4.0]
    assert json.loads(trace.read_text())


# -- find_batch_size -----------------------------------------------------------


class _FakeClock:
    """perf_counter for both finders: a call of the fake step advances it
    by a latency model, so the sweep's decisions are exact."""

    def __init__(self, overhead=1e-3, per_item=1e-5, cap=None):
        self.now = 0.0
        self.overhead, self.per_item, self.cap = overhead, per_item, cap

    def perf_counter(self):
        return self.now

    def step(self, bs):
        items = bs if self.cap is None else max(bs, self.cap)
        self.now += self.overhead + self.per_item * items


@pytest.mark.parametrize("model", [
    dict(overhead=1e-3, per_item=1e-5),          # saturates past ~100
    dict(overhead=0.0, per_item=1e-5, cap=64),   # flat below 64
    dict(overhead=5e-3, per_item=1e-7),          # never flattens
])
@pytest.mark.parametrize("max_latency", [None, 2e-3])
def test_find_batch_size_sweeps_like_the_reference(monkeypatch, model,
                                                   max_latency):
    from moolib_tpu.ops import batchsizefinder as ref_bsf
    from moolib_tpu_torch.ops import batchsizefinder as port_bsf

    results = {}
    for name, mod in (("ref", ref_bsf), ("port", port_bsf)):
        clock = _FakeClock(**model)
        monkeypatch.setattr(mod, "time", clock)

        def fn(x):
            clock.step(x.shape[0])
            return x[:1]

        try:
            best, ms = mod.find_batch_size(
                fn, lambda bs: (np.ones((bs, 4), np.float32),),
                min_batch_size=1, max_batch_size=4096,
                max_latency=max_latency, warmup=1, iters=2)
            results[name] = (best, [tuple(m) for m in ms])
        except ValueError as e:
            results[name] = str(e)
    assert results["port"] == results["ref"]


def test_find_batch_size_saturating_on_torch():
    from moolib_tpu_torch.ops.batchsizefinder import find_batch_size

    calls = []

    def make_inputs(bs):
        calls.append(bs)
        return (torch.ones((bs, 64)),)

    best, ms = find_batch_size(
        lambda x: (x * 2.0).sum(dim=-1), make_inputs, min_batch_size=1,
        max_batch_size=1 << 12, gain_threshold=1.3, iters=3)
    assert best >= 1
    assert [m.batch_size for m in ms] == calls
    assert all(ms[i].batch_size * 2 == ms[i + 1].batch_size
               for i in range(len(ms) - 1))
    assert all(m.throughput == m.batch_size / m.latency for m in ms)


def test_find_batch_size_impossible_budget():
    from moolib_tpu_torch.ops.batchsizefinder import find_batch_size

    with pytest.raises(ValueError, match="exceeds"):
        find_batch_size(lambda x: x + 1, lambda bs: (torch.ones((bs,)),),
                        max_latency=1e-12, iters=1, warmup=1)
    with pytest.raises(ValueError):
        find_batch_size(lambda x: x, lambda bs: (torch.ones(bs),),
                        min_batch_size=8, max_batch_size=4)


# -- analytic FLOPs and bytes --------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 8, 2048, 128), (1, 8, 8192, 128),
                                   (2, 4, 300, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_flops_equal_the_references(shape, causal):
    from moolib_tpu_torch.tools.attn_bench import attention_flops

    ref = _reference_tool("attn_bench")
    assert attention_flops(*shape, causal=causal) == ref.attention_flops(
        *shape, causal=causal)


def test_roofline_layers_equal_the_references():
    """The same per-layer useful FLOPs, implicit-GEMM K and N and bf16
    activation bytes as the reference's walk, and the same step FLOPs
    and activation traffic; only the card's figures differ."""
    from moolib_tpu.utils import flops as ref_flops
    from moolib_tpu_torch.tools import roofline

    ref = _reference_tool("roofline")
    a = roofline.analyze(256, 20)
    ref_rows = list(ref_flops.impala_layer_walk())
    assert a["rows"] == ref_rows
    frames = 21 * 256
    tot = sum(r[1] for r in ref_rows)
    assert a["train_flops"] == (ref_flops.TRAIN_FLOPS_MULTIPLIER
                                * frames * tot)
    assert a["traffic_bytes"] == 4 * frames * sum(
        r[4] * ref.BF16 for r in ref_rows)
    assert roofline.BF16 == ref.BF16
    # The tile model: the reference's MXU padding at 128, ours at the
    # tensor cores' granularity.
    for _, _, k, n, _ in ref_rows:
        assert roofline.tile_eff(k, n, 128, 128) == pytest.approx(
            ref.tile_eff(k, n))
    assert 0 < a["attainable_mfu"] <= a["tile_ceiling"] <= 1


def test_roofline_prints_the_measured_mfu(capsys):
    from moolib_tpu_torch.tools import roofline

    assert roofline.main([]) == 0
    out = capsys.readouterr().out
    assert "attainable MFU" in out and "measured 2.18%" in out


# -- the tools, small, on the CPU ----------------------------------------------


def test_attn_bench_quick_on_the_cpu(tmp_path):
    from moolib_tpu_torch.tools import attn_bench

    out = tmp_path / "attn.json"
    assert attn_bench.main(["--quick", "--device", "cpu", "--json",
                            str(out)]) == 0
    art = json.loads(out.read_text())
    v = art["flash_validation"]
    assert v["ok"] and v["max_err_fwd"] < v["tol_fwd"] == 2e-2
    assert v["max_err_bwd"] < v["tol_bwd"] == 1.0
    timed = {r["backend"]: r for r in art["rows"] if "ms_per_step" in r}
    assert set(timed) == {"dense", "blockwise", "flash"}
    assert all(r["steps_per_sec"] > 0 and r["D"] == 64
               for r in timed.values())
    assert [r for r in art["rows"] if r.get("backend") == "zigzag"][0][
        "note"].startswith("skipped")
    assert art["dtype"] == "float32"


def test_perf_sweep_one_config_on_the_cpu(tmp_path, monkeypatch):
    from moolib_tpu_torch.bench import load_trends
    from moolib_tpu_torch.tools import perf_sweep

    trends = tmp_path / "trends.jsonl"
    monkeypatch.setenv("MOOLIB_TRENDS", str(trends))
    row = perf_sweep.run_config(2, "f32", iters=1, device="cpu")
    assert row["env_steps_per_sec"] > 0 and row["mfu"] is None
    assert perf_sweep.main(["B=2,dtype=f32", "--device", "cpu"]) == 0
    (r,) = load_trends(str(trends))
    assert r.metric == "sweep_B2_f32_s2d1_mxu0_env_steps_per_sec"
    assert r.suite == "device"


def test_envpool_bench_tiny():
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.envpool_bench",
         "--config", "1,4", "--batches", "10"],
        capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["p1_b4"]["env_steps_per_sec"] > 0


def test_chip_session_rehearse_writes_every_artifact(tmp_path):
    env = dict(os.environ)
    env.pop("MOOLIB_TRENDS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.chip_session",
         "--rehearse", "--round", "99", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=str(REPO), timeout=900, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    for kind in ("PERF", "SWEEP", "ATTN", "E2E", "CHIP_SESSION"):
        assert (tmp_path / f"{kind}_r99.json").exists(), kind
    log = json.loads((tmp_path / "CHIP_SESSION_r99.json").read_text())
    assert [s["stage"] for s in log["stages"]] == [
        "bench", "perf_sweep", "attn_bench", "bench_e2e"]
    assert all(s["rc"] == 0 for s in log["stages"])
    from moolib_tpu_torch.bench import load_trends

    metrics = {r.metric for r in load_trends(str(tmp_path / "trends.jsonl"))}
    assert "impala_train_env_steps_per_sec_per_chip" in metrics
    assert "impala_e2e_env_steps_per_sec" in metrics
    assert any(m.startswith("sweep_") for m in metrics), metrics
    assert any(m.startswith("attn_") for m in metrics), metrics


def test_telemetry_smoke_scrape_and_trace_checks():
    from moolib_tpu_torch.tools import telemetry_smoke

    per_call = telemetry_smoke.check_scrape(20)
    assert per_call > 0
    telemetry_smoke.check_flightrec_disabled_cleanliness(calls=5)
    assert telemetry_smoke.measure_gate_ns(20_000) >= 0.0
