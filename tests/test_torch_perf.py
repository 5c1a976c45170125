"""The port's perfwatch plane against the reference's
(``moolib_tpu.bench``, ``tools/perf.py``): the harness statistics, the
row schema across packages, the regression detector and the budgets on
the planted histories of ``tests/test_perf.py``, the suite's catalogue,
the ``perf`` CLI's gates, and the fast suite rows on the CPU.
"""

import ast
import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from moolib_tpu import bench as ref
from moolib_tpu.bench import budgets as ref_budgets
from moolib_tpu.telemetry import stepscope as ref_stepscope
from moolib_tpu_torch import bench as port
from moolib_tpu_torch.bench import budgets as port_budgets
from moolib_tpu_torch.bench.suite import CPU_PROXY_SUITE, ROWS
from moolib_tpu_torch.telemetry import stepscope as port_stepscope

REPO = Path(__file__).resolve().parent.parent
PERF = [sys.executable, "-m", "moolib_tpu_torch.tools.perf"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The test processes run side by side: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- harness ------------------------------------------------------------------


@pytest.mark.parametrize("samples,trim", [
    ([1.0] * 9 + [100.0], 0.2),
    ([0.3, 0.1, 0.2], 0.0),
    ([5.0], 0.5),
    ([float(i) ** 1.5 for i in range(37)], 0.25),
])
def test_trimmed_stats_equal_the_references(samples, trim):
    assert port.trimmed_stats(samples, trim) == ref.trimmed_stats(
        samples, trim)


def test_trimmed_stats_rejects_what_the_reference_rejects():
    for bad in (([], 0.2), ([1.0], 1.0), ([1.0], -0.1)):
        with pytest.raises(ValueError):
            ref.trimmed_stats(*bad)
        with pytest.raises(ValueError):
            port.trimmed_stats(*bad)


def _planted(pkg, values, metric="proxy_gbps", direction="higher",
             tol=None):
    return [
        pkg.BenchResult(metric=metric, value=v, unit="GB/s",
                        direction=direction, suite="cpu-proxy", smoke=True,
                        tol=tol, t=1.0 + i, env={"host": "fixture"},
                        cmd=f"python -m moolib_tpu_torch.tools.perf "
                            f"--suite cpu-proxy --only {metric} --smoke")
        for i, v in enumerate(values)
    ]


def test_a_planted_row_file_loads_the_same_in_both_packages(tmp_path):
    store = tmp_path / "trends.jsonl"
    rows = _planted(port, [100.0, 101.5, None, 99.0])
    rows[2].error = "fixture null"
    for r in rows:
        port.append_trend(str(store), r)
    got_port = port.load_trends(str(store))
    got_ref = ref.load_trends(str(store))
    assert [r.to_row() for r in got_port] == [r.to_row() for r in rows]
    assert [r.to_row() for r in got_ref] == [r.to_row() for r in rows]


def test_rows_cross_parse_between_the_packages():
    """A row the port writes parses with the reference's parse_result,
    and the reverse, to the same fields."""
    tele = {"x_seconds": {"type": "histogram", "edges": [1.0],
                          "buckets": [2, 2], "sum": 0.4, "count": 2,
                          "p50": 0.5, "p95": 0.9, "p99": 0.99}}
    for src, dst in ((port, ref), (ref, port)):
        r = src.BenchResult(
            metric="rpc_echo_latency_s", value=0.0011, unit="s/call",
            direction="lower", suite="cpu-proxy", smoke=True, tol=0.5,
            stats={"n": 5, "median": 0.0011}, telemetry=tele,
            extra={"note": "fixture"}, cmd="repro")
        assert dst.parse_result(r.to_json()).to_row() == r.to_row()
        assert src.parse_result(r.to_json()) == r


def test_port_rows_carry_the_torch_fingerprint():
    fp = port.env_fingerprint()
    assert {"torch", "cuda", "card", "python", "host"} <= set(fp)
    assert "jax" not in fp
    row = port.BenchResult(metric="m", value=1.0, unit="x")
    assert row.env["torch"] == fp["torch"]


def test_parse_result_rejects_bad_rows_like_the_reference():
    bad = [{"schema": 99, "metric": "m", "value": 1, "unit": "x"},
           {"schema": 1, "metric": "m", "value": 1, "unit": "x",
            "bogus": True},
           {"schema": 1, "metric": "m"}]
    for row in bad:
        with pytest.raises(ValueError) as e_ref:
            ref.parse_result(dict(row))
        with pytest.raises(ValueError) as e_port:
            port.parse_result(dict(row))
        assert str(e_port.value) == str(e_ref.value)


# -- regression detector: the reference's planted histories -------------------


def _verdicts(pkg, values_fn, **kw):
    regs = pkg.detect_regressions(values_fn(pkg), **kw)
    return [dataclasses.asdict(r) for r in regs], [r.message() for r in regs]


def _hist(seed, n=8, sd=0.01, base=100.0):
    rng = random.Random(seed)
    return [base * (1 + rng.gauss(0, sd)) for _ in range(n)]


def _tolerant(values, tol):
    def make(pkg):
        return _planted(pkg, values, tol=tol)
    return make


DETECTOR_CASES = {
    "planted 20% drop": lambda pkg: _planted(pkg, _hist(7) + [80.0]),
    "noise inside the band": lambda pkg: _planted(
        pkg, _hist(3, sd=0.03) + [86.0]),
    "latency rise": lambda pkg: _planted(
        pkg, [1.0, 1.01, 0.99, 1.0, 1.4], "echo_s", "lower"),
    "latency improvement": lambda pkg: _planted(
        pkg, [1.0, 1.01, 0.99, 1.0, 0.5], "echo_s", "lower"),
    "too little history": lambda pkg: _planted(pkg, [100.0, 50.0]),
    "trailing null": lambda pkg: _planted(
        pkg, [100.0, 101.0, 99.0, 100.0]) + [pkg.BenchResult(
            metric="proxy_gbps", value=None, unit="GB/s", suite="cpu-proxy",
            smoke=True, error="fixture null", t=9.0, env={})],
    "noisy history widens the band": lambda pkg: _planted(
        pkg, [100.0, 120.0, 80.0, 115.0, 85.0, 110.0, 90.0, 100.0, 78.0]),
    "declared tol quiet": _tolerant(_hist(9) + [80.0], 0.5),
    "declared tol, structural step": _tolerant(_hist(9) + [45.0], 0.5),
    "smoke and full apart": lambda pkg: _planted(
        pkg, _hist(5) + [70.0]) + [dataclasses.replace(
            r, smoke=False) for r in _planted(pkg, [50.0] * 5)],
    "two series": lambda pkg: _planted(pkg, _hist(1) + [60.0], "a_gbps")
    + _planted(pkg, _hist(2) + [99.0], "b_gbps"),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_detector_verdicts_equal_the_references(case):
    got_ref = _verdicts(ref, DETECTOR_CASES[case])
    got_port = _verdicts(port, DETECTOR_CASES[case])
    assert got_port == got_ref
    expect_flag = case in ("planted 20% drop", "latency rise",
                           "declared tol, structural step",
                           "smoke and full apart", "two series")
    assert bool(got_port[0]) == expect_flag, got_port


@pytest.mark.parametrize("kw", [dict(window=3), dict(min_history=1),
                                dict(tolerance=0.05),
                                dict(noise_sigmas=0.5)])
def test_detector_knobs_equal_the_references(kw):
    def make(pkg):
        return _planted(pkg, _hist(11, n=10, sd=0.04) + [90.0])
    assert _verdicts(port, make, **kw) == _verdicts(ref, make, **kw)


STEPSCOPE_CMD = "python tools/stepscope_report.py --smoke"


def _fraction_rows(pkg_stepscope, values, loop="a2c_learner"):
    rows = []
    for v in values:
        summary = {
            "loop": loop, "steps": 50, "wall_s": 1.0,
            "phases": {"grad_allreduce": v, "other": 1.0 - v},
            "fractions": {"exposed_comms": v, "host_blocked": 0.0,
                          "env_wait": 0.0},
        }
        rows.extend(pkg_stepscope.trend_rows(summary, smoke=True,
                                             cmd=STEPSCOPE_CMD))
    return rows


@pytest.mark.parametrize("values", [
    _hist(20, sd=0.05, base=0.04) + [0.5],
    _hist(21, sd=0.05, base=0.04) + [0.055],
    _hist(21, sd=0.05, base=0.04) + [0.0],
])
def test_detector_on_stepscope_fraction_rows_equals_the_references(values):
    def rows(pkg_stepscope):
        out = _fraction_rows(pkg_stepscope, values)
        for r in out:
            r.t, r.env = 1.0, {}
        return out
    got_ref = [dataclasses.asdict(r) for r in
               ref.detect_regressions(rows(ref_stepscope))]
    got_port = [dataclasses.asdict(r) for r in
                port.detect_regressions(rows(port_stepscope))]
    assert got_port == got_ref


def test_fraction_rows_per_loop_series_never_share_a_baseline():
    rows = (_fraction_rows(port_stepscope, [0.05] * 5, "a2c_learner")
            + _fraction_rows(port_stepscope, [0.9] * 5, "acc_grad_round"))
    assert port.detect_regressions(rows) == []


# -- budgets -------------------------------------------------------------------


def _hist_series(p99):
    return {"type": "histogram", "edges": [1.0], "buckets": [10, 10],
            "sum": 1.0, "count": 10, "p50": p99 / 2, "p95": p99 * 0.9,
            "p99": p99}


def _breaches(pkg, budgets_mod, result_kw, budgets):
    res = pkg.BenchResult(**result_kw)
    b = {k: budgets_mod.Budget(**v) for k, v in budgets.items()}
    return [dataclasses.asdict(x) for x in pkg.evaluate_budgets(res, b)]


QUANTILE = {"m": dict(quantiles=[
    ("rpc_server_handle_seconds", 'endpoint="echo"', {"p99": 0.5})])}
BUDGET_CASES = [
    (dict(metric="m", value=1.0, unit="x", cmd="repro", telemetry={
        'rpc_server_handle_seconds{endpoint="echo"}': _hist_series(0.2)}),
     QUANTILE, 0),
    (dict(metric="m", value=1.0, unit="x", cmd="repro", telemetry={
        'rpc_server_handle_seconds{endpoint="echo"}': _hist_series(0.9)}),
     QUANTILE, 1),
    (dict(metric="m", value=1.0, unit="x", telemetry={
        'rpc_server_handle_seconds_extra{endpoint="echo"}':
            _hist_series(9.9)}), QUANTILE, 0),
    (dict(metric="thr", value=0.5, unit="GB/s"),
     {"thr": dict(value_min=1.0)}, 1),
    (dict(metric="lat", value=0.5, unit="s"),
     {"lat": dict(value_max=0.1)}, 1),
    (dict(metric="thr", value=None, unit="", error="x"),
     {"thr": dict(value_min=1.0)}, 0),
    (dict(metric="e", value=1.0, unit="x",
          extra={"supervision_overhead_frac": 0.2}),
     {"e": dict(extra_max={"supervision_overhead_frac": 0.05})}, 1),
]


@pytest.mark.parametrize("result_kw,budgets,n", BUDGET_CASES)
def test_budget_breaches_equal_the_references(result_kw, budgets, n):
    got_port = _breaches(port, port_budgets, result_kw, budgets)
    assert got_port == _breaches(ref, ref_budgets, result_kw, budgets)
    assert len(got_port) == n


HOST_ROWS = ("rpc_echo_latency_s", "rpc_payload_gbps",
             "rpc_shm_payload_gbps", "allreduce_tree_gbps", "batcher_fill_s",
             "envpool_steps_per_s", "envpool_recovery_s",
             "serial_encode_gbps", "serial_decode_gbps",
             "statestore_replicate_gbps")


def test_host_rows_keep_the_reference_budgets_and_card_rows_have_none():
    assert set(port.CPU_PROXY_BUDGETS) == set(HOST_ROWS)
    for name in HOST_ROWS:
        assert (dataclasses.asdict(port.CPU_PROXY_BUDGETS[name])
                == dataclasses.asdict(ref.CPU_PROXY_BUDGETS[name])), name


@pytest.mark.parametrize("name", HOST_ROWS)
def test_default_budgets_judge_like_the_references(name):
    b = ref.CPU_PROXY_BUDGETS[name]
    for value in (b.value_min, b.value_max):
        if value is None:
            continue
        for v in (value * 0.5, value * 2.0):
            kw = dict(metric=name, value=v, unit="x", cmd="c", env={})
            assert ([dataclasses.asdict(x) for x in port.evaluate_budgets(
                port.BenchResult(**kw))]
                == [dataclasses.asdict(x) for x in ref.evaluate_budgets(
                    ref.BenchResult(**kw))])


# -- the suite's catalogue ---------------------------------------------------


def _reference_rows():
    """(unit, direction) of every row of the reference's suite, read from
    its source: the literals of its ``_result(name, value, unit,
    direction, ...)`` calls."""
    import moolib_tpu.bench.suite as ref_suite

    tree = ast.parse(Path(ref_suite.__file__).read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "_result" and len(node.args) >= 4
                and all(isinstance(a, ast.Constant) for a in
                        (node.args[0], node.args[2], node.args[3]))
                and node.args[2].value):
            out[node.args[0].value] = (node.args[2].value,
                                       node.args[3].value)
    return out


def test_suite_catalogue_equals_the_references():
    from moolib_tpu.bench import suite as ref_suite

    assert list(CPU_PROXY_SUITE) == list(ref_suite.CPU_PROXY_SUITE)
    assert list(ROWS) == list(ref_suite.CPU_PROXY_SUITE)
    assert ROWS == _reference_rows()
    from moolib_tpu_torch.bench import suite as port_suite
    assert port_suite.TREND_TOLERANCE == ref_suite.TREND_TOLERANCE


# -- the perf CLI -------------------------------------------------------------


def _run_perf(args, timeout=180):
    env = dict(os.environ, OMP_NUM_THREADS="1")  # runs beside other tests
    return subprocess.run(PERF + args, capture_output=True, text=True,
                          cwd=str(REPO), timeout=timeout, env=env)


def test_perf_cli_list():
    proc = _run_perf(["--list"])
    assert proc.returncode == 0, proc.stderr
    for name in CPU_PROXY_SUITE:
        assert name in proc.stdout


def test_perf_cli_gate_planted_regression_fails_clean_passes(tmp_path):
    clean = tmp_path / "clean.jsonl"
    history = _hist(11, n=6)
    for r in _planted(port, history + [99.5]):
        port.append_trend(str(clean), r)
    proc = _run_perf(["--check-trends", "--trends", str(clean)])
    assert proc.returncode == 0, proc.stdout + proc.stderr

    planted = tmp_path / "planted.jsonl"
    for r in _planted(port, history + [80.0]):
        port.append_trend(str(planted), r)
    proc = _run_perf(["--check-trends", "--trends", str(planted)])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "REGRESSION proxy_gbps" in proc.stdout
    assert "reproduce: python -m moolib_tpu_torch.tools.perf" in proc.stdout
    proc = _run_perf(["--check-trends", "--trends", str(planted),
                      "--format", "gha"])
    assert proc.returncode == 1
    assert "::error title=perfwatch::" in proc.stdout


def test_perf_cli_check_trends_flags_trailing_nulls(tmp_path):
    trends = tmp_path / "trends.jsonl"
    port.append_trend(str(trends), port.BenchResult(
        metric="impala_train_env_steps_per_sec_per_chip", value=None,
        unit="", suite="device", cmd="python3 bench_torch.py",
        error="fixture: the stage failed"))
    proc = _run_perf(["--check-trends", "--trends", str(trends)])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "NULL impala_train_env_steps_per_sec_per_chip" in proc.stdout
    assert "reproduce: python3 bench_torch.py" in proc.stdout
    port.append_trend(str(trends), port.BenchResult(
        metric="impala_train_env_steps_per_sec_per_chip", value=63000.0,
        unit="env-steps/s/chip", suite="device",
        cmd="python3 bench_torch.py"))
    proc = _run_perf(["--check-trends", "--trends", str(trends)])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_perf_cli_runs_serial_rows_and_ignores_stale_foreign_series(
        tmp_path):
    """The real CLI on the serial rows with --device cpu: exit 0,
    schema-valid rows appended beside a stale regressive series of
    another suite, which only --check-trends flags."""
    trends = tmp_path / "trends.jsonl"
    for r in _planted(port, _hist(13, n=6) + [60.0], metric="device_gbps"):
        port.append_trend(str(trends), r)
    proc = _run_perf([
        "--suite", "cpu-proxy", "--smoke", "--device", "cpu",
        "--only", "serial_encode_gbps,serial_decode_gbps",
        "--trends", str(trends),
    ], timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [r for r in port.load_trends(str(trends))
            if r.metric.startswith("serial")]
    assert [r.metric for r in rows] == ["serial_encode_gbps",
                                       "serial_decode_gbps"]
    assert all(r.value is not None and r.smoke for r in rows)
    assert all(r.cmd.startswith("python -m moolib_tpu_torch.tools.perf")
               and r.cmd.endswith("--device cpu") for r in rows)
    summary = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")][-1]
    assert summary["results"] == 2 and summary["nulls"] == 0
    proc = _run_perf(["--check-trends", "--trends", str(trends)])
    assert proc.returncode == 1
    assert "REGRESSION device_gbps" in proc.stdout


def test_perf_cli_unknown_bench_is_usage_error():
    proc = _run_perf(["--suite", "cpu-proxy", "--only", "nope",
                      "--no-trends", "--device", "cpu"])
    assert proc.returncode == 2
    assert "unknown benchmark" in proc.stderr


# -- the fast rows on the CPU -------------------------------------------------


FAST_ROWS = ["batcher_fill_s", "serial_encode_gbps", "serial_decode_gbps",
             "e2e_learner_step_s", "parity_check_s"]  # the suite's order


def test_fast_rows_run_on_the_cpu_and_give_schema_valid_rows():
    from moolib_tpu_torch.bench.suite import run_suite

    rows = run_suite(smoke=True, only=FAST_ROWS, device="cpu")
    assert [r.metric for r in rows] == FAST_ROWS
    for r in rows:
        assert r.value is not None, (r.metric, r.error)
        assert (r.unit, r.direction) == ROWS[r.metric]
        assert ref.parse_result(r.to_json()).to_row() == r.to_row()
        assert port.evaluate_budgets(r) == []
    e2e = {r.metric: r for r in rows}["e2e_learner_step_s"]
    assert e2e.extra["steady_d2h"] == 0
    assert e2e.extra["compile_delta"] == 0
    assert e2e.extra["batch"] == [4, 4, 5, 3]
    assert {r.metric: r for r in rows}["parity_check_s"].extra[
        "runs_per_check"] == 2


def test_run_suite_without_a_device_needs_the_card():
    import torch

    from moolib_tpu_torch.bench.suite import run_suite

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_suite(smoke=True, only=["serial_encode_gbps"])
    with pytest.raises(ValueError, match="unknown benchmark"):
        run_suite(smoke=True, only=["nope"])
