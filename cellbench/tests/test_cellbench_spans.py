"""The program's spans in a trace (``spans.py``): each device work item
goes to the innermost ``stepscope.*`` range that holds the start of the
runtime call that launched it, matched by its pair of ids; the readers
of the run's own trace read the same with the ranges there; and on the
card the four phases hold the traced steps' device time.

    python3 -m pytest cellbench/tests/test_cellbench_spans.py -m cuda

runs the card's case (it skips without a card)."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from cellbench import spans, tracing
from cellbench.loops.learn import Record
from cellbench.lookup import Cell, reader

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
FIVE = ("forward_device_ms", "loss_device_ms", "backward_device_ms",
        "optimizer_device_ms", "optimizer_launches")


class Ev:
    """One event of ``kineto_results.events()``."""

    def __init__(self, name, dev, t0, t1, corr=0, linked=0,
                 annotation=False):
        self._v = (name, dev, t0, t1 - t0, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _ranges():
    """One step's program ranges, as the learner opens them."""
    return [Ev("stepscope.fwd_bwd", CPU, 0, 600, corr=1, annotation=True),
            Ev("stepscope.loss", CPU, 10, 300, corr=2, annotation=True),
            Ev("stepscope.forward", CPU, 20, 200, corr=3, annotation=True),
            Ev("stepscope.backward", CPU, 300, 600, corr=9,
               annotation=True),
            Ev("stepscope.optimizer", CPU, 600, 700, corr=20,
               annotation=True),
            # Their drawings on the device's timeline are no work.
            Ev("stepscope.forward", CUDA, 1000, 1100, corr=3,
               annotation=True)]


def _work():
    """Operators, their runtime calls and the device items they launch.
    A range's or an operator's own id may equal an unrelated call's (3
    below): only the pair of a call and its operator names a launch."""
    return [
        # The forward's convolution (operator 4, call 40).
        Ev("aten::convolution", CPU, 30, 60, corr=4),
        Ev("cudaLaunchKernel", CPU, 40, 45, corr=40, linked=4),
        Ev("sm90_xmma_fprop_implicit_gemm", CUDA, 1000, 1100, corr=40,
           linked=4),
        # V-trace's loop in the loss, outside the forward (op 5, call 3).
        Ev("aten::mul", CPU, 210, 230, corr=5),
        Ev("cudaLaunchKernel", CPU, 215, 220, corr=3, linked=5),
        Ev("vectorized_elementwise_kernel", CUDA, 1100, 1120, corr=3,
           linked=5),
        # The backward, launched by the autograd engine's own thread
        # while the caller waits in stepscope.backward (op 6, call 60).
        Ev("autograd::engine::evaluate_function", CPU, 400, 500, corr=6),
        Ev("cudaLaunchKernel", CPU, 410, 415, corr=60, linked=6),
        Ev("sm90_xmma_dgrad_implicit_gemm", CUDA, 1120, 1300, corr=60,
           linked=6),
        # The optimizer (op 7, call 70) and the harness's copy of the
        # metrics, launched outside every program range (op 8, call 80).
        Ev("aten::_foreach_add_", CPU, 620, 640, corr=7),
        Ev("cudaLaunchKernel", CPU, 625, 630, corr=70, linked=7),
        Ev("multi_tensor_apply_kernel", CUDA, 1300, 1340, corr=70,
           linked=7),
        Ev("aten::copy_", CPU, 800, 820, corr=8),
        Ev("cudaMemcpyAsync", CPU, 805, 810, corr=80, linked=8),
        Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 1400, 1404, corr=80,
           linked=8),
        # A launch outside any operator has no launch time.
        Ev("cudaLaunchKernel", CPU, 100, 105, corr=90),
        Ev("elementwise_kernel", CUDA, 1404, 1410, corr=90),
    ]


def test_each_item_goes_to_the_innermost_range_of_its_launch():
    got = spans.reduce(_ranges() + _work(), steps=1)
    assert [n for n, *_ in got.ranges] == [
        "stepscope.fwd_bwd", "stepscope.loss", "stepscope.forward",
        "stepscope.backward", "stepscope.optimizer"]
    assert [(n, launch) for n, _, _, launch in got.device] == [
        ("sm90_xmma_fprop_implicit_gemm", 40),
        ("vectorized_elementwise_kernel", 215),
        ("sm90_xmma_dgrad_implicit_gemm", 410),
        ("multi_tensor_apply_kernel", 625),
        ("Memcpy DtoH (Device -> Pinned)", 805),
        ("elementwise_kernel", None)]
    per = got.per_step
    assert per["stepscope.forward"] == (pytest.approx(100e-9), 1)
    assert per["stepscope.loss"] == (pytest.approx(20e-9), 1)
    assert per["stepscope.backward"] == (pytest.approx(180e-9), 1)
    assert per["stepscope.optimizer"] == (pytest.approx(40e-9), 1)
    assert per[spans.UNATTRIBUTED] == (pytest.approx(10e-9), 2)
    assert "stepscope.fwd_bwd" not in per
    assert got.busy_s() == pytest.approx(350e-9)


def test_per_step_divides_by_the_traced_steps():
    got = spans.reduce(_ranges() + _work(), steps=2)
    assert got.per_step["stepscope.backward"] == (pytest.approx(90e-9),
                                                  0.5)
    assert got.busy_s() == pytest.approx(175e-9)


def _fake_prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def _record(trace, cell):
    rec = Record(config=cell.config, mix=cell.traffic, device_name="card",
                 peaks={"bf16": 989e12, "f32": 165e12,
                        "hbm_bytes_per_s": 3.35e12})
    rec.setup_s, rec.steps, rec.window_s = 10.0, 40, 2.0
    rec.window_batches = [0, 1] * 20
    rec.trace_batches = [0, 1]
    rec.shapes = [cell.family().shapes(cell.config, cell.traffic, None)] * 2
    rec.phase_ms = {"fwd_bwd": 30.0, "optimizer": 5.0}
    rec.trace = trace
    return rec


SIX = ("fwd_bwd_dispatch_ms", "optimizer_dispatch_ms", "conv_device_ms",
       "pool_roofline", "device_idle_share", "step_mfu")


def test_the_six_readers_read_the_same_with_the_program_ranges():
    cell = Cell("impala_learn_b256")
    harness = [Ev("fwd_bwd", CPU, 0, 610, annotation=True),
               Ev("optimizer", CPU, 610, 710, annotation=True)]
    pool = Ev("max_pool_backward_nhwc", CUDA, 1500, 1600, corr=95, linked=9)
    plain = harness + _work() + [pool]
    readings = []
    for events in (plain, plain + _ranges()):
        trace = tracing.reduce(_fake_prof(events), steps=2)
        rec = _record(trace, cell)
        readings.append({m: reader(m)(rec) for m in SIX})
    assert readings[0] == readings[1]
    assert all(v is not None for v in readings[0].values()), readings[0]


def test_nothing_is_read_without_a_trace_or_the_programs_ranges(monkeypatch):
    cell = Cell("impala_learn_b256")
    rec = _record(None, cell)
    assert [reader(m)(rec) for m in FIVE] == [None] * 5
    # A program without the ranges (the parent's) gives nothing.
    monkeypatch.setattr(spans, "trace_program",
                        lambda *a: spans.reduce(_work(), steps=1))
    rec = _record(tracing.Trace(steps=1), cell)
    assert [reader(m)(rec) for m in FIVE] == [None] * 5


def test_the_readers_measure_once_a_record(monkeypatch):
    cell = Cell("impala_learn_b256")
    calls = []

    def traced(*args):
        calls.append(args)
        return spans.reduce(_ranges() + _work(), steps=1)

    monkeypatch.setattr(spans, "trace_program", traced)
    rec = _record(tracing.Trace(steps=1), cell)
    got = {m: reader(m)(rec) for m in FIVE}
    assert len(calls) == 1 and calls[0][2] == "cuda:0"
    assert got == {"forward_device_ms": pytest.approx(100e-6),
                   "loss_device_ms": pytest.approx(20e-6),
                   "backward_device_ms": pytest.approx(180e-6),
                   "optimizer_device_ms": pytest.approx(40e-6),
                   "optimizer_launches": 1}


def _nested(inner, outer):
    return any(o0 <= i0 and i1 <= o1 for i0, i1 in inner
               for o0, o1 in outer)


def test_a_cpu_learner_opens_the_programs_ranges_nested():
    """The run's learner at B=2, T=2 on the CPU: the ranges are there,
    nested as the learner opens them (the CPU has no device items)."""
    cell = Cell("impala_learn_b256")
    mix = dict(cell.traffic, unroll=2, batch=2, ring=2, trace_steps=2)
    got = spans.trace_program(cell.config, mix, "cpu")
    by = {}
    for n, t0, t1 in got.ranges:
        by.setdefault(n[len(spans.PREFIX):], []).append((t0, t1))
    assert {k: len(v) for k, v in by.items()} == {
        "fwd_bwd": 2, "loss": 2, "forward": 2, "backward": 2,
        "optimizer": 2}
    for a, b in (("forward", "loss"), ("loss", "fwd_bwd"),
                 ("backward", "fwd_bwd")):
        assert all(_nested([iv], by[b]) for iv in by[a]), (a, b)
    assert not got.device


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_the_four_phases_hold_the_traced_device_time(card):
    cell = Cell("impala_learn_b256")
    rec = _record(tracing.Trace(steps=cell.traffic["trace_steps"]), cell)
    rec.device_name = torch.cuda.get_device_name(card)
    got = {m: reader(m)(rec) for m in FIVE}
    assert all(v is not None and v > 0 for v in got.values()), got
    four = sum(got[m] for m in FIVE[:4])
    assert four >= 0.97 * spans.of_run(rec).busy_s() * 1e3, got
