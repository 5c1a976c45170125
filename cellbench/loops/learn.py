"""The learner loop: the experiment's learner step as the port builds
it, timed over a window.

Each step is ``make_grad_step(config=ImpalaConfig(...), stepscope=scope)``
then ``make_apply_step(stepscope=scope)`` on one ``TrainState``; its
metrics start their copy to the host (``stage_host_async``) and are
drained once 64 are pending, keeping the newest, as the experiment's
loop does; then a CUDA event is recorded. The host never waits for a
step. The steps cycle through the mix's ring of batches.

Set-up makes the weights and batches from the seed, builds the one
learner, and drives it through ``CHECK_STEPS`` steps on three distinct
batches: they warm every shape the window uses, and what they produce
is what the comparison judges. The window then runs on the same object
for ``seconds`` and closes when the last step's metrics have landed.
"""

import gc
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import check, generate, reference, seeds, tracing
from ..flops.peaks import card_peaks
from ..reference.step import run_steps

CHECK_STEPS = 3
DRAIN_AT = 64
LOOP = "cellbench_learner"


class _HostEvent:
    """A CUDA event's interface on the host clock, for CPU runs."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3

    def synchronize(self):
        pass


def _event(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
    else:
        ev = _HostEvent()
    ev.record()
    return ev


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Record:
    """What a metric's reader reads of one run."""

    config: dict
    mix: dict
    device_name: str
    setup_s: float = 0.0
    steps: int = 0
    window_s: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    #: Mean host ms a window step in each StepScope phase.
    phase_ms: Dict[str, float] = field(default_factory=dict)
    #: The ring index of each window step, and of each traced step.
    window_batches: List[int] = field(default_factory=list)
    trace_batches: List[int] = field(default_factory=list)
    #: Each ring batch's sizes for the counts in ``flops/``.
    shapes: List[dict] = field(default_factory=list)
    #: The global gradient norm of each checked step, as the program
    #: reported it (the clip fires above the optimizer's ``max_norm``).
    grad_norms: List[float] = field(default_factory=list)
    trace: Optional[tracing.Trace] = None
    peaks: Optional[dict] = None

    @property
    def env_steps_per_step(self) -> int:
        return self.mix["unroll"] * self.mix["batch"]


class Learner:
    """The system under test: one learner of the program and its step."""

    def __init__(self, cell, weights: dict, device):
        from moolib_tpu_torch import (ClippedAdam, ImpalaConfig,
                                      make_apply_step, make_grad_step,
                                      make_train_state)
        from moolib_tpu_torch.telemetry import StepScope, Telemetry
        from moolib_tpu_torch.utils import stage_host_async

        cfg = cell.config
        model = cell.family().build(cfg, device)
        named = dict(model.named_parameters())
        if sorted(named) != sorted(weights):
            odd = sorted(set(named) ^ set(weights))
            raise ValueError(f"the program's parameters are not the "
                             f"reference's: {odd}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(weights[name])
        opt = cfg["optimizer"]
        self.b1 = opt["b1"]
        optimizer = ClippedAdam(model.parameters(), opt["lr"], b1=opt["b1"],
                                b2=opt["b2"], eps=opt["eps"],
                                eps_root=opt["eps_root"],
                                max_norm=opt["max_norm"])
        loss = dict(cfg["loss"])
        loss["lambda_"] = loss.pop("lambda")
        self.scope = StepScope(LOOP, telemetry=Telemetry("cellbench",
                                                         enabled=True))
        self.grad_step = make_grad_step(config=ImpalaConfig(**loss),
                                        stepscope=self.scope)
        self.apply_step = make_apply_step(stepscope=self.scope)
        self.state = make_train_state(model, optimizer)
        self.stage = stage_host_async
        self.device = device
        self.max_norm = opt["max_norm"]
        self.pending: list = []
        self.losses: List[float] = []
        #: Every metric of the first steps drained, on the host.
        self.first_metrics: List[dict] = []

    def step(self, batch: dict):
        """One learner step; returns the event recorded after it."""
        span = torch.profiler.record_function
        with self.scope.step():
            with span("fwd_bwd"):
                grads, metrics = self.grad_step(self.state.model, batch)
            with span("optimizer"):
                self.state = self.apply_step(self.state, grads)
            with span("stage_metrics"):
                self.pending.append(self.stage(metrics))
            if len(self.pending) >= DRAIN_AT:
                with span("drain_metrics"), self.scope.phase("host_sync"):
                    self.drain(keep_last=1)
        return _event(self.device)

    def drain(self, keep_last: int = 0) -> None:
        while len(self.pending) > keep_last:
            m = {k: float(v.result() if hasattr(v, "result") else v)
                 for k, v in self.pending.pop(0).items()}
            if len(self.first_metrics) < CHECK_STEPS:
                self.first_metrics.append(m)
            self.losses.append(m["total_loss"])

    def named(self):
        return dict(self.state.model.named_parameters())

    def first_moments(self) -> dict:
        """Adam's first moment of every parameter, f32 (zeros where the
        optimizer keeps none)."""
        opt = self.state.optimizer
        out = {}
        for n, p in self.named().items():
            mu = opt.state.get(p, {}).get("mu")
            out[n] = (torch.zeros_like(p) if mu is None else mu).detach() \
                .float().clone()
        return out

    def phase_seconds(self) -> Dict[str, float]:
        return dict(self.scope.summary()["phases"])


def prepare(cell, seed: int, device):
    """The run's inputs, made from the seed: (weights, batches, shapes)."""
    cfg, mix = cell.config, cell.traffic
    ref = reference.for_family(cfg["family"])
    weights = seeds.make_weights(ref.param_specs(cfg), seed, device)
    batches = generate.make_batches(cfg, mix, seed, device)
    shapes = [cell.family().shapes(cfg, mix, b["done"].cpu().numpy())
              for b in batches]
    for b in batches:
        b["core_state"] = ()
    return weights, batches, shapes


def check_steps(learner, weights: dict, batches) -> dict:
    """Drive the learner through its first ``CHECK_STEPS`` steps on
    distinct batches; returns what the comparison reads of them."""
    moments = []
    for k in range(CHECK_STEPS):
        learner.step(batches[k % len(batches)])
        moments.append(learner.first_moments())
    # The first step's clipped gradient as the optimizer took it.
    program = {"moments": moments,
               "grad1": check.taken_grads(moments[:1], learner.b1)[0]}
    named = learner.named()
    program["delta"] = {n: named[n].detach().float() - weights[n]
                        for n in named}
    learner.drain()
    program["losses"] = learner.losses[:CHECK_STEPS]
    program["grad_norms"] = [m["grad_norm"] for m in learner.first_metrics]
    # The clip the first step applied, from the norm the program reported.
    program["clip1"] = min(1.0, learner.max_norm
                           / learner.first_metrics[0]["grad_norm"])
    learner.losses = []
    return program


def reference_numbers(cfg, weights, batches, program, detail=None,
                      unchanged=None) -> dict:
    """The compared numbers of ``program``'s readings against the
    reference's steps from the same weights and batches (``detail``, a
    dict, receives what lies under them; ``unchanged``, a dict, the
    numbers a state left unchanged would give)."""
    ref = run_steps(cfg, weights, batches[:CHECK_STEPS])
    if detail is not None:
        detail.update(check.detail(program, ref))
    if unchanged is not None:
        unchanged.update(check.numbers(check.unchanged(program), ref, cfg))
    return check.numbers(program, ref, cfg)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        learner_hook=None):
    """Set up, measure, trace and check one run of a learner cell.
    Returns (record, numbers, memory_peak_bytes). ``learner_hook`` gets
    the built learner before its first step (tests plant faults there)."""
    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rec = Record(config=cfg, mix=mix, device_name=name,
                 peaks=card_peaks(name) if device.type == "cuda" else None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    weights, batches, rec.shapes = prepare(cell, seed, device)
    learner = Learner(cell, weights, device)
    if learner_hook is not None:
        learner_hook(learner)
    program = check_steps(learner, weights, batches)
    rec.grad_norms = program["grad_norms"]
    _sync(device)

    # The window.
    ring = len(batches)
    before = learner.phase_seconds()
    events = [_event(device)]
    rec.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    i = CHECK_STEPS
    while True:
        rec.window_batches.append(i % ring)
        events.append(learner.step(batches[i % ring]))
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    learner.drain()
    events[-1].synchronize()
    rec.window_s = time.perf_counter() - start
    rec.steps = len(events) - 1
    rec.step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    after = learner.phase_seconds()
    rec.phase_ms = {k: (v - before.get(k, 0.0)) * 1e3 / rec.steps
                    for k, v in after.items()}

    if trace:
        rec.trace_batches = [(i + k) % ring
                             for k in range(mix["trace_steps"])]
        rec.trace = _traced_steps(learner, batches, rec.trace_batches,
                                  device)
    losses = learner.losses

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    del learner, events
    free(device)
    found = reference_numbers(cfg, weights, batches, program)
    found["nonfinite_losses"] = sum(not math.isfinite(x) for x in losses)
    return rec, found, memory_peak


def _traced_steps(learner, batches, order, device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        for k in order:
            learner.step(batches[k])
        learner.drain()
        _sync(device)
    return tracing.reduce(prof, len(order))


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive)."""
    return statistics.quantiles(values, n=20)[18]
