"""The program's own spans in a device trace: the device time and the
work items each ``stepscope.*`` range of the program
(``moolib_tpu_torch/telemetry/stepscope.py``) launches.

A device work item goes to the innermost ``stepscope.*`` range whose
host interval holds the start of the runtime call that launched it,
whatever thread made the call: the autograd engine's device thread
launches the backward's kernels while the caller sits in
``stepscope.backward``. An item and its runtime call carry the same pair
of ids in ``torch.profiler``'s events: the call's own correlation id,
and the id of the operator both link to (``linked_correlation_id``).
Items with no such range, or launched outside any operator, are
``unattributed``.

The run's own traced steps (``tracing.py``) keep only the harness's
spans, so the readers of these numbers trace steps of their own once
the run is over: a learner of the run's configuration and mix, built as
the run's (``loops/learn.py``), takes ``WARM_STEPS`` steps and then the
mix's ``trace_steps`` under the profiler. A program without the ranges
gives nothing.
"""

from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Tuple

from cellbench.lookup import Cell
from cellbench.tracing import Trace

PREFIX = "stepscope."
UNATTRIBUTED = "unattributed"
#: Steps on distinct ring batches before the traced ones (the first
#: step of a learner sets up cuDNN's and cuBLAS's plans).
WARM_STEPS = 3
#: The seed of the traced learner's weights and batches: the attribution
#: reads shapes and launches, not values.
SEED = 2 ** 31 + 22


@dataclass
class Attribution:
    steps: int
    #: (name, start_ns, end_ns, launch start_ns or None) of every device
    #: work item.
    device: List[Tuple[str, int, int, Optional[int]]] = \
        field(default_factory=list)
    #: (range name, start_ns, end_ns) of the program's host ranges.
    ranges: List[Tuple[str, int, int]] = field(default_factory=list)

    def range_at(self, t: Optional[int]) -> str:
        """The innermost range whose interval holds ``t``."""
        inner = [(r1 - r0, n) for n, r0, r1 in self.ranges
                 if t is not None and r0 <= t < r1]
        return min(inner)[1] if inner else UNATTRIBUTED

    @cached_property
    def per_step(self) -> Dict[str, Tuple[float, float]]:
        """Range name -> (device seconds, work items) a traced step."""
        out: Dict[str, Tuple[float, float]] = {}
        for _, t0, t1, launch in self.device:
            name = self.range_at(launch)
            s, k = out.get(name, (0.0, 0))
            out[name] = (s + (t1 - t0) * 1e-9, k + 1)
        return {n: (s / self.steps, k / self.steps)
                for n, (s, k) in out.items()}

    def busy_s(self) -> float:
        """The union of the device items' intervals, a traced step."""
        if not self.device:
            return 0.0
        trace = Trace(self.steps, device=[d[:3] for d in self.device])
        return trace.busy_and_gaps()[0] / self.steps


def reduce(events, steps: int) -> Attribution:
    """``events``: ``prof.profiler.kineto_results.events()``."""
    from torch.autograd import DeviceType

    out = Attribution(steps)
    launched: Dict[Tuple[int, int], int] = {}
    items = []
    for e in events:
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # Host ranges are also drawn on the device's timeline as
            # annotations; they are not work.
            if not e.is_user_annotation():
                items.append((e.name(), t0, t1, (e.correlation_id(),
                                                 e.linked_correlation_id())))
        elif e.name().startswith(PREFIX):
            out.ranges.append((e.name(), t0, t1))
        elif e.linked_correlation_id():
            # A runtime call made inside an operator.
            launched[(e.correlation_id(), e.linked_correlation_id())] = t0
    out.device = [(n, t0, t1, launched.get(ids) if ids[1] else None)
                  for n, t0, t1, ids in items]
    return out


class _RunCell(Cell):
    """The run's configuration and mix, as ``loops/learn.py`` reads a
    cell."""

    def __init__(self, config: dict, traffic: dict):
        self.config, self.traffic = config, traffic


def trace_program(config: dict, mix: dict, device) -> Attribution:
    """A learner of ``config`` and ``mix`` on ``device``: ``WARM_STEPS``
    steps, then ``mix["trace_steps"]`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cellbench.loops import learn

    device = torch.device(device)
    cell = _RunCell(config, mix)
    weights, batches, _ = learn.prepare(cell, SEED, device)
    learner = learn.Learner(cell, weights, device)
    steps = mix["trace_steps"]
    order = [k % len(batches) for k in range(WARM_STEPS + steps)]
    for k in order[:WARM_STEPS]:
        learner.step(batches[k])
    learner.drain()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    learn._sync(device)
    with profile(activities=activities) as prof:
        for k in order[WARM_STEPS:]:
            learner.step(batches[k])
        learner.drain()
        learn._sync(device)
    out = reduce(prof.profiler.kineto_results.events(), steps)
    del learner, weights, batches, prof
    learn.free(device)
    return out


def of_run(r) -> Optional[Attribution]:
    """The program's spans over steps traced for a traced run's record
    ``r`` (measured once a record); None for an untraced run, where the
    program opens no ``stepscope.*`` range, or where no device work was
    traced."""
    if r.trace is None:
        return None
    if not hasattr(r, "program_spans"):
        device = "cpu" if r.device_name == "cpu" else "cuda:0"
        got = trace_program(r.config, r.mix, device)
        r.program_spans = got if got.ranges and got.device else None
    return r.program_spans


def device_ms(r, name: str) -> Optional[float]:
    """Device ms a traced step attributed to ``stepscope.<name>``."""
    got = of_run(r)
    if got is None:
        return None
    return got.per_step.get(PREFIX + name, (0.0, 0))[0] * 1e3


def launches(r, name: str) -> Optional[float]:
    """Device work items a traced step attributed to
    ``stepscope.<name>``."""
    got = of_run(r)
    if got is None:
        return None
    return got.per_step.get(PREFIX + name, (0.0, 0))[1]
