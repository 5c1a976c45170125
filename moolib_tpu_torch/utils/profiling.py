"""Profiler capture on :mod:`torch.profiler`: the counterpart of
:mod:`moolib_tpu.utils.profiling`. ``profile_trace`` captures a with-block,
``StepWindowProfiler`` a training loop's step window.

A capture window records the host's operators and, on the card, its
CUDA kernels and memory copies, and is written as a Chrome trace
(``trace.json`` in the given directory; open it in Perfetto or
``chrome://tracing``). Every window is also recorded as a span on the
:mod:`moolib_tpu_torch.telemetry` trace buffer (category ``profiler``,
with the logdir and the step-phase composition at the window's close),
so a telemetry dump shows where the capture sat beside the RPC spans.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

__all__ = ["profile_trace", "StepWindowProfiler"]

TRACE_FILE = "trace.json"


def _record_window(logdir: str, wall0: float, args: Optional[dict] = None):
    """Mark a finished capture window on the shared telemetry timeline.
    Unconditional (capture is rare and deliberate — no hot-path gate)."""
    from ..telemetry import global_telemetry, summarize_stepscope

    span_args = {"logdir": logdir}
    if args:
        span_args.update(args)
    tel = global_telemetry()
    stepscope = summarize_stepscope(tel.snapshot())
    if stepscope:
        span_args["stepscope"] = {
            loop: {"steps": s["steps"], **s["fractions"]}
            for loop, s in stepscope.items()
        }
    tel.traces.add_span(
        "torch_profiler_capture", "profiler", pid="profiler",
        ts_us=int(wall0 * 1e6), dur_us=int((time.time() - wall0) * 1e6),
        args=span_args,
    )


def _start(logdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop(prof, logdir: str) -> None:
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into ``logdir`` (``TRACE_FILE``, a
    Chrome trace) for the duration of the with-block: the host's
    operators always, the card's kernels and copies when the process has
    a card."""
    wall0 = time.time()
    prof = _start(logdir)
    try:
        yield
    finally:
        _stop(prof, logdir)
        _record_window(logdir, wall0)


class StepWindowProfiler:
    """Capture steps [start, stop) of a training loop.

    >>> prof = StepWindowProfiler(logdir, start=10, stop=13)
    >>> for step in range(n):
    ...     prof.step(step)   # starts/stops the capture at the window edges
    ...     train_step(...)
    >>> prof.close()          # safety: stop if the loop exited early

    Skipping the first steps keeps warm-up (the kernels' first builds,
    the allocators' first blocks) out of the steady-state timeline.
    """

    def __init__(self, logdir: Optional[str], start: int = 10, stop: int = 13):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None
        self._wall0 = 0.0

    def step(self, step_index: int) -> None:
        if self.logdir is None:
            return
        if self._prof is None and self.start <= step_index < self.stop:
            self._wall0 = time.time()
            self._prof = _start(self.logdir)
        elif self._prof is not None and step_index >= self.stop:
            _stop(self._prof, self.logdir)
            self._prof = None
            _record_window(self.logdir, self._wall0,
                           {"start_step": self.start, "stop_step": self.stop})

    def close(self) -> None:
        if self._prof is not None:
            _stop(self._prof, self.logdir)
            self._prof = None
            _record_window(self.logdir, self._wall0,
                           {"start_step": self.start, "closed_early": True})
