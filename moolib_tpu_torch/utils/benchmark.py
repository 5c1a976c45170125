"""Timing of train steps for the port's benchmarks: the counterpart of
:func:`moolib_tpu.utils.benchmark.time_train_step`.

The reference chains its steps inside one jit and ends the timed span in
a host readback of a scalar fingerprint of the parameters. In eager
PyTorch the same protocol reads:

1. ``WARMUP_STEPS`` steps first, which cover cuDNN's choice of
   algorithms and the first allocations, then a synchronize;
2. ``iters`` chained steps, each on the state the previous one left,
   between two CUDA events (on the CPU, the host clock);
3. a synchronize and the host readback of the fingerprint, which cannot
   come back before the last step's update has run.

The reference's tunnel guards (``wait_for_device``, ``install_watchdog``)
have no counterpart: the card is local.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["WARMUP_STEPS", "time_train_step"]

WARMUP_STEPS = 2


def _fingerprint(state) -> float:
    """Sum of every parameter, read on the host."""
    return float(sum(p.detach().float().sum() for p in
                     state.model.parameters()))


def time_train_step(
    step: Callable, state, batch, iters: int = 10,
    trace_dir: Optional[str] = None,
) -> Tuple[Any, float, float]:
    """Time ``iters`` chained ``step(state, batch) -> (state, metrics)``
    calls on ``state.model``'s device.

    Returns ``(final_state, timed_seconds, warmup_seconds)``; throughput
    is ``iters * items_per_step / timed_seconds``. With ``trace_dir``, a
    ``torch.profiler`` trace of the timed steps only (not the warm-up) is
    written there as a Chrome trace. Raises ``RuntimeError`` if the
    fingerprint is not finite."""
    from torch.profiler import ProfilerActivity, profile

    device = next(state.model.parameters()).device
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)

    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS):
        state, _ = step(state, batch)
    _fingerprint(state)
    warmup_s = time.perf_counter() - t0

    ctx = contextlib.nullcontext()
    if trace_dir:
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        ctx = profile(activities=activities)
    with ctx as prof:
        sync()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, batch)
        if cuda:
            end.record()
        fp = _fingerprint(state)  # waits for the last update
        host_s = time.perf_counter() - t0
        seconds = start.elapsed_time(end) / 1e3 if cuda else host_s
    if not math.isfinite(fp):
        raise RuntimeError(f"parameters are not finite after the timed "
                           f"steps (fingerprint {fp})")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "train_step.json"))
    return state, seconds, warmup_s
