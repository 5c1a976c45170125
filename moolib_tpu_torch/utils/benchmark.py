"""Timing of chained steps for the port's benchmarks: the counterparts
of :func:`moolib_tpu.utils.benchmark.time_chained` and
:func:`~moolib_tpu.utils.benchmark.time_train_step`.

The reference chains its steps inside one jit and ends the timed span in
a host readback of a scalar fingerprint. In eager PyTorch the same
protocol reads (:func:`time_chained`, the one implementation):

1. warm-up applications of ``step(carry) -> carry``, which cover kernel
   builds, cuDNN's choice of algorithms and the first allocations, ended
   by the fingerprint read, then a synchronize;
2. ``iters`` chained applications, each on the carry the previous one
   left, between two CUDA events (on the CPU, the host clock);
3. the host read of the fingerprint, which cannot come back before the
   last application has run.

:func:`time_train_step` is that protocol over ``step(state, batch)``,
fingerprinted by the sum of the parameters, after ``WARMUP_STEPS`` steps.

The device guards are the reference's too: :func:`wait_for_device`
probes the card in child processes under a kill timeout until one
answers, and :func:`install_watchdog` turns a run that hangs (a CUDA
set-up, a rendezvous of card processes in which one rank never arrives)
into a JSON diagnostic and exit code 3 instead of silence.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Optional, Tuple

import torch

__all__ = ["WARMUP_STEPS", "time_chained", "time_train_step",
           "install_watchdog", "wait_for_device"]

WARMUP_STEPS = 2

#: What a :func:`wait_for_device` probe child runs: the card count, read
#: by a fresh interpreter (a CUDA set-up that hangs hangs there, not here).
_PROBE_CODE = (
    "import torch\n"
    "n = torch.cuda.device_count()\n"
    "print('MOOLIB_PROBE_OK', 'cuda' if n else 'cpu', n)"
)
#: The shortest kill timeout of a probe child, in seconds.
_PROBE_MIN_TIMEOUT = 20.0


def _fingerprint(state) -> float:
    """Sum of every parameter, read on the host."""
    return float(sum(p.detach().float().sum() for p in
                     state.model.parameters()))


def _carry_fingerprint(carry) -> float:
    """Sum of every tensor leaf of ``carry`` in f32, read on the host:
    the one scalar read that cannot come back before the last
    application has run."""
    from . import nest

    leaves = [x for x in nest.flatten(carry) if torch.is_tensor(x)]
    if not leaves:
        raise ValueError("time_chained needs a carry with tensor leaves")
    return float(sum(x.detach().float().sum() for x in leaves))


def time_chained(step: Callable, carry, iters: int = 10, *,
                 warmup: Optional[int] = None,
                 fingerprint: Optional[Callable[[Any], float]] = None,
                 device: Optional[torch.device] = None,
                 trace_path: Optional[str] = None,
                 ) -> Tuple[Any, float, float]:
    """Time ``iters`` data-dependent applications of ``step(carry) ->
    carry`` on ``device`` (the first tensor leaf's unless given),
    eagerly (the port has no jit), by the module's protocol. The warm-up
    is ``warmup`` applications (``iters`` unless given): it holds any
    kernel build and cuDNN's set-up, the counterpart of the reference's
    compile seconds. ``fingerprint(carry)`` is the host read that ends
    each span (the sum of the carry's tensor leaves unless given). With
    ``trace_path``, a ``torch.profiler`` Chrome trace of the timed
    applications only is written there.

    Returns ``(final_carry, timed_seconds, warmup_seconds)``. Raises
    ``RuntimeError`` if the fingerprint is not finite."""
    from torch.profiler import ProfilerActivity, profile

    from . import nest

    fingerprint = fingerprint or _carry_fingerprint
    if device is None:
        leaves = [x for x in nest.flatten(carry) if torch.is_tensor(x)]
        device = leaves[0].device if leaves else torch.device("cpu")
    cuda = device.type == "cuda"

    t0 = time.perf_counter()
    for _ in range(iters if warmup is None else warmup):
        carry = step(carry)
    fingerprint(carry)
    warmup_s = time.perf_counter() - t0

    ctx = contextlib.nullcontext()
    if trace_path:
        ctx = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
    with ctx as prof:
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            carry = step(carry)
        if cuda:
            end.record()
        fp = fingerprint(carry)  # waits for the last application
        seconds = (start.elapsed_time(end) / 1e3 if cuda
                   else time.perf_counter() - t0)
    if not math.isfinite(fp):
        raise RuntimeError(f"not finite after the timed applications "
                           f"(fingerprint {fp})")
    if trace_path:
        os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
        prof.export_chrome_trace(trace_path)
    return carry, seconds, warmup_s


def time_train_step(
    step: Callable, state, batch, iters: int = 10,
    trace_dir: Optional[str] = None,
) -> Tuple[Any, float, float]:
    """Time ``iters`` chained ``step(state, batch) -> (state, metrics)``
    calls on ``state.model``'s device, after ``WARMUP_STEPS`` steps,
    through :func:`time_chained` with the parameters' sum as the
    fingerprint.

    Returns ``(final_state, timed_seconds, warmup_seconds)``; throughput
    is ``iters * items_per_step / timed_seconds``. With ``trace_dir``, a
    ``torch.profiler`` trace of the timed steps only (not the warm-up) is
    written there as ``train_step.json``. Raises ``RuntimeError`` if the
    parameters are not finite."""
    return time_chained(
        lambda s: step(s, batch)[0], state, iters, warmup=WARMUP_STEPS,
        fingerprint=_fingerprint,
        device=next(state.model.parameters()).device,
        trace_path=(os.path.join(trace_dir, "train_step.json")
                    if trace_dir else None))


def wait_for_device(
    metric: str,
    budget_env: str = "MOOLIB_BENCH_BUDGET",
    default_budget: float = 1000.0,
    probe_interval: float = 60.0,
) -> dict:
    """Block until the card answers, probing in SUBPROCESSES: each probe
    is a fresh ``python -c "import torch; torch.cuda.device_count()"``
    child bounded by a kill timeout, so a CUDA set-up that hangs cannot
    hang this process, and a card that comes back mid-budget is caught
    within one probe interval.

    Returns ``{"attempts": n, "waited_s": s, "platform": p, "n_devices":
    k}`` once a probe answers (``platform`` is ``"cuda"`` where it counted
    a card, else ``"cpu"``). If the budget (``budget_env`` seconds,
    default ``default_budget``; <= 0 probes once) is spent, prints the
    null-value JSON line with the probe history and exits 3."""
    budget = float(os.environ.get(budget_env, default_budget))
    t0 = time.monotonic()
    attempts = 0
    last_err = ""
    while True:
        attempts += 1
        probe_t0 = time.monotonic()
        try:
            out = subprocess.run(
                [sys.executable, "-c", _PROBE_CODE],
                capture_output=True,
                text=True,
                timeout=max(probe_interval - 5.0, _PROBE_MIN_TIMEOUT),
            )
            for line in out.stdout.splitlines():
                if line.startswith("MOOLIB_PROBE_OK"):
                    _, platform, n = line.split()
                    return {
                        "attempts": attempts,
                        "waited_s": round(time.monotonic() - t0, 1),
                        "platform": platform,
                        "n_devices": int(n),
                    }
            last_err = (out.stderr or out.stdout).strip()[-300:]
        except subprocess.TimeoutExpired:
            last_err = "probe subprocess timed out (device hang)"
        waited = time.monotonic() - t0
        if waited + probe_interval > budget:
            print(
                json.dumps(
                    {
                        "metric": metric,
                        "value": None,
                        "error": "device unreachable for "
                        f"{round(waited, 1)}s ({attempts} probes)",
                        "attempts": attempts,
                        "waited_s": round(waited, 1),
                        "last_probe_error": last_err,
                    }
                ),
                flush=True,
            )
            os._exit(3)
        # Pace probes ~probe_interval apart whatever the failed probe
        # took (a refused start fails in ms; a hang burns the timeout).
        probe_took = time.monotonic() - probe_t0
        time.sleep(max(2.0, probe_interval - probe_took))


def install_watchdog(
    metric: str,
    default_seconds: float = 1200.0,
    env_var: Optional[str] = "MOOLIB_BENCH_WATCHDOG",
) -> Optional[threading.Timer]:
    """Abort with a parseable JSON diagnostic instead of hanging forever:
    after ``env_var`` seconds (default ``default_seconds``) the process
    prints ``{"metric", "value": null, "error"}`` and exits 3.

    Returns the timer: CANCEL it as soon as the guarded step (device
    enumeration, a rendezvous) has succeeded, so a healthy but slow run
    is never killed. ``env_var=0`` disables it (returns None);
    ``env_var=None`` reads no variable: ``default_seconds`` holds."""
    seconds = float(default_seconds if env_var is None
                    else os.environ.get(env_var, default_seconds))
    if seconds <= 0:
        return None

    def boom():
        print(
            json.dumps(
                {
                    "metric": metric,
                    "value": None,
                    "error": f"watchdog fired after {seconds}s (device or "
                    "rendezvous unreachable?)",
                }
            ),
            flush=True,
        )
        os._exit(3)

    t = threading.Timer(seconds, boom)
    t.daemon = True
    t.start()
    return t
