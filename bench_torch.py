"""IMPALA learner throughput of the PyTorch port on one card, in
env-steps/s: the twin of ``bench.py``.

    python3 bench_torch.py        # on the card; raises without one
    python3 bench_torch.py --device cpu

The same step as ``bench.py``: the bf16 ``ImpalaNet`` (no LSTM) forward
over uint8 rollouts [T+1=21, B, 84, 84, 4], V-trace, the backward and
``clip_by_global_norm(40)`` + ``adam(6e-4)``, on a seeded numpy batch.
``MOOLIB_BENCH_BATCH`` (default 256) sets B, ``MOOLIB_BENCH_ITERS``
(default 10) the timed steps, ``MOOLIB_BENCH_PROFILE=<dir>`` writes a
``torch.profiler`` trace of the timed steps. Timing:
:func:`moolib_tpu_torch.utils.benchmark.time_train_step`.

With more than one visible card (or ``devices``), the batch is B x
cards, split over a data-parallel world of one process a card
(:class:`moolib_tpu_torch.parallel.local_dp.LocalDP`, ``bench.py``'s dp
mesh): every rank takes rank 0's state first, then each timed step is
every rank's grad step on its slice, the dp-mean of the gradients and
its own apply; the rate is divided by the cards, as ``bench.py`` divides
it. ``MOOLIB_BENCH_WATCHDOG`` (default 1200 s) bounds the device set-up
and the world's rendezvous: past it the run prints a null-value line and
exits 3.

Prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``mfu`` (analytic model FLOP/s over the card's dense bf16 peak),
``model_tflops_per_sec_per_chip`` and ``device_kind`` (and ``chips``
with more than one). ``vs_baseline`` is null: ``bench.py``'s north star
is a figure for another kind of chip. The line also lands as the
reference's perfwatch trend row when ``MOOLIB_TRENDS`` names a store.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch

METRIC = "impala_train_env_steps_per_sec_per_chip"
UNROLL = 20
NUM_ACTIONS = 6


def make_batch(T: int, B: int, A: int, device) -> dict:
    """``bench.py``'s batch: uniform uint8 frames, dones at rate 0.02,
    normal rewards, uniform actions, zero behaviour logits, seed 0."""
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.integers(0, 255, (T + 1, B, 84, 84, 4), dtype=np.uint8),
        "done": rng.random((T + 1, B)) < 0.02,
        "rewards": rng.standard_normal((T + 1, B)).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int64),
        "behavior_logits": np.zeros((T, B, A), np.float32),
    }
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["core_state"] = ()
    return out


def _train_state(device):
    """The bf16 ``ImpalaNet`` from a seeded generator and the clipped
    Adam, on ``device``."""
    from moolib_tpu_torch import ClippedAdam, ImpalaNet, make_train_state

    net = ImpalaNet(NUM_ACTIONS, compute_dtype=torch.bfloat16, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    opt = ClippedAdam(net.parameters(), 6e-4, max_norm=40.0)
    return make_train_state(net, opt)


def build(device, B: int):
    """``(step, state, batch)`` of the benchmark on ``device`` at batch
    size ``B``: the bf16 ``ImpalaNet`` from a seeded generator, the
    clipped Adam, the IMPALA train step and ``bench.py``'s batch."""
    from moolib_tpu_torch import ImpalaConfig, make_impala_train_step

    return (make_impala_train_step(config=ImpalaConfig()),
            _train_state(device), make_batch(UNROLL, B, NUM_ACTIONS, device))


def dp_rank(device, mesh):
    """Each rank's ``(state, grad_step, apply_step)`` in a dp world: the
    train step of :func:`build` split at the dp-mean of the gradients."""
    from moolib_tpu_torch import ImpalaConfig, make_apply_step, make_grad_step

    return (_train_state(device),
            make_grad_step(config=ImpalaConfig(), mesh=mesh),
            make_apply_step())


def _devices(device, devices) -> list:
    """The benchmark's cards: ``devices`` as given, else ``[device]`` when
    one is named, else every visible card (raising without one)."""
    from moolib_tpu_torch import resolve_device

    if devices is not None:
        return [resolve_device(d) for d in devices]
    first = resolve_device(device)
    if device is not None or first.type != "cuda":
        return [first]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _timed_dp(devices, B: int, iters: int) -> float:
    """The seconds of the timed steps on a dp world over ``devices`` (B
    across all of them); the world is closed after them."""
    from moolib_tpu_torch.parallel.local_dp import LocalDP
    from moolib_tpu_torch.utils.benchmark import time_train_step

    world = LocalDP(devices, dp_rank)
    try:
        state, grad_step, apply_step = dp_rank(devices[0], world.mesh)
        state = world.replicate(state)
        data = make_batch(UNROLL, B, NUM_ACTIONS, "cpu")
        sent = []

        def step(s, batch):
            # The slices go out once; later steps reuse them, as the
            # reference shards its batch once before the chained steps.
            out = world.step(grad_step, apply_step, s, batch,
                             reuse=bool(sent))
            sent.append(True)
            return out

        _, seconds, _ = time_train_step(
            step, state, data, iters=iters,
            trace_dir=os.environ.get("MOOLIB_BENCH_PROFILE"))
        world.close(state.model)
    finally:
        world.close()
    if world.checksum_diff != 0:
        raise RuntimeError(f"the dp ranks' parameters diverged (checksums "
                           f"differ by {world.checksum_diff})")
    return seconds


def main(device: Optional[Union[str, torch.device]] = None,
         batch: Optional[int] = None, iters: Optional[int] = None,
         devices: Optional[list] = None) -> dict:
    """Run the benchmark on ``device`` (the card unless given; every
    visible card unless ``device`` or ``devices`` is given) with B =
    ``batch`` a card and ``iters`` timed steps (the environment's
    settings unless given); prints and returns the JSON line."""
    from moolib_tpu_torch.utils.benchmark import (
        install_watchdog,
        time_train_step,
    )
    from moolib_tpu_torch.utils.flops import (
        device_peak_flops,
        impala_train_flops,
    )

    # A card set-up that hangs ends in a null-value line and exit 3, not
    # in silence (a dp world's rendezvous has a watchdog of its own).
    watchdog = install_watchdog(METRIC)
    try:
        devices = _devices(device, devices)
    finally:
        if watchdog is not None:
            watchdog.cancel()  # the cards answered: never kill a slow run
    device, chips = devices[0], len(devices)
    B = (batch or int(os.environ.get("MOOLIB_BENCH_BATCH", 256))) * chips
    iters = iters or int(os.environ.get("MOOLIB_BENCH_ITERS", 10))
    T, A = UNROLL, NUM_ACTIONS
    if chips > 1:
        seconds = _timed_dp(devices, B, iters)
    else:
        step, state, data = build(device, B)
        _, seconds, _ = time_train_step(
            step, state, data, iters=iters,
            trace_dir=os.environ.get("MOOLIB_BENCH_PROFILE"))

    env_steps_per_s = iters * T * B / seconds / chips
    achieved = (impala_train_flops((T + 1) * B, num_actions=A) * iters
                / seconds / chips)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    peak = device_peak_flops(kind) if device.type == "cuda" else None
    line = {
        "metric": METRIC,
        "value": env_steps_per_s,
        "unit": "env-steps/s/chip",
        "vs_baseline": None,
        "mfu": achieved / peak if peak else None,
        "model_tflops_per_sec_per_chip": achieved / 1e12,
        "device_kind": kind,
    }
    if chips > 1:
        line["chips"] = chips
    print(json.dumps(line), flush=True)
    from moolib_tpu_torch.bench.harness import append_device_trend

    append_device_trend(
        METRIC, env_steps_per_s, line["unit"], "python3 bench_torch.py",
        stats={"n": 1, "timed_s": seconds, "iters": iters,
               "frames_per_iter": T * B},
        extra={k: v for k, v in line.items()
               if k not in ("metric", "value", "unit")},
    )
    return line


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: every visible card")
    main(device=ap.parse_args().device)
