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

Prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``mfu`` (analytic model FLOP/s over the card's dense bf16 peak),
``model_tflops_per_sec_per_chip`` and ``device_kind``. ``vs_baseline``
is null: ``bench.py``'s north star is a figure for another kind of chip.
The line also lands as the reference's perfwatch trend row when
``MOOLIB_TRENDS`` names a store.
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


def build(device, B: int):
    """``(step, state, batch)`` of the benchmark on ``device`` at batch
    size ``B``: the bf16 ``ImpalaNet`` from a seeded generator, the
    clipped Adam, the IMPALA train step and ``bench.py``'s batch."""
    from moolib_tpu_torch import (
        ClippedAdam,
        ImpalaConfig,
        ImpalaNet,
        make_impala_train_step,
        make_train_state,
    )

    net = ImpalaNet(NUM_ACTIONS, compute_dtype=torch.bfloat16, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    opt = ClippedAdam(net.parameters(), 6e-4, max_norm=40.0)
    return (make_impala_train_step(config=ImpalaConfig()),
            make_train_state(net, opt),
            make_batch(UNROLL, B, NUM_ACTIONS, device))


def main(device: Optional[Union[str, torch.device]] = None,
         batch: Optional[int] = None, iters: Optional[int] = None) -> dict:
    """Run the benchmark on ``device`` (the card unless given) with B =
    ``batch`` and ``iters`` timed steps (the environment's settings
    unless given); prints and returns the JSON line."""
    from moolib_tpu_torch import resolve_device
    from moolib_tpu_torch.utils.benchmark import time_train_step
    from moolib_tpu_torch.utils.flops import (
        device_peak_flops,
        impala_train_flops,
    )

    device = resolve_device(device)
    B = batch or int(os.environ.get("MOOLIB_BENCH_BATCH", 256))
    iters = iters or int(os.environ.get("MOOLIB_BENCH_ITERS", 10))
    T, A = UNROLL, NUM_ACTIONS
    step, state, data = build(device, B)
    _, seconds, _ = time_train_step(
        step, state, data, iters=iters,
        trace_dir=os.environ.get("MOOLIB_BENCH_PROFILE"))

    env_steps_per_s = iters * T * B / seconds
    achieved = impala_train_flops((T + 1) * B, num_actions=A) * iters / seconds
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
    ap.add_argument("--device", default=None, help="default: the card")
    main(device=ap.parse_args().device)
