"""Perf sweep of the port's IMPALA learner: vary batch size / dtype /
layout and report env-steps/s and MFU for each config under
:func:`~moolib_tpu_torch.utils.benchmark.time_train_step`'s protocol; the
twin of the reference's ``tools/perf_sweep.py``.

Usage::

    python -m moolib_tpu_torch.tools.perf_sweep [config ...] [--device cpu]

Configs are ``"B=512,dtype=bf16"`` style key=value strings (keys ``B``,
``dtype`` bf16|f32, ``s2d``, ``mxu``); no config runs the reference's
grid: B 256/512/1024 bf16, 256 f32, 256 bf16 with s2d=2, and 256 bf16
with ``mxu=1``. ``mxu=1`` is the
labeled variant of the reference (space-to-depth 2 inside the model and
every conv's channels padded to 128), a different torso geometry from the
headline architecture, reported as such. One JSON line per config; each
successful config also lands a perfwatch trend row (one series per
config string) when ``MOOLIB_TRENDS`` names a store.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..bench.harness import append_device_trend
from ..utils.device import resolve_device

#: The reference's grid: (B, dtype, s2d, mxu).
GRID = ((256, "bf16", 1, 0), (512, "bf16", 1, 0), (1024, "bf16", 1, 0),
        (256, "f32", 1, 0), (256, "bf16", 2, 0), (256, "bf16", 1, 1))
CHANNELS = (16, 32, 32)


def run_config(B: int, dtype: str, s2d: int = 1, iters: Optional[int] = None,
               mxu: int = 0, device=None) -> dict:
    """One config: the ImpalaNet learner (no LSTM; clipped Adam, as
    ``bench_torch.py``) on a seeded uint8 batch [T+1=21, B, 84, 84, 4]."""
    from ..learner import ImpalaConfig, make_impala_train_step, make_train_state
    from ..models import ImpalaNet, space_to_depth
    from ..models.impala import _pad_up
    from ..optim import ClippedAdam
    from ..utils.benchmark import time_train_step
    from ..utils.flops import device_peak_flops, impala_train_flops

    device = resolve_device(device)
    if iters is None:
        iters = int(os.environ.get("MOOLIB_BENCH_ITERS", 10))
    T, H, W, C, A = 20, 84, 84, 4, 6
    cdt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    rng = np.random.default_rng(0)
    obs = torch.from_numpy(
        rng.integers(0, 255, (T + 1, B, H, W, C), dtype=np.uint8))
    h, w, c = H, W, C
    if s2d > 1:
        # The labeled space-to-depth variant: a pure reshape/permute on
        # the host batch before its upload.
        obs = space_to_depth(obs, s2d)
        h, w, c = H // s2d, W // s2d, C * s2d * s2d
    inner = 2 if mxu else 1
    pad_to = 128 if mxu else 0
    net = ImpalaNet(A, (h, w, c), compute_dtype=cdt,
                    space_to_depth_factor=inner, channel_pad_to=pad_to,
                    device=device,
                    generator=torch.Generator(device).manual_seed(0))
    h, w, c = h // inner, w // inner, c * inner * inner
    batch = {
        "obs": obs.to(device),
        "done": torch.from_numpy(rng.random((T + 1, B)) < 0.02).to(device),
        "rewards": torch.from_numpy(
            rng.standard_normal((T + 1, B)).astype(np.float32)).to(device),
        "actions": torch.from_numpy(
            rng.integers(0, A, (T, B))).to(device),
        "behavior_logits": torch.zeros((T, B, A), device=device),
        "core_state": (),
    }
    opt = ClippedAdam(net.parameters(), 6e-4, max_norm=40.0)
    state = make_train_state(net, opt)
    step = make_impala_train_step(config=ImpalaConfig())
    state, dt, first_s = time_train_step(step, state, batch, iters=iters)

    steps_per_sec = iters * T * B / dt
    chans = tuple(_pad_up(ch, pad_to) for ch in CHANNELS)
    flops_step = impala_train_flops(
        (T + 1) * B, height=h, width=w, in_channels=c, num_actions=A,
        channels=chans,
    )
    achieved = flops_step * iters / dt
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peak = device_peak_flops(kind) if device.type == "cuda" else None
    return {
        "B": B,
        "dtype": dtype,
        "s2d": s2d,
        "mxu": mxu,
        "env_steps_per_sec": round(steps_per_sec, 1),
        "tflops": round(achieved / 1e12, 4),
        "mfu": round(achieved / peak, 5) if peak else None,
        "first_call_s": round(first_s, 2),
        "timed_s": round(dt, 4),
        "device_kind": kind,
        "note": (
            "mxu=1 variant (s2d=2 inside the model + channels padded to "
            "128): different torso geometry, NOT the headline architecture"
            if mxu else
            "space-to-depth variant: different torso geometry, "
            "NOT the headline architecture" if s2d > 1 else None
        ),
    }


def parse_config(arg: str):
    kv = dict(p.split("=") for p in arg.split(","))
    return (int(kv.get("B", 256)), kv.get("dtype", "bf16"),
            int(kv.get("s2d", 1)), int(kv.get("mxu", 0)))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    grid = [parse_config(a) for a in argv] or list(GRID)
    failed = 0
    for B, dtype, s2d, mxu in grid:
        try:
            row = run_config(B, dtype, s2d, mxu=mxu, device=device)
        except Exception as e:  # keep sweeping past OOMs
            failed += 1
            print(json.dumps({"B": B, "dtype": dtype, "s2d": s2d,
                              "mxu": mxu, "error": repr(e)}), flush=True)
            continue
        print(json.dumps(row), flush=True)
        cfg_id = f"B{B}_{dtype}_s2d{s2d}_mxu{mxu}"
        append_device_trend(
            f"sweep_{cfg_id}_env_steps_per_sec",
            row["env_steps_per_sec"], "env-steps/s",
            f"python -m moolib_tpu_torch.tools.perf_sweep "
            f"B={B},dtype={dtype},s2d={s2d},mxu={mxu}",
            stats={"n": 1, "timed_s": row["timed_s"],
                   "first_call_s": row["first_call_s"]},
            extra={k: row[k] for k in ("tflops", "mfu") if k in row},
        )
    return 1 if failed == len(grid) else 0


if __name__ == "__main__":
    sys.exit(main())
