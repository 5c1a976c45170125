"""The one generator of traffic: a mix file's parameters and a
configuration's shapes in, batches on the device out.

A learner mix (``"loop": "learn"``) gives ``unroll`` T, ``batch`` B,
``ring`` (how many distinct batches the steps cycle through), and the
draws: frames uniform over 0..255 at the configuration's ``obs_shape``;
``done_rate``, placed as round(rate * (T+1) * B) done flags at distinct
uniformly drawn (frame, lane) positions, so every seed has the same
count; rewards ``normal`` (standard normal); actions ``uniform`` over
the configuration's ``num_actions``; behaviour logits ``zero``.
"""

import torch

from .seeds import BATCHES, generator

DRAWS = {"rewards": ("normal",), "actions": ("uniform",),
         "behavior_logits": ("zero",)}


def check_mix(mix: dict) -> None:
    for key, allowed in DRAWS.items():
        if mix.get(key) not in allowed:
            raise ValueError(f"{key} must be one of {allowed}, got "
                             f"{mix.get(key)!r}")
    if not 0 <= mix["done_rate"] <= 1:
        raise ValueError("done_rate must lie in [0, 1]")


def make_batches(cfg: dict, mix: dict, seed: int, device) -> list:
    """``mix["ring"]`` distinct time-major batches: ``obs`` [T+1, B, *obs]
    uint8, ``done`` [T+1, B] bool, ``rewards`` [T+1, B] f32, ``actions``
    [T, B] int64, ``behavior_logits`` [T, B, A] f32."""
    check_mix(mix)
    g = generator(seed, BATCHES, device)
    T, B, A = mix["unroll"], mix["batch"], cfg["num_actions"]
    frames = (T + 1) * B
    n_done = round(mix["done_rate"] * frames)
    out = []
    for _ in range(mix["ring"]):
        obs = torch.randint(0, 256, (T + 1, B, *cfg["obs_shape"]),
                            dtype=torch.uint8, generator=g, device=device)
        done = torch.zeros(frames, dtype=torch.bool, device=device)
        at = torch.randperm(frames, generator=g, device=device)[:n_done]
        done[at] = True
        out.append({
            "obs": obs,
            "done": done.view(T + 1, B),
            "rewards": torch.randn((T + 1, B), generator=g, device=device),
            "actions": torch.randint(0, A, (T, B), generator=g,
                                     device=device),
            "behavior_logits": torch.zeros((T, B, A), device=device),
        })
    return out
