"""Everything a run draws comes from ``--seed``, through generators on
the run's device: the weights from one stream, the batches from
another."""

import torch

_GOLDEN = 0x9E3779B97F4A7C15


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    whole number; mixed into the 64 bits ``manual_seed`` takes)."""
    mixed = (int(seed) * _GOLDEN + stream * 0xBF58476D1CE4E5B9) % 2 ** 64
    return torch.Generator(torch.device(device)).manual_seed(mixed)


WEIGHTS, BATCHES = 1, 2


def make_weights(specs, seed: int, device) -> dict:
    """The weights of ``specs`` ([(name, shape, init)], the reference's
    list), drawn in one call: ``lecun`` normal over the fan-in (the
    product of every axis but the first), ``embedding`` normal over
    sqrt(width), ``zeros``, ``ones``. f32, on ``device``."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device),
                       device=device)
    out = {}
    for (name, shape, init), chunk in zip(specs, flat.split(sizes)):
        w = chunk.view(shape)
        if init == "lecun":
            w = w / (torch.Size(shape[1:]).numel() ** 0.5)
        elif init == "embedding":
            w = w / (shape[-1] ** 0.5)
        elif init == "zeros":
            w = torch.zeros(shape, device=device)
        elif init == "ones":
            w = torch.ones(shape, device=device)
        else:
            raise ValueError(f"unknown initializer {init!r} for {name}")
        out[name] = w.contiguous()
    return out
