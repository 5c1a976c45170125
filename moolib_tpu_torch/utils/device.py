"""Device choice for the port's entry points.

Every entry point of :mod:`moolib_tpu_torch` runs on the card unless the
caller names another device. Without a card and without a named device it
raises: a run that meant to measure or serve on the card must never
quietly land on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the current
    CUDA device, and raises ``RuntimeError`` when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())
