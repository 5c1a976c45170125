"""What the port's models share: flax's "SAME" padding arithmetic and the
switch that keeps cuDNN's convolutions in full f32.

On the card, f32 means full f32: cuDNN runs f32 convolutions in TF32
unless told otherwise. A model turns TF32 off around its convolutions;
their backward runs later, when autograd reaches it, and reads the switch
then, so a caller that differentiates a model runs the forward and the
backward inside :func:`f32_convolutions` (the learner's steps do).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch

__all__ = ["f32_convolutions", "same_pads"]


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA "SAME" for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


# Re-entrant: a train step holds it around the forward, which takes it
# again around the model's convolutions.
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN's TF32 switch is process-wide: hold it off for the block and
    put it back after, one thread at a time (the owning thread may
    enter again)."""
    with _TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev
