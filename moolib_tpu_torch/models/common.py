"""What the port's models share: flax's "SAME" padding arithmetic and the
switch that keeps cuDNN's convolutions in full f32 and deterministic.

On the card, f32 means full f32: cuDNN runs f32 convolutions in TF32
unless told otherwise. And cuDNN may pick an algorithm whose sums land in
a different order on every call: the conv torso's weight and bias
gradients then differ in their last bits between two runs of one seeded
train step (up to 17 ULP on an H100), and every parameter the optimizer
moves with them. A model turns TF32 off and deterministic algorithms on
around its convolutions; their backward runs later, when autograd
reaches it, and reads the switches then, so a caller that differentiates
a model runs the forward and the backward inside
:func:`f32_convolutions` (the learner's steps do).
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
    """cuDNN's TF32 and determinism switches are process-wide: hold TF32
    off and deterministic algorithms on for the block and put both back
    after, one thread at a time (the owning thread may enter again)."""
    cudnn = torch.backends.cudnn
    with _TF32_LOCK:
        prev = cudnn.allow_tf32, cudnn.deterministic
        cudnn.allow_tf32, cudnn.deterministic = False, True
        try:
            yield
        finally:
            cudnn.allow_tf32, cudnn.deterministic = prev
