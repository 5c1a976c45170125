"""Frozen counts: model FLOPs by family, the bytes and FLOPs of the
kernels whose roofline share the benchmark reports, and the card's
published peaks. A family's module is ``flops/<family>.py``."""

import importlib


def for_family(family: str):
    """The counts module of a model family, ``cellbench.flops.<family>``."""
    return importlib.import_module(f"cellbench.flops.{family}")


def same_out(size: int, window: int, stride: int):
    """(output size, (low, high) padding) of flax's "SAME" on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return out, (total // 2, total - total // 2)
