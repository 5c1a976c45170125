"""Latency-aware batch-size search for a step function; the counterpart of
:mod:`moolib_tpu.ops.batchsizefinder`, with the reference's sweep and
stopping rule.

Throughput rises with batch size until the card saturates, then latency
grows linearly and throughput plateaus. :func:`find_batch_size` locates
that knee empirically for any step.

Timing protocol: each measurement ends in one scalar read on the output's
device (:func:`_readback`) — the card runs a stream's launches in order,
so reading the last output bounds all ``iters`` calls.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from ..utils import get_logger, nest

log = get_logger("batchsize")

__all__ = ["find_batch_size", "Measurement"]


class Measurement(tuple):
    """(batch_size, latency_s, throughput_items_per_s)."""

    __slots__ = ()

    def __new__(cls, bs, latency, throughput):
        return super().__new__(cls, (bs, latency, throughput))

    batch_size = property(lambda s: s[0])
    latency = property(lambda s: s[1])
    throughput = property(lambda s: s[2])


def _readback(out) -> None:
    """Force real completion of all launched work: one scalar of the
    first non-empty tensor leaf read on the host."""
    for leaf in nest.flatten(out):
        if torch.is_tensor(leaf) and leaf.numel():
            leaf.detach().reshape(-1)[0].item()
            return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # no tensor leaves: wait for the card


def _measure(fn: Callable, make_inputs: Callable, bs: int,
             warmup: int, iters: int) -> float:
    args = make_inputs(bs)
    if not isinstance(args, tuple):
        args = (args,)
    for _ in range(warmup):
        out = fn(*args)
    _readback(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _readback(out)
    return (time.perf_counter() - t0) / iters


def find_batch_size(
    fn: Callable,
    make_inputs: Callable[[int], tuple],
    min_batch_size: int = 1,
    max_batch_size: int = 4096,
    max_latency: Optional[float] = None,
    gain_threshold: float = 1.05,
    warmup: int = 2,
    iters: int = 5,
) -> Tuple[int, List[Measurement]]:
    """Find the batch size where ``fn``'s throughput saturates.

    Sweeps powers of two from ``min_batch_size``; stops when doubling stops
    paying (throughput gain < ``gain_threshold``) or ``max_latency`` (s) is
    exceeded. ``make_inputs(bs)`` builds the (tuple of) inputs for one call
    on the device ``fn`` runs on; the warm-up calls take each new batch
    size's first-use costs (kernel builds, cuDNN's set-up, allocations)
    out of the timing.

    Returns (best_batch_size, [Measurement...]).
    """
    if min_batch_size < 1 or max_batch_size < min_batch_size:
        raise ValueError("need 1 <= min_batch_size <= max_batch_size")
    measurements: List[Measurement] = []
    best: Optional[Measurement] = None
    bs = min_batch_size
    while bs <= max_batch_size:
        latency = _measure(fn, make_inputs, bs, warmup, iters)
        m = Measurement(bs, latency, bs / latency)
        measurements.append(m)
        log.info("bs=%d: %.3fms, %.0f items/s", bs, latency * 1e3,
                 m.throughput)
        if max_latency is not None and latency > max_latency:
            break  # latency budget blown: stop at the previous best
        if best is None or m.throughput >= best.throughput * gain_threshold:
            best = m  # clear improvement: keep doubling
        else:
            if m.throughput > best.throughput:
                best = m  # marginally better, but gains have flattened
            break  # past the knee
        bs *= 2
    if best is None:
        raise ValueError(
            f"min_batch_size={min_batch_size} already exceeds "
            f"max_latency={max_latency}s "
            f"(measured {measurements[0].latency:.4f}s)"
        )
    return best.batch_size, measurements
