"""Visible pairs of causal, segment-masked attention, and the bytes and
FLOPs of the port's flash kernels, for their roofline share.

A pair (query i, key j) of one lane is visible when j <= i and both lie
in one segment; ``done`` marks the first frame of a new segment. Per
visible pair and head: 4·D FLOPs in the forward (QK^T and PV), 6·D in
dQ (S, dP, dS·K) and 8·D in dK/dV (S, dP, dS^T·Q, P^T·dO). Each input
byte is counted read once and each output byte written once.
"""

import numpy as np


def visible_pairs(done: np.ndarray) -> int:
    """Visible pairs of every lane together; ``done`` is [T, B] bool."""
    seg = np.cumsum(np.asarray(done, dtype=np.int64), axis=0)
    total = 0
    for lane in seg.T:
        counts = np.bincount(lane)
        total += int((counts * (counts + 1) // 2).sum())
    return total


def kernel_work(B, H, T, D, elt, pairs):
    """{kernel: (FLOPs, bytes)} of one attention call's forward and
    backward at [B, H, T, D] (``elt`` bytes an element, ``pairs`` visible
    pairs of all lanes, each of the H heads)."""
    x = B * H * T * D * elt          # one of q, k, v, o, dO, dq, dk, dv
    seg = 2 * B * T * 4              # seg_q and seg_k, int32
    row = B * H * T * 4              # lse or delta, f32
    hp = H * pairs
    return {
        "fwd": (4 * D * hp, 3 * x + seg + x + row),
        "dq": (6 * D * hp, 4 * x + seg + 2 * row + x),
        "dkdv": (8 * D * hp, 4 * x + seg + 2 * row + 2 * x),
    }


def bound_seconds(work, peak_flops, bytes_per_s) -> float:
    """Sum over the kernels of max(bytes / bandwidth, FLOPs / peak)."""
    return sum(max(b / bytes_per_s, f / peak_flops)
               for f, b in work.values())
