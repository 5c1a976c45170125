"""Analytic model FLOPs of ``ImpalaNet`` and the card's peak, for MFU
(achieved model FLOP/s over the card's peak): the port's own copy of
:mod:`moolib_tpu.utils.flops`, with an H100 peak table in place of the
TPU one.

FLOPs are counted from the architecture: the convolutions, the dense
layers and the LSTM. V-trace, the optimizer and the elementwise layers
are O(params) or O(T*B) and are left out, so the number is a *model*
FLOPs utilization, comparable across implementations. A MAC counts as 2
FLOPs; a train step costs 3x the forward pass (the forward, then the
backward's two products of the forward's shape per layer).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = [
    "conv2d_flops",
    "dense_flops",
    "lstm_flops",
    "impala_layer_walk",
    "impala_forward_flops",
    "impala_train_flops",
    "device_peak_flops",
    "TRAIN_FLOPS_MULTIPLIER",
]

TRAIN_FLOPS_MULTIPLIER = 3


def conv2d_flops(h_out: int, w_out: int, kh: int, kw: int, c_in: int,
                 c_out: int) -> int:
    """FLOPs for one conv2d application on a single image (2 * MACs)."""
    return 2 * h_out * w_out * kh * kw * c_in * c_out


def dense_flops(d_in: int, d_out: int) -> int:
    return 2 * d_in * d_out


def lstm_flops(d_in: int, hidden: int) -> int:
    """FLOPs for one LSTM cell step on one sample: 4 gates, two matmuls
    each."""
    return 2 * 4 * hidden * (d_in + hidden)


# ImpalaNet's defaults (models/impala.py), shared by the walk and the sum.
_IMPALA_DEFAULTS = dict(
    height=84, width=84, in_channels=4, channels=(16, 32, 32),
    hidden_size=256, num_actions=6, use_lstm=False, lstm_size=256,
)


def impala_layer_walk(
    height: int = _IMPALA_DEFAULTS["height"],
    width: int = _IMPALA_DEFAULTS["width"],
    in_channels: int = _IMPALA_DEFAULTS["in_channels"],
    channels: Sequence[int] = _IMPALA_DEFAULTS["channels"],
    hidden_size: int = _IMPALA_DEFAULTS["hidden_size"],
    num_actions: int = _IMPALA_DEFAULTS["num_actions"],
    use_lstm: bool = _IMPALA_DEFAULTS["use_lstm"],
    lstm_size: int = _IMPALA_DEFAULTS["lstm_size"],
):
    """Yield per-layer records of ``ImpalaNet``: ``(name, flops_per_frame,
    contraction_k, output_lanes_n, out_elems)``. Per ConvSequence one 3x3
    conv at the incoming resolution, a stride-2 "SAME" max-pool, then four
    3x3 convs at the pooled resolution (84 -> 42 -> 21 -> 11); then the
    dense layer, the optional LSTM and both heads. ``contraction_k`` and
    ``output_lanes_n`` are the implicit-matmul dimensions (convs: K =
    kh*kw*c_in, N = c_out)."""
    h, w, c = height, width, in_channels
    for i, ch in enumerate(channels):
        yield (f"s{i}.conv {c}->{ch} @{h}x{w}",
               conv2d_flops(h, w, 3, 3, c, ch), 9 * c, ch, h * w * ch)
        h, w = math.ceil(h / 2), math.ceil(w / 2)  # SAME pool, stride 2
        for j in range(4):
            yield (f"s{i}.res{j // 2}.conv{j % 2} {ch}->{ch} @{h}x{w}",
                   conv2d_flops(h, w, 3, 3, ch, ch), 9 * ch, ch, h * w * ch)
        c = ch
    d_in = h * w * c
    yield (f"dense {d_in}->{hidden_size}", dense_flops(d_in, hidden_size),
           d_in, hidden_size, hidden_size)
    if use_lstm:
        # 4 gates over [x; h]: one matmul of K = in+hidden, N = 4*hidden.
        yield (f"lstm {hidden_size}+{lstm_size}",
               lstm_flops(hidden_size, lstm_size),
               hidden_size + lstm_size, 4 * lstm_size, lstm_size)
        hidden_size = lstm_size
    yield (f"policy head {hidden_size}->{num_actions}",
           dense_flops(hidden_size, num_actions),
           hidden_size, num_actions, num_actions)
    yield (f"baseline head {hidden_size}->1",
           dense_flops(hidden_size, 1), hidden_size, 1, 1)


def impala_forward_flops(**kw) -> int:
    """Forward FLOPs per frame of ``ImpalaNet``: the sum of the layer walk
    (keywords as :func:`impala_layer_walk`'s)."""
    return sum(rec[1] for rec in impala_layer_walk(**kw))


def impala_train_flops(frames: int, **kw) -> int:
    """Model FLOPs of one train step over ``frames`` frames (= (T+1) * B
    forward frames; the bootstrap frame is real compute)."""
    return TRAIN_FLOPS_MULTIPLIER * frames * impala_forward_flops(**kw)


# Dense bf16 tensor-core peak per card, FLOP/s, from NVIDIA's H100 data
# sheet (without sparsity, at the part's full power limit), matched on
# lower-cased ``torch.cuda.get_device_name()``.
_PEAK_BF16 = (
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989e12),  # the SXM part's name
    ("h100 sxm", 989e12),
)


def device_peak_flops(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card ``device_name`` names (as
    ``torch.cuda.get_device_name()`` gives it), or None if unknown."""
    name = device_name.lower()
    for key, peak in _PEAK_BF16:
        if key in name:
            return peak
    return None
