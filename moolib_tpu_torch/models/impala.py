"""IMPALA deep ResNet agent: the counterpart of
:mod:`moolib_tpu.models.impala`.

Three sections of [3x3 conv, 3x3 stride-2 max-pool, two residual blocks]
at 16/32/32 channels, a 256-wide dense layer, an optional LSTM core, and
the policy and baseline heads, with the reference's calling convention:

    (logits_TBA, baseline_TB), core_state = net(obs, done, core_state)

``obs`` is uint8 [T, B, H, W, C]; ``core_state`` is ``()`` without the
LSTM and ``(c, h)`` with it.

Numerics follow the reference's flax model where they differ from
PyTorch's defaults:

- The max-pool's "SAME" padding is asymmetric: (0, 1) at 84 and 42,
  (1, 1) at 21, with -inf; ``max_pool2d(3, 2, padding=1)`` would pad
  (1, 1) everywhere.
- The dense layer flattens each frame in (h, w, c) order (NHWC), so the
  trunk is permuted back to NHWC before the flatten and ``fc.weight``
  keeps the reference's row order.
- With ``compute_dtype`` bf16, flax's ``Conv`` and ``Dense`` cast their
  input, kernel and bias to bf16 and return bf16, the product and the
  bias add each rounded once; pool, relu and residual add stay in bf16.
  The trunk's output is cast back to f32, and the LSTM and the heads run
  in f32. The parameters stay f32 and are cast inside :meth:`forward`,
  so their gradients come back through the cast.
- The pixels are scaled as ``obs.to(compute_dtype) / 255``.

The convolutions run inside :func:`~moolib_tpu_torch.models.common.
f32_convolutions` (full f32 on the card when ``compute_dtype`` is f32).
The trunk runs channels-last: the NHWC frames become NCHW by a permuted
view, which cuDNN takes as its NHWC layout. On the card the max-pool is
the port's own kernel pair (``ops/csrc/max_pool.cu``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _kernels
from ..parallel import collectives
from ..parallel import tp as tp_ops
from ..utils.device import resolve_device
from .common import f32_convolutions, same_pads
from .core import LSTMCore

__all__ = [
    "ImpalaNet",
    "ResidualBlock",
    "ConvSequence",
    "space_to_depth",
    "widen_impala_params",
]


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., H/s, W/s, C*s*s], each s x s block of
    pixels folded into the channels in (row, column, channel) order."""
    if s == 1:
        return x
    *lead, H, W, C = x.shape
    if H % s or W % s:
        raise ValueError(f"space_to_depth({s}) needs H,W divisible: {H}x{W}")
    x = x.reshape(*lead, H // s, s, W // s, s, C)
    n = x.ndim
    perm = tuple(range(n - 5)) + (n - 5, n - 3, n - 4, n - 2, n - 1)
    return x.permute(perm).reshape(*lead, H // s, W // s, C * s * s)


def _pad_up(ch: int, multiple: int) -> int:
    if multiple <= 0:
        return ch
    return -(-ch // multiple) * multiple


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype):
    """flax's 3x3 "SAME" Conv in ``dtype``: the product and the bias add
    rounded separately."""
    y = F.conv2d(x, conv.weight.to(dtype), None, padding=conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool with flax's "SAME" padding, NCHW: the plain
    version for a CPU tensor, the hand-written kernels
    (``ops/csrc/max_pool.cu``) for a CUDA tensor (f32 or bf16; the output
    channels-last)."""
    if x.device.type == "cpu":
        return _max_pool_same_plain(x)
    if x.is_cuda:
        return _MaxPoolSame.apply(x)
    raise ValueError(f"_max_pool_same has no kernel for {x.device}")


def _max_pool_same_plain(x: torch.Tensor) -> torch.Tensor:
    """The pool in plain PyTorch: the input padded with -inf, then
    ``max_pool2d``. Its rule, which the kernels keep: in each window,
    walked in row-major order, an element takes the window when it is
    above the running max or NaN, so the first maximum wins a tie, a NaN
    wins, and a window holding nothing above -inf keeps its first
    position (where that is a pad, its gradient is dropped)."""
    ph = same_pads(x.shape[-2], 3, 2)
    pw = same_pads(x.shape[-1], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class _MaxPoolSame(torch.autograd.Function):
    """The pool on the card: the kernels pad inside their index
    arithmetic, and the backward finds each window's argmax again from
    the saved input, so only the input is saved (no indices, no padded
    copy)."""

    @staticmethod
    def forward(ctx, x):
        pads = same_pads(x.shape[-2], 3, 2), same_pads(x.shape[-1], 3, 2)
        # A no-op for a conv's output, which is channels-last already.
        x = x.contiguous(memory_format=torch.channels_last)
        ctx.save_for_backward(x)
        ctx.pads = pads
        return _kernels.max_pool_same_fwd(x, *pads)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        gy = gy.contiguous(memory_format=torch.channels_last)
        return _kernels.max_pool_same_bwd(x, gy, *ctx.pads)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(channels, channels, 3, padding=1,
                               device=device)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(F.relu(x), self.conv0, self.dtype)
        y = _conv(F.relu(y), self.conv1, self.dtype)
        return x + y


class ConvSequence(nn.Module):
    def __init__(self, in_channels: int, channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, channels, 3, padding=1,
                              device=device)
        self.res0 = ResidualBlock(channels, dtype, device)
        self.res1 = ResidualBlock(channels, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _max_pool_same(_conv(x, self.conv, self.dtype))
        return self.res1(self.res0(x))


class ImpalaNet(nn.Module):
    """IMPALA-deep agent over uint8 frames of ``obs_shape`` (H, W, C).

    ``space_to_depth_factor`` folds s x s pixel blocks into the first
    conv's channels; ``channel_pad_to`` rounds every conv's channels up
    to a multiple (zero-extended weights from :func:`widen_impala_params`
    compute the baseline network). Weights are drawn from ``generator``
    at construction; load converted reference weights with
    :func:`moolib_tpu_torch.models.convert.impala_params_from_flax`."""

    def __init__(self, num_actions: int,
                 obs_shape: Sequence[int] = (84, 84, 4), *,
                 channels: Sequence[int] = (16, 32, 32),
                 hidden_size: int = 256, use_lstm: bool = False,
                 lstm_size: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 space_to_depth_factor: int = 1, channel_pad_to: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        H, W, C = obs_shape
        s = space_to_depth_factor
        if H % s or W % s:
            raise ValueError(f"space_to_depth({s}) needs H,W divisible: "
                             f"{H}x{W}")
        self.num_actions = num_actions
        self.obs_shape = tuple(obs_shape)
        self.compute_dtype = compute_dtype
        self.space_to_depth_factor = s
        h, w, c = H // s, W // s, C * s * s
        seqs = []
        for ch in channels:
            ch = _pad_up(ch, channel_pad_to)
            seqs.append(ConvSequence(c, ch, compute_dtype, device))
            h, w, c = -(-h // 2), -(-w // 2), ch  # "SAME" pool, stride 2
        self.sequences = nn.ModuleList(seqs)
        self.fc = nn.Linear(h * w * c, hidden_size, device=device)
        self.core = (LSTMCore(hidden_size, lstm_size, device=device,
                              generator=generator) if use_lstm else None)
        out = lstm_size if use_lstm else hidden_size
        self.policy = nn.Linear(out, num_actions, device=device)
        self.baseline = nn.Linear(out, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """LeCun-normal kernels and zero biases (the reference's
        initializers, untruncated), drawn from ``generator``; the LSTM
        core as :class:`LSTMCore` draws its own."""
        gen_device = None if generator is None else generator.device
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=gen_device)
                mod.weight.copy_(w / fan_in ** 0.5)
                mod.bias.zero_()
        if self.core is not None:
            self.core.reset_parameters(generator)

    def initial_state(self, batch_size: int) -> Tuple:
        if self.core is not None:
            return self.core.initial_state(batch_size)
        return ()

    def forward(self, obs: torch.Tensor, done: torch.Tensor,
                core_state: Tuple = ()):
        T, B = obs.shape[:2]
        dtype = self.compute_dtype
        x = obs.to(dtype) / 255.0
        x = x.reshape(T * B, *obs.shape[2:])
        x = space_to_depth(x, self.space_to_depth_factor)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last strides
        with f32_convolutions():
            for seq in self.sequences:
                x = seq(x)
        x = F.relu(x).permute(0, 2, 3, 1).reshape(T * B, -1)
        if tp_ops.is_sharded(self.fc.weight):
            return self._head_tp(x, T, B, done, core_state)
        x = F.linear(x, self.fc.weight.to(dtype)) + self.fc.bias.to(dtype)
        x = F.relu(x).float().reshape(T, B, -1)
        if self.core is not None:
            x, core_state = self.core(x, done, core_state)
        logits = self.policy(x)
        baseline = self.baseline(x).squeeze(-1)
        return (logits, baseline), core_state

    def _head_tp(self, x, T, B, done, core_state):
        """Tensor parallel (``parallel/tp.py``'s ``impala_tp_specs``):
        the flatten projection column-parallel, so this rank holds its
        hidden features; the LSTM, when there is one, runs on all of them
        (gathered, then this rank's slice again); the heads row-parallel
        on them."""
        dtype = self.compute_dtype
        group = tp_ops.tp_group(self.fc.weight)
        x = tp_ops.column_linear(x, self.fc.weight.to(dtype),
                                 self.fc.bias.to(dtype))
        x = F.relu(x).float().reshape(T, B, -1)
        if self.core is not None:
            x = collectives.gather_from(x, group, -1)
            x, core_state = self.core(x, done, core_state)
            x = collectives.scatter_to(x, group, -1)
        logits = tp_ops.row_linear(x, self.policy.weight, self.policy.bias)
        baseline = tp_ops.row_linear(x, self.baseline.weight,
                                     self.baseline.bias).squeeze(-1)
        return (logits, baseline), core_state


def widen_impala_params(state_dict: Dict[str, torch.Tensor],
                        channel_pad_to: int) -> Dict[str, torch.Tensor]:
    """Map a baseline :class:`ImpalaNet` ``state_dict`` onto the
    ``channel_pad_to`` variant's by zero-extension, which computes the
    same function: padded output channels get zero kernels and biases, so
    they stay zero through relu, pool and residual add; the next conv's
    kernel over padded inputs is zero. ``fc.weight``'s columns move to
    where the padded (h, w, c) flatten puts them. The heads and the LSTM
    are untouched."""
    pad = lambda ch: _pad_up(ch, channel_pad_to)  # noqa: E731
    out = dict(state_dict)

    def widen_conv(prefix: str, cin_to: int, cout_to: int):
        w, b = state_dict[f"{prefix}.weight"], state_dict[f"{prefix}.bias"]
        cout, cin = w.shape[:2]
        nw = w.new_zeros((cout_to, cin_to) + tuple(w.shape[2:]))
        nw[:cout, :cin] = w
        nb = b.new_zeros((cout_to,))
        nb[:cout] = b
        out[f"{prefix}.weight"], out[f"{prefix}.bias"] = nw, nb

    last_c, i = None, 0  # the first conv's input channels stay unpadded
    while f"sequences.{i}.conv.weight" in state_dict:
        cout, cin = state_dict[f"sequences.{i}.conv.weight"].shape[:2]
        cin_to = cin if last_c is None else pad(cin)
        widen_conv(f"sequences.{i}.conv", cin_to, pad(cout))
        for block in ("res0", "res1"):
            for conv in ("conv0", "conv1"):
                widen_conv(f"sequences.{i}.{block}.{conv}", pad(cout),
                           pad(cout))
        last_c, i = cout, i + 1

    fc = state_dict["fc.weight"]  # [hidden, h*w*C], columns (h, w, c)
    hidden, d_in = fc.shape
    hw = d_in // last_c
    nw = fc.new_zeros((hidden, hw, pad(last_c)))
    nw[:, :, :last_c] = fc.reshape(hidden, hw, last_c)
    out["fc.weight"] = nw.reshape(hidden, hw * pad(last_c))
    return out
