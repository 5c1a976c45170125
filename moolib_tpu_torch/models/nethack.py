"""NetHack agent: the counterpart of :mod:`moolib_tpu.models.nethack`.

A glyph-embedding CNN, a blstats MLP and an LSTM core, with the agents'
calling convention:

    (logits_TBA, baseline_TB), core_state = net(obs, done, core_state)

``obs`` is the NLE-style dict {"glyphs": [T, B, 21, 79] int, "blstats":
[T, B, 27] float}; ``core_state`` is the LSTM's ``(c, h)``, or ``()``
without it.

Numerics follow the reference's flax model where they differ from
PyTorch's defaults:

- The three 3x3 stride-2 convolutions use flax's "SAME" padding, which
  is asymmetric on the 21x79 grid (11x40 -> 6x20 pads (0, 1) on the
  width, 6x20 -> 3x10 pads (0, 1) on both axes); the pads come from
  :func:`~moolib_tpu_torch.models.common.same_pads`.
- Unlike the ``TransformerNet``, the trunk computes in ``compute_dtype``:
  with bf16 the embedded glyphs are rounded to bf16, and every
  convolution and trunk dense layer casts its input, kernel and bias to
  bf16, the product and the bias add each rounded once; the blstats are
  squashed as ``tanh(bf16(blstats) * bf16(0.01))``. The trunk's output
  is cast back to the heads' dtype (f32); the LSTM and the heads run in
  f32. The parameters stay f32 and are cast inside :meth:`forward`.
- The glyph features flatten in (h, w, c) order (NHWC), so the trunk is
  permuted back to NHWC before the flatten and ``fc.weight`` keeps the
  reference's row order.

The convolutions run inside :func:`~moolib_tpu_torch.models.common.
f32_convolutions` (full f32 on the card when ``compute_dtype`` is f32).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .common import f32_convolutions, same_pads
from .core import LSTMCore

__all__ = ["NetHackNet"]

_CHANNELS = (32, 64, 64)


def _conv_same(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype):
    """flax's 3x3 stride-2 "SAME" Conv in ``dtype``, NCHW: the product and
    the bias add rounded separately."""
    ph = same_pads(x.shape[-2], 3, 2)
    pw = same_pads(x.shape[-1], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x, conv.weight.to(dtype), None, stride=2)
    return y + conv.bias.to(dtype)[:, None, None]


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


class NetHackNet(nn.Module):
    """NLE-baseline agent over ``dungeon_shape`` glyph grids (the
    reference infers the grid from the first call). Weights are drawn from
    ``generator`` at construction; load converted reference weights with
    :func:`moolib_tpu_torch.models.convert.nethack_params_from_flax`."""

    def __init__(self, num_actions: int = 23, *, num_glyphs: int = 5976,
                 glyph_embed: int = 16, blstats_size: int = 27,
                 hidden_size: int = 256, use_lstm: bool = True,
                 lstm_size: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 dungeon_shape: Sequence[int] = (21, 79),
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.hidden_size = hidden_size
        self.compute_dtype = compute_dtype
        self.glyph_embed = nn.Embedding(num_glyphs, glyph_embed,
                                        device=device)
        convs = []
        (h, w), c = dungeon_shape, glyph_embed
        for ch in _CHANNELS:
            convs.append(nn.Conv2d(c, ch, 3, device=device))
            h, w, c = -(-h // 2), -(-w // 2), ch  # "SAME", stride 2
        self.convs = nn.ModuleList(convs)
        self.blstats_fc = nn.Linear(blstats_size, 64, device=device)
        self.fc = nn.Linear(h * w * c + 64, hidden_size, device=device)
        self.core = (LSTMCore(hidden_size, lstm_size, device=device,
                              generator=generator) if use_lstm else None)
        out = lstm_size if use_lstm else hidden_size
        self.policy = nn.Linear(out, num_actions, device=device)
        self.baseline = nn.Linear(out, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """LeCun-normal kernels, zero biases and a 1/sqrt(features) normal
        embedding (the reference's initializers, untruncated), drawn from
        ``generator``; the LSTM core as :class:`LSTMCore` draws its own."""
        gen_device = None if generator is None else generator.device
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=gen_device)
                mod.weight.copy_(w / fan_in ** 0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=gen_device)
                mod.weight.copy_(w / mod.embedding_dim ** 0.5)
        if self.core is not None:
            self.core.reset_parameters(generator)

    def initial_state(self, batch_size: int) -> Tuple:
        if self.core is not None:
            return self.core.initial_state(batch_size)
        return ()

    def trunk(self, glyphs: torch.Tensor, blstats: torch.Tensor
              ) -> torch.Tensor:
        """[N, H, W] glyphs and [N, S] blstats -> [N, hidden] in the
        heads' dtype (f32, or f64 for a net cast with ``.double()``)."""
        dtype = self.compute_dtype
        N = glyphs.shape[0]
        # Glyph ids index the table as the reference's int32 cast does.
        g = self.glyph_embed(glyphs.long()).to(dtype)  # [N, H, W, C]
        g = g.permute(0, 3, 1, 2)  # NHWC -> NCHW
        with f32_convolutions():
            for conv in self.convs:
                g = F.relu(_conv_same(g, conv, dtype))
        g = g.permute(0, 2, 3, 1).reshape(N, -1)  # (h, w, c) order
        # blstats are unbounded counters (HP, gold, turns): squash.
        s = blstats.reshape(N, -1).to(dtype)
        s = torch.tanh(s * s.new_tensor(0.01))
        s = F.relu(_dense(s, self.blstats_fc, dtype))
        x = F.relu(_dense(torch.cat([g, s], dim=-1), self.fc, dtype))
        return x.to(self.policy.weight.dtype)

    def forward(self, obs, done: torch.Tensor, core_state: Tuple = ()):
        glyphs, blstats = obs["glyphs"], obs["blstats"]
        T, B = glyphs.shape[:2]
        x = self.trunk(glyphs.reshape(T * B, *glyphs.shape[2:]),
                       blstats.reshape(T * B, -1))
        x = x.reshape(T, B, self.hidden_size)
        if self.core is not None:
            x, core_state = self.core(x, done, core_state)
        logits = self.policy(x)
        baseline = self.baseline(x).squeeze(-1)
        return (logits, baseline), core_state
