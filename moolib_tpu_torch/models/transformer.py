"""Transformer agent: the counterpart of
:mod:`moolib_tpu.models.transformer`.

Same agent calling convention as the reference:

    (logits_TBA, baseline_TB), state = net(obs, done, core_state)

The unroll is the context: attention is causal over T and segment-masked,
so no query attends across an episode reset (segment ids are the running
count of ``done`` per batch lane). No state is carried between unrolls.

Numerics follow the reference's flax model, which differs from PyTorch's
defaults in four places:

- Conv padding is flax's "SAME", which pads asymmetrically when the
  stride does not divide the input (84 -> 21 -> 11 pads (2, 2) then
  (1, 2)); the pads are computed as ``lax.padtype_to_pads`` does and
  applied with ``F.pad`` before an unpadded convolution.
- LayerNorm epsilon is 1e-6.
- GELU is the tanh approximation.
- ``compute_dtype`` rounds in exactly two places, the scaled pixels (or
  the vector observation) and the positional embedding. The parameters
  are f32, so the first convolution or linear layer computes in f32 and
  everything after it, attention included, stays f32.

On the card, f32 means full f32: the conv torso runs inside
:func:`~moolib_tpu_torch.models.common.f32_convolutions`, and so must a
caller that differentiates the model (the learner's steps do). The
linear layers follow PyTorch's f32 matmul precision, full f32
("highest") unless the caller changes it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..utils.device import resolve_device
from .common import f32_convolutions, same_pads

__all__ = ["TransformerNet", "f32_convolutions", "segment_ids_from_done",
           "same_pads"]

_LN_EPS = 1e-6


def segment_ids_from_done(done: torch.Tensor) -> torch.Tensor:
    """[T, B] done flags -> [B, T] int32 segment ids (done marks the FIRST
    frame of a new episode)."""
    return torch.cumsum(done.to(torch.int32), dim=0, dtype=torch.int32).T


def _conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    ph = same_pads(x.shape[-2], kh, sh)
    pw = same_pads(x.shape[-1], kw, sw)
    return conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


class _SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, backend: str,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.backend = backend
        self.qkv = nn.Linear(d_model, 3 * d_model, bias=False, device=device)
        self.out = nn.Linear(d_model, d_model, bias=False, device=device)

    def forward(self, x: torch.Tensor, seg_bt: torch.Tensor) -> torch.Tensor:
        # x: [T, B, E] -> attention in [B, H, T, D].
        T, B, E = x.shape
        D = E // self.num_heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)

        def heads(t):  # [T, B, E] -> [B, H, T, D]
            return t.reshape(T, B, self.num_heads, D).permute(1, 2, 0, 3)

        o = attn_ops.attention(heads(q), heads(k), heads(v),
                               backend=self.backend, causal=True,
                               segment_ids=seg_bt)
        return self.out(o.permute(2, 0, 1, 3).reshape(T, B, E))


class _Block(nn.Module):
    """Pre-LN block: attention, then a GELU MLP, each residual."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 backend: str, device=None):
        super().__init__()
        self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.attn = _SelfAttention(d_model, num_heads, backend, device)
        self.ln2 = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.mlp_in = nn.Linear(d_model, mlp_ratio * d_model, device=device)
        self.mlp_out = nn.Linear(mlp_ratio * d_model, d_model, device=device)

    def forward(self, x: torch.Tensor, seg_bt: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), seg_bt)
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerNet(nn.Module):
    """Causal segment-masked transformer over the unroll axis.

    ``obs_shape`` is one frame's shape: ``(H, W, C)`` for uint8 pixels or
    ``(F,)`` for float vectors (the reference infers it from the first
    call). Weights are drawn from ``generator`` at construction; load
    converted reference weights with
    :func:`moolib_tpu_torch.models.convert.transformer_params_from_flax`.
    """

    def __init__(self, num_actions: int, obs_shape: Sequence[int], *,
                 d_model: int = 128, num_layers: int = 2,
                 num_heads: int = 4, mlp_ratio: int = 4,
                 max_len: int = 2048, attention_backend: str = "auto",
                 compute_dtype: torch.dtype = torch.float32,
                 mlp: str = "dense",
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mlp == "moe":
            raise NotImplementedError(
                "mlp='moe' is not ported yet (ROADMAP queue A: MoE "
                "transformer blocks)"
            )
        if mlp != "dense":
            raise ValueError(
                f"unknown mlp type {mlp!r}; expected 'dense' or 'moe'"
            )
        if attention_backend not in ("auto", "dense", "blockwise", "flash"):
            raise NotImplementedError(
                f"attention_backend {attention_backend!r} is not ported "
                "(ROADMAP queue A: multi-device ring/zigzag attention)"
            )
        device = resolve_device(device)
        self.num_actions = num_actions
        self.obs_shape = tuple(obs_shape)
        self.d_model = d_model
        self.attention_backend = attention_backend
        self.compute_dtype = compute_dtype
        self.pixels = len(self.obs_shape) == 3
        if self.pixels:
            c = self.obs_shape[-1]
            self.conv0 = nn.Conv2d(c, 32, 8, stride=4, device=device)
            self.conv1 = nn.Conv2d(32, d_model, 4, stride=2, device=device)
        else:
            self.embed_in = nn.Linear(self.obs_shape[0], d_model,
                                      device=device)
        self.pos_emb = nn.Embedding(max_len, d_model, device=device)
        self.blocks = nn.ModuleList(
            _Block(d_model, num_heads, mlp_ratio, attention_backend, device)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.policy = nn.Linear(d_model, num_actions, device=device)
        self.baseline = nn.Linear(d_model, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """LeCun-normal weights, zero biases, unit LayerNorm scales, and
        a 1/sqrt(d_model) normal embedding (the reference's initializers,
        untruncated), drawn from ``generator``."""
        gen_device = None if generator is None else generator.device
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=gen_device)
                mod.weight.copy_(w / fan_in ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=gen_device)
                mod.weight.copy_(w / self.d_model ** 0.5)

    def initial_state(self, batch_size: int) -> Tuple:
        return ()

    def forward(self, obs: torch.Tensor, done: torch.Tensor,
                core_state: Tuple = (),
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None):
        # obs: [T, B, F] float vectors or [T, B, H, W, C] uint8 pixels.
        T, B = obs.shape[:2]
        x = obs.to(self.compute_dtype)
        if self.pixels:  # small conv torso, stride-8 downsample
            x = (x.reshape(T * B, *obs.shape[2:]) / 255.0).float()
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
            with f32_convolutions():
                x = F.relu(_conv_same(x, self.conv0))
                x = F.relu(_conv_same(x, self.conv1))
            x = x.mean(dim=(2, 3)).reshape(T, B, self.d_model)
        else:
            x = self.embed_in(x.float())
        if positions is None:
            positions = torch.arange(T, device=obs.device)
        pos = self.pos_emb(positions).to(self.compute_dtype)
        x = x + pos[:, None, :].float()
        if segment_ids is None:
            segment_ids = segment_ids_from_done(done)
        for block in self.blocks:
            x = block(x, segment_ids)
        x = self.ln_f(x.float())
        logits = self.policy(x)
        baseline = self.baseline(x).squeeze(-1)
        return (logits, baseline), core_state
