"""A2C policy/value network for vector observations; the counterpart of
:mod:`moolib_tpu.models.a2c`.

An obs MLP, an optional LSTM core, and the policy and baseline heads.
Time-major [T, B, obs] in, ([T, B, A] logits, [T, B] baseline) out, with
the agents' calling convention ``(logits, baseline), core_state =
net(obs, done, core_state)``. Load converted reference weights with
:func:`moolib_tpu_torch.models.convert.a2c_params_from_flax`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .core import LSTMCore

__all__ = ["A2CNet"]


class A2CNet(nn.Module):
    """``obs_size`` is one observation's length (the reference infers it
    from the first call). Weights are drawn from ``generator``: LeCun-normal
    kernels and zero biases (the reference's initializers, untruncated);
    the LSTM core as :class:`LSTMCore` draws its own."""

    def __init__(self, num_actions: int, obs_size: int, *,
                 hidden_sizes: Sequence[int] = (128, 128),
                 use_lstm: bool = False, lstm_size: int = 128,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_actions = num_actions
        self.obs_size = obs_size
        sizes = [obs_size, *hidden_sizes]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(sizes, sizes[1:]))
        self.core = (LSTMCore(sizes[-1], lstm_size, device=device,
                              generator=generator) if use_lstm else None)
        out = lstm_size if use_lstm else sizes[-1]
        self.policy = nn.Linear(out, num_actions, device=device)
        self.baseline = nn.Linear(out, 1, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        gen_device = None if generator is None else generator.device
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                w = torch.randn(mod.weight.shape, generator=generator,
                                device=gen_device)
                mod.weight.copy_(w / mod.in_features ** 0.5)
                mod.bias.zero_()
        if self.core is not None:
            self.core.reset_parameters(generator)

    def initial_state(self, batch_size: int) -> Tuple:
        if self.core is not None:
            return self.core.initial_state(batch_size)
        return ()

    def forward(self, obs: torch.Tensor, done: torch.Tensor,
                core_state: Tuple = ()):
        # obs: [T, B, F] float; done: [T, B] bool.
        x = obs.float()
        for layer in self.hidden:
            x = F.relu(layer(x))
        if self.core is not None:
            x, core_state = self.core(x, done, core_state)
        logits = self.policy(x)
        baseline = self.baseline(x).squeeze(-1)
        return (logits, baseline), core_state
