"""The recurrent core: the counterpart of :mod:`moolib_tpu.models.core`.

The reference scans flax's ``OptimizedLSTMCell`` over the time axis and
resets the carry where ``done`` is set (``_MaskedLSTMStep``). ``nn.LSTM``
cannot reset its state in the middle of a sequence, so the port loops
over T by hand and writes the gates out:

- the carry is ``(c, h)`` (torch's own cells use ``(h, c)``), multiplied
  by ``~done[t]`` *before* step t;
- the gates are i, f, g, o, from ``x @ W_ih^T + (h @ W_hh^T + b_hh)``:
  the cell's input kernels have no bias and its hidden kernels do, so the
  one bias sits on the hidden side;
- ``c' = f * c + i * g`` and ``h' = o * tanh(c')``, sigmoid on i, f, o
  and tanh on g.

The input products of all T steps are one matmul before the loop; the
loop does the hidden product and the gates. Calling convention of the
reference: ``outs [T, B, H], (c, h) = core(x [T, B, F], done [T, B],
(c, h))``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

__all__ = ["LSTMCore"]


class LSTMCore(nn.Module):
    """LSTM over time-major [T, B, F] input with per-step episode resets.

    Parameters, gate blocks in the order i, f, g, o: ``weight_ih``
    [4H, F], ``weight_hh`` [4H, H] and ``bias_hh`` [4H]. Initialised as
    the reference's cell is (LeCun-normal input kernels, an orthogonal
    [H, H] block per hidden gate, zero bias), untruncated, from
    ``generator``."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(
            torch.empty(4 * hidden_size, input_size, device=device))
        self.weight_hh = nn.Parameter(
            torch.empty(4 * hidden_size, hidden_size, device=device))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size,
                                                device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        gen_device = None if generator is None else generator.device
        w = torch.randn(self.weight_ih.shape, generator=generator,
                        device=gen_device)
        self.weight_ih.copy_(w / self.input_size ** 0.5)
        H = self.hidden_size
        blocks = torch.empty(4, H, H, device=gen_device)
        for block in blocks:
            nn.init.orthogonal_(block, generator=generator)
        self.weight_hh.copy_(blocks.reshape(4 * H, H))
        self.bias_hh.zero_()

    def initial_state(self, batch_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((batch_size, self.hidden_size),
                        device=self.weight_hh.device)
        return (z, z)

    def forward(self, x: torch.Tensor, done: torch.Tensor,
                state: Tuple[torch.Tensor, torch.Tensor]):
        c, h = state
        keep = (~done).to(x.dtype)[..., None]  # [T, B, 1]
        x_gates = F.linear(x, self.weight_ih)   # [T, B, 4H]
        outs = []
        for t in range(x.shape[0]):
            c, h = c * keep[t], h * keep[t]
            gates = F.linear(h, self.weight_hh, self.bias_hh) + x_gates[t]
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), (c, h)
