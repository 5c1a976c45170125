"""The learner's optimizer: the counterpart of
``optax.chain(optax.clip_by_global_norm(max_norm),
optax.rmsprop(lr, decay, eps))``, the chain that
``moolib_tpu/examples/vtrace/experiment.py`` trains with.

optax's arithmetic differs from torch's own tools, so the port has its
own:

- ``optax.rmsprop`` keeps nu = decay * nu + (1 - decay) * g**2 from nu = 0
  and updates by -lr * g * rsqrt(nu + eps) (eps inside the square root);
  ``torch.optim.RMSprop`` divides by sqrt(nu) + eps.
- ``optax.clip_by_global_norm`` scales every gradient by max_norm / |g|
  only when |g| >= max_norm, with no epsilon; ``clip_grad_norm_`` adds
  1e-6 to the norm.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

__all__ = ["ClippedRMSprop", "global_norm"]


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every element's square (``optax.global_norm``);
    ``None`` entries (parameters without a gradient) count as zeros."""
    sums = [torch.sum(t * t) for t in tensors if t is not None]
    if not sums:
        return torch.zeros(())
    return torch.sqrt(sum(sums))


class ClippedRMSprop(torch.optim.Optimizer):
    """``clip_by_global_norm(max_norm)`` then ``rmsprop(lr, decay, eps)``,
    as optax chains them, in one :meth:`step` that updates the parameters
    and the state ``nu`` in place. ``max_norm=None`` skips the clip. Only
    what the learner uses: no momentum, not centred, one parameter group
    setting for the whole chain."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, max_norm: Optional[float] = None):
        if lr <= 0 or not 0 <= decay < 1 or eps < 0:
            raise ValueError(f"bad rmsprop settings lr={lr} decay={decay} "
                             f"eps={eps}")
        if max_norm is not None and max_norm <= 0:
            raise ValueError(f"max_norm must be positive, got {max_norm}")
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))
        self.max_norm = max_norm

    def _nu(self, p: torch.Tensor) -> torch.Tensor:
        state = self.state[p]
        if "nu" not in state:
            state["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state["nu"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        keep = norm = None
        if self.max_norm is not None:
            norm = global_norm(p.grad for group in self.param_groups
                               for p in group["params"])
            keep = norm < self.max_norm  # a 0-d tensor: no host sync
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if keep is not None:
                    g = torch.where(keep, g, g / norm * self.max_norm)
                nu = self._nu(p)
                nu.mul_(decay).add_((1 - decay) * (g * g))
                p.add_(torch.rsqrt(nu + eps) * g * -lr)
        return loss
