"""The learner's optimizers: the counterparts of the optax chains the
reference trains with,

- ``optax.chain(optax.clip_by_global_norm(max_norm),
  optax.rmsprop(lr, decay, eps))``, ``moolib_tpu/examples/vtrace/
  experiment.py``'s (:class:`ClippedRMSprop`);
- ``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``,
  ``bench.py``'s (:class:`ClippedAdam`).

optax's arithmetic differs from torch's own tools, so the port has its
own:

- ``optax.rmsprop`` keeps nu = decay * nu + (1 - decay) * g**2 from nu = 0
  and updates by -lr * g * rsqrt(nu + eps) (eps inside the square root);
  ``torch.optim.RMSprop`` divides by sqrt(nu) + eps.
- ``optax.adam`` divides by sqrt(nu_hat + eps_root) + eps, with eps_root
  a second epsilon that ``torch.optim.Adam`` does not have.
- ``optax.clip_by_global_norm`` scales every gradient by max_norm / |g|
  only when |g| >= max_norm, with no epsilon; ``clip_grad_norm_`` adds
  1e-6 to the norm.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch.distributed.tensor import DTensor

from .parallel import collectives

__all__ = ["ClippedAdam", "ClippedRMSprop", "global_norm"]


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t``'s squares; for a sharded ``DTensor`` (tensor
    parallelism) the sum over every rank's shard, so that every rank
    holds the global value."""
    if not isinstance(t, DTensor):
        return torch.sum(t * t)
    local = t.to_local()
    total = torch.sum(local * local)
    for dim, placement in enumerate(t.placements):
        if placement.is_shard():
            collectives.all_reduce_(total, t.device_mesh.get_group(dim))
    return total


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of every element's square (``optax.global_norm``);
    ``None`` entries (parameters without a gradient) count as zeros."""
    sums = [_square_sum(t) for t in tensors if t is not None]
    if not sums:
        return torch.zeros(())
    return torch.sqrt(sum(sums))


def _clipped_grads(optimizer: torch.optim.Optimizer,
                   max_norm: Optional[float]):
    """Yield (group, parameter, gradient) with optax's
    ``clip_by_global_norm(max_norm)`` applied (``None``: no clip); a
    parameter without a gradient gets zeros."""
    keep = norm = None
    if max_norm is not None:
        norm = global_norm(p.grad for group in optimizer.param_groups
                           for p in group["params"])
        keep = norm < max_norm  # a 0-d tensor: no host sync
    for group in optimizer.param_groups:
        for p in group["params"]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if keep is not None:
                g = torch.where(keep, g, g / norm * max_norm)
            yield group, p, g


def _check_max_norm(max_norm: Optional[float]) -> None:
    if max_norm is not None and max_norm <= 0:
        raise ValueError(f"max_norm must be positive, got {max_norm}")


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
        _check_max_norm(max_norm)
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))
        self.max_norm = max_norm

    def init_state(self) -> None:
        """Create every parameter's state now (optax's ``init``)."""
        for group in self.param_groups:
            for p in group["params"]:
                self._nu(p)

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
        for group, p, g in _clipped_grads(self, self.max_norm):
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            nu = self._nu(p)
            nu.mul_(decay).add_((1 - decay) * (g * g))
            p.add_(torch.rsqrt(nu + eps) * g * -lr)
        return loss


class ClippedAdam(torch.optim.Optimizer):
    """``clip_by_global_norm(max_norm)`` then ``adam(lr, b1, b2, eps,
    eps_root)``, as optax chains them, in one :meth:`step` that updates
    the parameters and the state ``mu``, ``nu`` in place. mu and nu start
    at 0; the step count t (optax's ``count``) lives in the parameter
    group, so that it is saved with the optimizer's ``state_dict``. The
    update is -lr * mu_hat / (sqrt(nu_hat + eps_root) + eps) with
    mu_hat = mu / (1 - b1**t) and nu_hat = nu / (1 - b2**t).
    ``max_norm=None`` skips the clip. No Nesterov, no weight decay."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, max_norm: Optional[float] = None):
        if lr <= 0 or not 0 <= b1 < 1 or not 0 <= b2 < 1 or eps < 0 \
                or eps_root < 0:
            raise ValueError(f"bad adam settings lr={lr} b1={b1} b2={b2} "
                             f"eps={eps} eps_root={eps_root}")
        _check_max_norm(max_norm)
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root, count=0))
        self.max_norm = max_norm

    def init_state(self) -> None:
        """Create every parameter's state now (optax's ``init``)."""
        for group in self.param_groups:
            for p in group["params"]:
                self._moments(p)

    def _moments(self, p: torch.Tensor):
        state = self.state[p]
        if "mu" not in state:
            state["mu"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["nu"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        return state["mu"], state["nu"]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            group["count"] += 1
        for group, p, g in _clipped_grads(self, self.max_norm):
            b1, b2, t = group["b1"], group["b2"], group["count"]
            mu, nu = self._moments(p)
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            mu_hat = mu / (1 - b1 ** t)
            nu_hat = nu / (1 - b2 ** t)
            update = mu_hat / (torch.sqrt(nu_hat + group["eps_root"])
                               + group["eps"])
            p.add_(update * -group["lr"])
        return loss
