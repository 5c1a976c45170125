"""Mixture-of-experts FFN: the counterpart of
:mod:`moolib_tpu.parallel.moe`.

The standard Switch/GShard MoE, with the reference's semantics:

- a router (a linear map, computed in f32) scores every token per expert;
- each token goes to its ``top_k`` experts (top-1 = Switch, top-2 =
  GShard), subject to a fixed per-expert ``capacity``; overflow tokens
  are dropped, so their FFN output is exactly 0 and they pass through
  the residual unchanged. Seating is choice-rank-major: every token's
  first choice is seated, in token order, before any second choice
  competes for a slot;
- ``capacity`` defaults to ``ceil(capacity_factor * N * top_k / E)`` over
  the call's N tokens, capped at N. A token's output therefore depends
  on the other tokens of the same call: a served reply depends on the
  batch it was stacked into;
- dispatch and combine are einsums against a one-hot dispatch mask; the
  combine carries the gates (top-1: the raw probability; top-k: the
  probabilities renormalized over the chosen experts), so the router
  gets gradients;
- the aux dict holds the Switch load-balancing loss on first choices
  (E * sum_e f_e * p_e), the router z-loss (mean logsumexp(logits)^2)
  and the fraction of dropped assignments.

Ties between router probabilities go to the lower expert index, as
``jax.lax.top_k`` and ``jnp.argmax`` break them: the choices come from a
stable descending sort.

:class:`RouteReplay` records the router probabilities of the MoE calls
on one device and seats another device's calls of the same batch with
them: it holds the expert math of two devices against each other apart
from the route flips that their different summation orders cause.

:func:`moe_ffn_sharded` is the expert-parallel variant: an explicit
all-to-all over an ``ep`` axis of a ``torch.distributed`` mesh.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

__all__ = ["RouteReplay", "moe_params", "moe_ffn", "moe_ffn_sharded"]


def moe_params(d_model: int, d_hidden: int, num_experts: int, *,
               dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """Router and expert FFN weights, drawn from ``generator``: ``router``
    [d_model, E], ``w_up`` [E, d_model, d_hidden] and ``w_down``
    [E, d_hidden, d_model], normals scaled by 1/sqrt(fan-in) of each
    expert's own matrix (the reference's scaling)."""
    gen_device = None if generator is None else generator.device

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=gen_device,
                        dtype=torch.float32) / math.sqrt(fan_in)
        return w.to(device=device, dtype=dtype)

    return {
        "router": draw((d_model, num_experts), d_model),
        "w_up": draw((num_experts, d_model, d_hidden), d_model),
        "w_down": draw((num_experts, d_hidden, d_model), d_hidden),
    }


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            capacity: Optional[int] = None, *, top_k: int = 1,
            capacity_factor: float = 1.25):
    """Top-``top_k`` MoE FFN over ``x`` [N, d_model] tokens; returns
    ([N, d_model], aux). ``capacity`` (slots per expert) defaults to
    ``ceil(capacity_factor * N * top_k / E)``; it is capped at N."""
    N = x.shape[0]
    E = params["router"].shape[-1]
    if capacity is None:
        capacity = int(math.ceil(capacity_factor * N * top_k / E))
    capacity = min(capacity, N)
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)  # [N, E]

    dispatch, combine, kept_assignments, first_oh = _dispatch_combine(
        probs, capacity, top_k, x.dtype)

    xe = torch.einsum("tec,td->ecd", dispatch, x)  # [E, C, d_model]
    h = F.gelu(torch.einsum("ecd,edh->ech", xe,
                            params["w_up"].to(x.dtype)),
               approximate="tanh")
    ye = torch.einsum("ech,ehd->ecd", h, params["w_down"].to(x.dtype))
    # The combine carries the gates, so the router gets gradients.
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)

    aux = {
        # Switch load-balancing loss on first choices.
        "load_balance_loss": E * torch.sum(first_oh.mean(dim=0)
                                           * probs.mean(dim=0)),
        # ST-MoE router z-loss: keeps the router's logits bounded.
        "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "drop_fraction": 1.0 - kept_assignments / top_k,
    }
    return y, aux


def _dispatch_combine(probs: torch.Tensor, capacity: int, top_k: int,
                      dtype: torch.dtype):
    """Seat the assignments choice-rank-major: all rank-0 choices take
    slots in token order before any rank-1 choice competes.

    Returns (dispatch [N, E, C] in ``dtype``, combine [N, E, C] f32, the
    kept-assignment count over N (a 0-d f32 tensor), the first choices'
    one-hot [N, E] f32)."""
    N, E = probs.shape
    # Stable descending sort: ties go to the lower expert index.
    sorted_p, sorted_i = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_p, top_i = sorted_p[:, :top_k], sorted_i[:, :top_k]
    gates = top_p if top_k == 1 else top_p / top_p.sum(-1, keepdim=True)

    tokens = torch.arange(N, device=probs.device)
    dispatch = torch.zeros((N, E, capacity), dtype=dtype,
                           device=probs.device)
    combine = torch.zeros((N, E, capacity), dtype=torch.float32,
                          device=probs.device)
    counts = torch.zeros((E,), dtype=torch.int64, device=probs.device)
    kept_assignments = probs.new_zeros(())
    for r in range(top_k):
        oh = F.one_hot(top_i[:, r], E)  # [N, E] int64
        pos = torch.sum((counts[None, :] + torch.cumsum(oh, dim=0) - oh)
                        * oh, dim=-1)  # 0-based seat in the chosen expert
        kept = pos < capacity
        # A dropped assignment writes 0 into slot 0: no seat, no gate.
        seat = (tokens, top_i[:, r], torch.where(kept, pos, 0))
        dispatch = dispatch.index_put(seat, kept.to(dtype), accumulate=True)
        combine = combine.index_put(
            seat, kept.float() * gates[:, r].float(), accumulate=True)
        counts = counts + torch.sum(oh * kept[:, None], dim=0)
        kept_assignments = kept_assignments + kept.float().mean()
    first_oh = F.one_hot(top_i[:, 0], E).float()
    return dispatch, combine, kept_assignments, first_oh


class RouteReplay:
    """Records the router probabilities of every ``moe_ffn`` call made
    inside :meth:`record` (on the host, in call order), then seats the
    calls made inside :meth:`replay` with them, in the same order: the
    replaying calls' own probabilities are compared with the recorded
    ones (``prob_err``, the largest difference), the tokens whose top-k
    set differs are counted (``flipped`` of ``tokens``) with the
    replaying side's margin between its k-th and (k+1)-th probability
    (``margins``), and the seats take the recorded values while the
    gradient flows through the replaying side's own probabilities.
    ``drops`` holds each recorded call's drop fraction."""

    def __init__(self):
        self.recorded, self.drops = [], []
        self.tokens = self.flipped = 0
        self.margins, self.prob_err = [], 0.0

    @staticmethod
    @contextlib.contextmanager
    def _seating(seat):
        module = sys.modules[__name__]
        real = module._dispatch_combine
        module._dispatch_combine = lambda *a: seat(real, *a)
        try:
            yield
        finally:
            module._dispatch_combine = real

    def record(self):
        def seat(real, probs, capacity, top_k, dtype):
            out = real(probs, capacity, top_k, dtype)
            self.recorded.append(probs.detach().float().cpu())
            self.drops.append(1.0 - float(out[2]) / top_k)
            return out

        return self._seating(seat)

    def replay(self):
        def seat(real, probs, capacity, top_k, dtype):
            want = self.recorded.pop(0).to(probs.device)
            self.prob_err = max(self.prob_err,
                                float((want - probs.detach()).abs().max()))
            srt = probs.detach().sort(-1, descending=True)
            mine = srt.indices[:, :top_k].sort(-1).values
            theirs = want.topk(top_k).indices.sort(-1).values
            diff = (mine != theirs).any(-1)
            self.tokens += int(diff.numel())
            self.flipped += int(diff.sum())
            gap = srt.values[:, top_k - 1] - srt.values[:, top_k]
            self.margins += [float(g) for g in gap[diff]]
            return real(probs + (want - probs).detach(), capacity, top_k,
                        dtype)

        return self._seating(seat)


def moe_ffn_sharded(params: Dict[str, torch.Tensor], x_local: torch.Tensor,
                    capacity: Optional[int] = None, *, mesh,
                    axis_name: str = "ep", top_k: int = 1,
                    capacity_factor: float = 1.25):
    """Expert-parallel MoE with an explicit token-to-expert all-to-all
    over ``axis_name`` of ``mesh`` (a ``DeviceMesh``, or the axis'
    process group): rank g holds the token shard ``x_local``
    [T_local, d_model] and the experts [g*E_local, (g+1)*E_local)
    (``params``' ``w_up``/``w_down`` are its [E_local, ...] shards,
    ``router`` replicated). Every rank holds as many tokens, so that the
    ranks seat the same capacity.

    Capacity is group-wise (each token shard owns ``capacity`` slots per
    expert, GShard's grouped dispatch), so the result is ``moe_ffn``'s
    on each shard's tokens alone, and ``moe_ffn``'s on all the tokens
    whenever nothing is dropped. The exchanges are differentiable (the
    backward sends the gradient back the inverse way).

    Returns ([T_local, d_model], aux); the aux losses are averaged over
    the axis (identical on every rank)."""
    from .collectives import all_to_all, axis_group, pmean
    from .mesh import local_value

    group = axis_group(mesh, axis_name)
    groups = torch.distributed.get_world_size(group)
    w_up, w_down = local_value(params["w_up"]), local_value(params["w_down"])
    T_local, d_model = x_local.shape
    E_local = w_up.shape[0]
    E = E_local * groups
    if capacity is None:
        capacity = int(math.ceil(capacity_factor * T_local * top_k / E))
    capacity = min(capacity, T_local)
    logits = x_local.float() @ local_value(params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, kept_assignments, first_oh = _dispatch_combine(
        probs, capacity, top_k, x_local.dtype)

    # Slabs for every expert, [E, C, D] as [G, E_local, C, D]: row g goes
    # to the rank holding experts g*E_local..., which gets every group's
    # slab for its own experts.
    xe = torch.einsum("tec,td->ecd", dispatch, x_local)
    xe = all_to_all(xe.reshape(groups, E_local, capacity, d_model), group)
    h = F.gelu(torch.einsum("gecd,edh->gech", xe, w_up.to(x_local.dtype)),
               approximate="tanh")
    ye = torch.einsum("gech,ehd->gecd", h, w_down.to(x_local.dtype))
    # The reverse exchange: each group's tokens' outputs go home.
    ye = all_to_all(ye, group).reshape(E, capacity, d_model)
    y = torch.einsum("tec,ecd->td", combine.to(x_local.dtype), ye)

    frac_tokens = pmean(first_oh.mean(dim=0), group)
    frac_probs = pmean(probs.mean(dim=0), group)
    aux = {
        "load_balance_loss": E * torch.sum(frac_tokens * frac_probs),
        "router_z_loss": pmean(
            torch.mean(torch.logsumexp(logits, dim=-1) ** 2), group),
        "drop_fraction": pmean(1.0 - kept_assignments / top_k, group),
    }
    return y, aux
