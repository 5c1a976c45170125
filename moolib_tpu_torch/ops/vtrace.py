"""V-trace off-policy actor-critic targets: the counterpart of
:mod:`moolib_tpu.ops.vtrace` (IMPALA, Espeholt et al. 2018,
arXiv:1802.01561, eq. 1).

Definitions:
    delta_t = rho_t (r_t + gamma_t V(x_{t+1}) - V(x_t))
    v_t     = V(x_t) + delta_t + gamma_t c_t (v_{t+1} - V(x_{t+1}))
    rho_t   = min(rho_bar, pi(a_t|x_t) / mu(a_t|x_t))
    c_t     = lambda * min(1, pi(a_t|x_t) / mu(a_t|x_t))
with policy-gradient advantages rho_t (r_t + gamma_t v_{t+1} - V(x_t)),
where the rho used for advantages is clipped at ``clip_pg_rho_threshold``.
Time-major [T, B]; the reverse recursion is a loop over T on [B] tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["VTraceReturns", "VTraceFromLogitsReturns",
           "from_importance_weights", "from_logits", "action_log_probs"]


class VTraceReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor


class VTraceFromLogitsReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor
    log_rhos: torch.Tensor
    behavior_action_log_probs: torch.Tensor
    target_action_log_probs: torch.Tensor


def action_log_probs(policy_logits: torch.Tensor,
                     actions: torch.Tensor) -> torch.Tensor:
    """log pi(a|x) for integer actions over a final logits axis."""
    logp = torch.log_softmax(policy_logits, dim=-1)
    return torch.gather(logp, -1, actions[..., None].long()).squeeze(-1)


def _clip(x: torch.Tensor, threshold: Optional[float]) -> torch.Tensor:
    return x if threshold is None else torch.clamp(x, max=threshold)


def from_importance_weights(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> VTraceReturns:
    """V-trace targets from log importance weights: ``log_rhos``,
    ``discounts``, ``rewards`` and ``values`` are [T, B],
    ``bootstrap_value`` is [B]. No gradient flows through any input: the
    targets are constants with respect to the learner's parameters."""
    log_rhos, discounts, rewards, values, bootstrap_value = (
        t.detach() for t in
        (log_rhos, discounts, rewards, values, bootstrap_value)
    )
    rhos = torch.exp(log_rhos)
    clipped_rhos = _clip(rhos, clip_rho_threshold)
    cs = lambda_ * torch.clamp(rhos, max=1.0)

    # values_{t+1}: shift values up by one, bootstrap at the end.
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    # Backwards recursion: acc_t = delta_t + gamma_t c_t acc_{t+1};
    # vs_t = V(x_t) + acc_t.
    acc = torch.zeros_like(bootstrap_value)
    accs = [acc] * deltas.shape[0]
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        accs[t] = acc
    vs = values + torch.stack(accs)

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_rhos = _clip(rhos, clip_pg_rho_threshold)
    pg_advantages = pg_rhos * (rewards + discounts * vs_t_plus_1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)


def from_logits(
    behavior_policy_logits: torch.Tensor,
    target_policy_logits: torch.Tensor,
    actions: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> VTraceFromLogitsReturns:
    """V-trace for softmax policies: [T, B, A] logits, [T, B] actions.
    ``target_action_log_probs`` keeps its gradient (the policy-gradient
    loss is built from it); ``vs`` and ``pg_advantages`` carry none."""
    behavior_log_probs = action_log_probs(behavior_policy_logits, actions)
    target_log_probs = action_log_probs(target_policy_logits, actions)
    log_rhos = target_log_probs - behavior_log_probs
    vt = from_importance_weights(
        log_rhos=log_rhos,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        lambda_=lambda_,
    )
    return VTraceFromLogitsReturns(
        vs=vt.vs,
        pg_advantages=vt.pg_advantages,
        log_rhos=log_rhos,
        behavior_action_log_probs=behavior_log_probs,
        target_action_log_probs=target_log_probs,
    )
