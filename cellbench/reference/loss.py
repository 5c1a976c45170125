"""The IMPALA loss with V-trace targets (Espeholt et al. 2018, eq. 1 and
sec. 4.2), time-major.

With rho_t = min(rho_bar, pi/mu) and c_t = lambda * min(1, pi/mu):
v_s = V(x_s) + sum_t gamma^(t-s) (prod c) rho_t (r_t + gamma V(x_{t+1})
- V(x_t)), taken as the backward recursion v_s - V(x_s) = delta_s +
gamma_s c_s (v_{s+1} - V(x_{s+1})); the policy gradient's advantage is
min(pg_rho_bar, pi/mu) (r_s + gamma_s v_{s+1} - V(x_s)). The targets
carry no gradient.

The batch: ``rewards`` and ``done`` [T+1, B] (index t is the reward
entering frame t, and ``done`` marks the first frame of an episode),
``actions`` [T, B], ``behavior_logits`` [T, B, A]; frame T bootstraps.
Loss = pg + baseline_cost * 0.5 * mean((v_s - V)^2) - entropy_cost *
entropy, rewards clipped to +-reward_clip, discounts gamma * (1 - done).
"""

import torch


def _log_prob(logits, actions):
    return torch.log_softmax(logits, dim=-1).gather(
        -1, actions[..., None]).squeeze(-1)


def vtrace(log_rhos, discounts, rewards, values, bootstrap, cfg):
    log_rhos, values, bootstrap = (t.detach() for t in
                                   (log_rhos, values, bootstrap))
    rhos = torch.exp(log_rhos)
    clipped = torch.clamp(rhos, max=cfg["clip_rho_threshold"])
    cs = cfg["lambda"] * torch.clamp(rhos, max=1.0)
    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    deltas = clipped * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(bootstrap)
    out = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        out.append(acc)
    vs = values + torch.stack(out[::-1])
    next_vs = torch.cat([vs[1:], bootstrap[None]], dim=0)
    pg_rhos = torch.clamp(rhos, max=cfg["clip_pg_rho_threshold"])
    return vs, pg_rhos * (rewards + discounts * next_vs - values)


def impala_loss(logits_all, baseline_all, batch, cfg):
    """(total loss, its scale) of one batch from the model's outputs over
    all T+1 frames. The scale is the sum of the terms' magnitudes, a
    denominator that does not vanish where the terms cancel."""
    logits, bootstrap = logits_all[:-1], baseline_all[-1]
    values = baseline_all[:-1]
    rewards = batch["rewards"][1:]
    if cfg["reward_clip"] > 0:
        rewards = torch.clamp(rewards, -cfg["reward_clip"],
                              cfg["reward_clip"])
    discounts = (~batch["done"][1:]).float() * cfg["discounting"]
    target_lp = _log_prob(logits, batch["actions"])
    behavior_lp = _log_prob(batch["behavior_logits"], batch["actions"])
    vs, adv = vtrace(target_lp - behavior_lp, discounts, rewards, values,
                     bootstrap, cfg)
    pg = -torch.mean(target_lp * adv)
    baseline = 0.5 * torch.mean((vs - values) ** 2)
    logp = torch.log_softmax(logits, dim=-1)
    entropy = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
    terms = (pg, cfg["baseline_cost"] * baseline,
             cfg["entropy_cost"] * entropy)
    scale = sum(float(abs(t.detach())) for t in terms)
    return terms[0] + terms[1] - terms[2], scale
