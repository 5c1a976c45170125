"""Learner steps: the IMPALA/V-trace update and the acting step, the
counterparts of :mod:`moolib_tpu.learner`.

The reference jits each step and donates its state; here the steps run
eagerly and update the module's parameters and the optimizer's state in
place, which is what donation buys the reference (no second copy of
either). A :class:`TrainState` holds the module, its optimizer and the
step count.

The model is any module of the agents' calling convention
``(logits, baseline), core_state = model(obs, done, core_state)``: the
``TransformerNet`` or the ``ImpalaNet``, whose ``core_state`` is ``()``
without its LSTM and the LSTM's ``(c, h)`` with it (the batch's
``core_state`` is the state at the unroll's first frame).

Gradients leave :func:`make_grad_step` as a dict keyed like the module's
``named_parameters()`` (the keys :func:`~moolib_tpu_torch.models.
transformer_params_from_flax` and :func:`~moolib_tpu_torch.models.
impala_params_from_flax` give the reference's trees), and
:func:`make_apply_step` takes the same dict back.

On the card, the forward and the backward of every step run with cuDNN's
TF32 off (:func:`~moolib_tpu_torch.models.common.f32_convolutions`): the
reference computes the convolutions and their gradients in f32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .models.common import f32_convolutions
from .ops import vtrace
from .optim import global_norm
from .utils import nest

__all__ = [
    "ImpalaConfig",
    "TrainState",
    "make_train_state",
    "impala_loss",
    "make_impala_train_step",
    "make_grad_step",
    "make_apply_step",
    "make_act_step",
]


@dataclasses.dataclass(frozen=True)
class ImpalaConfig:
    """Loss hyperparameters (reference: examples/vtrace/config.yaml:47-58)."""

    discounting: float = 0.99
    baseline_cost: float = 0.5
    entropy_cost: float = 0.0006
    reward_clip: float = 1.0  # 0 disables clipping
    lambda_: float = 1.0
    clip_rho_threshold: float = 1.0
    clip_pg_rho_threshold: float = 1.0
    # MoE aux-loss weights, used when apply_fn returns model aux.
    moe_lb_cost: float = 0.01
    moe_z_cost: float = 0.001


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def make_train_state(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> TrainState:
    """``optimizer`` is built over ``model.parameters()``."""
    return TrainState(model=model, optimizer=optimizer, step=0)


def call_model(model, obs, done, core_state):
    """The default ``apply_fn``: the module's own forward."""
    return model(obs, done, core_state)


def _entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean policy entropy (positive), [.., A] logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


def impala_loss(model, apply_fn: Callable, batch: dict,
                config: ImpalaConfig) -> Tuple[torch.Tensor, dict]:
    """IMPALA loss on one time-major rollout batch -> (total loss with its
    graph, detached metrics).

    ``batch``: ``obs`` [T+1, B, ...], ``done`` [T+1, B] bool, ``rewards``
    [T+1, B] f32 (index t = reward entering step t), ``actions`` [T, B]
    int, ``behavior_logits`` [T, B, A] f32, ``core_state`` (the model's
    state at frame 0: empty for the transformer and the feed-forward
    ``ImpalaNet``, ``(c, h)`` for its LSTM). Frame T gives the bootstrap
    value.

    ``apply_fn(model, obs, done, core_state)`` may return a THIRD element,
    a dict of model aux losses (``load_balance_loss``, ``router_z_loss``,
    ``drop_fraction``); they are folded into the total with
    ``config.moe_lb_cost`` / ``config.moe_z_cost`` and reported."""
    out = apply_fn(model, batch["obs"], batch["done"], batch["core_state"])
    model_aux = None
    if len(out) == 3:
        (logits, baseline), _, model_aux = out
    else:
        (logits, baseline), _ = out
    logits, bootstrap_value = logits[:-1], baseline[-1]
    baseline = baseline[:-1]

    rewards = batch["rewards"][1:]
    if config.reward_clip > 0:
        rewards = torch.clamp(rewards, -config.reward_clip,
                              config.reward_clip)
    discounts = (~batch["done"][1:]).float() * config.discounting

    vt = vtrace.from_logits(
        behavior_policy_logits=batch["behavior_logits"],
        target_policy_logits=logits,
        actions=batch["actions"],
        discounts=discounts,
        rewards=rewards,
        values=baseline,
        bootstrap_value=bootstrap_value,
        clip_rho_threshold=config.clip_rho_threshold,
        clip_pg_rho_threshold=config.clip_pg_rho_threshold,
        lambda_=config.lambda_,
    )

    pg_loss = -torch.mean(vt.target_action_log_probs * vt.pg_advantages)
    baseline_loss = 0.5 * torch.mean((vt.vs - baseline) ** 2)
    entropy = _entropy(logits)
    total = (pg_loss + config.baseline_cost * baseline_loss
             - config.entropy_cost * entropy)
    metrics = {
        "total_loss": total,
        "pg_loss": pg_loss,
        "baseline_loss": baseline_loss,
        "entropy": entropy,
        "mean_baseline": torch.mean(baseline),
    }
    if model_aux is not None:
        total = (total
                 + config.moe_lb_cost * model_aux["load_balance_loss"]
                 + config.moe_z_cost * model_aux["router_z_loss"])
        metrics["total_loss"] = total
        metrics["moe_lb_loss"] = model_aux["load_balance_loss"]
        metrics["moe_z_loss"] = model_aux["router_z_loss"]
        metrics["moe_drop_fraction"] = model_aux["drop_fraction"]
    return total, {k: v.detach() for k, v in metrics.items()}


def _not_ported(mesh, batch_axes) -> None:
    if mesh is not None or batch_axes is not None:
        raise NotImplementedError(
            "mesh/batch_axes are not ported yet (ROADMAP queue A: "
            "multi-device, torch.distributed data parallel)"
        )


def _scoped(fn: Callable, stepscope, phase: str) -> Callable:
    """Wrap a step so each invocation is attributed to a stepscope phase
    (:mod:`moolib_tpu_torch.telemetry.stepscope`). The phase CM no-ops
    outside an active ``scope.step()``, so a scoped step factory is safe
    to call from anywhere. On the card the step only enqueues its
    kernels, so the attributed time is their dispatch; the device time
    shows up in whichever phase first reads a result back (the caller's
    ``host_sync``), where it actually serializes. Nothing in a step
    reads a result back."""
    if stepscope is None:
        return fn
    cm = stepscope.phase(phase)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with cm:
            return fn(*args, **kwargs)

    return wrapped


def _make_grads(apply_fn: Callable, config: ImpalaConfig,
                loss_fn: Callable) -> Callable:
    """(model, batch) -> (grads by parameter name, metrics with
    ``grad_norm``, the norm before any clipping or scaling)."""

    def grads_of(model, batch):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        with f32_convolutions():
            total, metrics = loss_fn(model, apply_fn, batch, config)
            grads = torch.autograd.grad(total, [p for _, p in named],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named, grads)}
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads.values())
        return grads, metrics

    return grads_of


def make_apply_step(stepscope=None) -> Callable[[TrainState, Dict[str, Any]],
                                                TrainState]:
    """Build the optimizer-apply step ``(state, grads) -> state`` for
    externally reduced gradients (the other half of :func:`make_grad_step`).
    ``grads`` is keyed like ``state.model.named_parameters()``; the
    parameters and the optimizer's state are updated in place. With a
    ``stepscope`` each call is its ``optimizer`` phase."""

    def apply(state: TrainState, grads: Dict[str, Any]) -> TrainState:
        for name, p in state.model.named_parameters():
            if p.requires_grad:
                p.grad = grads[name]
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return state._replace(step=state.step + 1)

    return _scoped(apply, stepscope, "optimizer")


def make_impala_train_step(
    apply_fn: Callable = call_model,
    config: ImpalaConfig = ImpalaConfig(),
    mesh=None,
    loss_fn: Callable = impala_loss,
    batch_axes: Optional[dict] = None,
    stepscope=None,
) -> Callable[[TrainState, dict], Tuple[TrainState, dict]]:
    """Build the train step ``(state, batch) -> (state, metrics)``:
    forward, V-trace loss, backward and the optimizer step on one device.
    Metrics are detached 0-d tensors on the model's device (reading them
    waits for the step), with ``grad_norm`` taken before clipping. With a
    ``stepscope`` each call is its ``fwd_bwd`` phase."""
    _not_ported(mesh, batch_axes)
    grads_of = _make_grads(apply_fn, config, loss_fn)
    apply = make_apply_step()

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, dict]:
        grads, metrics = grads_of(state.model, batch)
        return apply(state, grads), metrics

    return _scoped(step, stepscope, "fwd_bwd")


def make_grad_step(
    apply_fn: Callable = call_model,
    config: ImpalaConfig = ImpalaConfig(),
    mesh=None,
    loss_fn: Callable = impala_loss,
    batch_axes: Optional[dict] = None,
    grad_scale: Optional[float] = None,
    stepscope=None,
) -> Callable[[torch.nn.Module, dict], Tuple[Dict[str, torch.Tensor], dict]]:
    """Build the gradient step ``(model, batch) -> (grads, metrics)``, the
    compute half of the elastic path (the Accumulator reduces the
    gradients before :func:`make_apply_step` applies them).

    ``grad_scale`` multiplies the gradients on the device (typically by
    the local batch size, turning batch-mean gradients into the batch-sum
    contribution the Accumulator's count/reduce protocol wants);
    ``grad_norm`` is the norm before scaling, as in the reference. With a
    ``stepscope`` each call is its ``fwd_bwd`` phase."""
    _not_ported(mesh, batch_axes)
    grads_of = _make_grads(apply_fn, config, loss_fn)

    def step(model, batch):
        grads, metrics = grads_of(model, batch)
        if grad_scale is not None:
            grads = {n: g * grad_scale for n, g in grads.items()}
        return grads, metrics

    return _scoped(step, stepscope, "fwd_bwd")


def make_act_step(model: Callable, temperature: float = 1.0,
                  stepscope=None) -> Callable:
    """Acting step for the actor loop and the serving replica.

    ``model(obs_TB, done_TB, core_state) -> ((logits, baseline), state)``
    is a :class:`~moolib_tpu_torch.models.TransformerNet`, an
    :class:`~moolib_tpu_torch.models.ImpalaNet` or any module of the same
    calling convention. Returns

        act(obs_B, done_B, core_state, generator)
            -> (actions_B, logits_B, new_core_state)

    which adds the T=1 axis (per leaf, for dict observations), divides the
    logits by ``temperature`` and samples one action per lane from their
    softmax with ``generator`` (a :class:`torch.Generator` on the logits'
    device). ``new_core_state`` is the state to pass to the next call
    (an LSTM's, after a reset where ``done`` is set). The returned logits
    are the temperature-scaled ones: they describe the distribution the
    action was drawn from, which is what V-trace's behaviour logits must
    be. With a ``stepscope`` each call is its ``act`` phase."""

    @torch.no_grad()
    def act(obs, done, core_state, generator: torch.Generator):
        obs_t = nest.map_structure(lambda x: x[None], obs)
        (logits, _), core_state = model(obs_t, done[None], core_state)
        logits = logits[0] / temperature
        probs = torch.softmax(logits.float(), dim=-1)
        actions = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return actions, logits, core_state

    return _scoped(act, stepscope, "act")
