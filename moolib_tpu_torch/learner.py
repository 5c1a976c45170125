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

With a ``mesh`` (:func:`~moolib_tpu_torch.parallel.mesh.make_mesh`, one
process per device) the steps are data parallel over its ``dp`` axis,
as the reference's ``shard_map`` steps are: every rank is handed the
same global batch (or ``DTensor`` leaves from :func:`~moolib_tpu_torch.
parallel.distributed.host_local_batch_to_global`), runs the loss on its
own slice along the batch axes (:func:`~moolib_tpu_torch.parallel.mesh.
shard_batch`), and gets the global-mean gradients back
(:func:`~moolib_tpu_torch.parallel.mesh.dp_average_grads`), with the
metrics averaged over ``dp`` as ``jax.lax.pmean`` averages them. The
parameters start equal on every rank (:func:`replicate_state`) and stay
so: every rank applies the same reduced gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .models.common import f32_convolutions
from .ops import vtrace
from .optim import global_norm
from .parallel import collectives
from .parallel.mesh import dp_average_grads, pmean_gradients, shard_batch
from .utils import HostStaged, nest, stage_host_async

__all__ = [
    "ImpalaConfig",
    "TrainState",
    "make_train_state",
    "train_state_to_host",
    "load_train_state",
    "impala_loss",
    "make_impala_train_step",
    "make_grad_step",
    "make_apply_step",
    "make_act_step",
    "replicate_state",
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


def train_state_to_host(state: TrainState) -> dict:
    """A host copy of ``state``, keyed by parameter name: ``{"params":
    {name: tensor}, "optimizer": {name: {key: tensor}}, "groups":
    [hyperparameters of each param group], "step": int}``; the payload
    of the Accumulator's state hand-off and of a checkpoint. Card tensors
    are copied into pinned memory together and waited for by their
    events (no stream synchronize), host tensors are cloned. The state
    is updated in place by the apply step, so call it under the lock
    that orders it against the apply (the elastic loop's state lock)."""
    named = list(state.model.named_parameters())
    opt = state.optimizer
    tree = {
        "params": {n: p.detach() for n, p in named},
        "optimizer": {n: dict(opt.state[p]) for n, p in named
                      if p in opt.state},
    }
    staged = stage_host_async(tree)
    tree = nest.map_structure(
        lambda x: x.result() if isinstance(x, HostStaged)
        else x.detach().clone() if torch.is_tensor(x) else x, staged)
    tree["groups"] = [{k: v for k, v in g.items() if k != "params"}
                      for g in opt.param_groups]
    tree["step"] = int(state.step)
    return tree


def _host_scalar(v):
    # A host payload off the wire holds numbers as 0-d arrays.
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


def _upload(v, like: torch.Tensor) -> torch.Tensor:
    """A host value (tensor or numpy array) on ``like``'s device: pinned
    and non-blocking onto a card, ordered before later work on the
    stream."""
    t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
    if like.device.type == "cuda":
        return t.contiguous().pin_memory().to(like.device, non_blocking=True)
    return t.to(like.device)


def load_train_state(state: TrainState, host: dict) -> TrainState:
    """Load a :func:`train_state_to_host` payload (tensors, or the numpy
    arrays the wire delivers) into ``state`` in place: the parameters
    and the optimizer's per-parameter state go onto the parameters'
    device. Returns ``state`` with the payload's step."""
    named = list(state.model.named_parameters())
    opt = state.optimizer
    with torch.no_grad():
        for n, p in named:
            p.copy_(_upload(host["params"][n], p))
    for n, p in named:
        if n in host["optimizer"]:
            values = {k: _host_scalar(v)
                      for k, v in host["optimizer"][n].items()}
            opt.state[p] = {k: _upload(v, p) if hasattr(v, "shape") else v
                            for k, v in values.items()}
        else:
            opt.state.pop(p, None)
    for g, saved in zip(opt.param_groups, host["groups"]):
        g.update({k: _host_scalar(v) for k, v in saved.items()})
    return state._replace(step=int(_host_scalar(host["step"])))


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


def _span(stepscope, name: str):
    """``stepscope``'s profiler range ``name`` (no ledger entry), or no
    range without a ``stepscope``."""
    return _NO_SPAN if stepscope is None else stepscope.span(name)


_NO_SPAN = contextlib.nullcontext()


def _make_grads(apply_fn: Callable, config: ImpalaConfig,
                loss_fn: Callable, mesh=None, axis_name: str = "dp",
                batch_axes: Optional[dict] = None,
                stepscope=None) -> Callable:
    """(model, batch) -> (grads by parameter name, metrics with
    ``grad_norm``, the norm before any clipping or scaling). With a
    ``mesh``: the loss of this rank's slice of ``batch``, then the
    global-mean gradients and the dp-mean metrics. With a ``stepscope``
    the loss, the forward inside it and the backward (with the reduce
    and the norm) are its profiler spans ``loss``, ``forward`` and
    ``backward``."""
    forward = apply_fn
    if stepscope is not None:
        def forward(*args, **kwargs):
            with stepscope.span("forward"):
                return apply_fn(*args, **kwargs)

    def grads_of(model, batch):
        if mesh is not None:
            batch = shard_batch(mesh, batch, batch_axes=batch_axes,
                                axis_name=axis_name)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        with f32_convolutions(), _span(stepscope, "loss"):
            total, metrics = loss_fn(model, forward, batch, config)
        with _span(stepscope, "backward"):
            with f32_convolutions():
                grads = torch.autograd.grad(total, [p for _, p in named],
                                            allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(named, grads)}
            metrics = dict(metrics)
            if mesh is not None:
                grads = dp_average_grads(grads, mesh, axis_name)
                metrics = pmean_gradients(metrics, mesh, axis_name)
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
    axis_name: str = "dp",
) -> Callable[[TrainState, dict], Tuple[TrainState, dict]]:
    """Build the train step ``(state, batch) -> (state, metrics)``:
    forward, V-trace loss, backward and the optimizer step. Metrics are
    detached 0-d tensors on the model's device (reading them waits for
    the step), with ``grad_norm`` taken before clipping. With a
    ``mesh`` the step is data parallel over ``axis_name`` (the module's
    docstring); ``batch_axes`` maps top-level batch keys to the axis
    carrying the batch dimension (default axis 1, time-major
    [T, B, ...], except ``core_state``'s [B, ...] leaves on axis 0).
    With a ``stepscope`` each call is its ``fwd_bwd`` phase, inside
    which the profiler sees the spans ``loss`` (around ``forward``),
    ``backward`` and ``optimizer``."""
    grads_of = _make_grads(apply_fn, config, loss_fn, mesh, axis_name,
                           batch_axes, stepscope)
    apply = make_apply_step()

    def step(state: TrainState, batch: dict) -> Tuple[TrainState, dict]:
        grads, metrics = grads_of(state.model, batch)
        with _span(stepscope, "optimizer"):
            state = apply(state, grads)
        return state, metrics

    return _scoped(step, stepscope, "fwd_bwd")


def make_grad_step(
    apply_fn: Callable = call_model,
    config: ImpalaConfig = ImpalaConfig(),
    mesh=None,
    loss_fn: Callable = impala_loss,
    batch_axes: Optional[dict] = None,
    grad_scale: Optional[float] = None,
    stepscope=None,
    axis_name: str = "dp",
) -> Callable[[torch.nn.Module, dict], Tuple[Dict[str, torch.Tensor], dict]]:
    """Build the gradient step ``(model, batch) -> (grads, metrics)``, the
    compute half of the elastic path (the Accumulator reduces the
    gradients before :func:`make_apply_step` applies them).

    ``grad_scale`` multiplies the gradients on the device (typically by
    the local batch size, turning batch-mean gradients into the batch-sum
    contribution the Accumulator's count/reduce protocol wants);
    ``grad_norm`` is the norm before scaling, as in the reference. With a
    ``mesh`` the gradients are the dp-mean over ``axis_name`` (the
    module's docstring), which the Accumulator then reduces across
    cohorts. With a ``stepscope`` each call is its ``fwd_bwd`` phase,
    inside which the profiler sees the spans ``loss`` (around
    ``forward``) and ``backward``."""
    grads_of = _make_grads(apply_fn, config, loss_fn, mesh, axis_name,
                           batch_axes, stepscope)

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


def replicate_state(state: TrainState, mesh) -> TrainState:
    """Make every rank's state the mesh's first rank's: its parameters,
    buffers, optimizer state and hyperparameters and the step count are
    broadcast from it (one flat bucket per dtype), in place. The mesh
    spans the default process group. Returns ``state``."""
    from torch.distributed.tensor import DTensor

    src = int(mesh.mesh.flatten()[0])
    model, opt = state.model, state.optimizer
    tensors = [t.data for t in [*model.parameters(), *model.buffers()]]
    if any(isinstance(t, DTensor) for t in tensors):
        raise ValueError("replicate_state broadcasts whole tensors; call it "
                         "before the parameters are sharded")
    params = [p for g in opt.param_groups for p in g["params"]]
    tensors += [v for p in params for _, v in
                sorted(opt.state.get(p, {}).items())
                if torch.is_tensor(v)]
    hyper = [(g, k) for g in opt.param_groups for k in sorted(g)
             if k != "params" and isinstance(g[k], (int, float))
             and not isinstance(g[k], bool)]
    device = tensors[0].device
    scalars = torch.tensor([float(state.step)] + [float(g[k])
                                                  for g, k in hyper],
                           dtype=torch.float64, device=device)
    by_dtype: dict = {}
    for t in tensors + [scalars]:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket = collectives.flat_bucket(group)
        collectives.broadcast_(bucket, src)
        collectives.unflatten_into(bucket, group)
    values = scalars.tolist()
    for (g, k), v in zip(hyper, values[1:]):
        g[k] = type(g[k])(v)
    return state._replace(step=int(values[0]))
