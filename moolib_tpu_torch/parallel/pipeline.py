"""Pipeline parallelism over a ``pp`` mesh axis: the counterpart of
:mod:`moolib_tpu.parallel.pipeline`, tick for tick.

Every rank holds ONE stage's parameters. :func:`pipeline_apply` is
GPipe through autograd: microbatches enter at stage 0 at the
reference's ticks, activations hop stage to stage, and the microbatch
stream is sharded 1/pp per rank in the reference's round-robin layout
(microbatch ``m`` on rank ``m % pp`` at local slot ``m // pp``, outputs
in the same layout). The reference rotates the whole input and output
shards around the ring every tick, which XLA updates in place; here
each tick moves only what it needs: the microbatch stage 0 takes next
(from its home rank) and the output that emerges from the last stage
(to its home rank), with the activation hop, in one exchange
(:func:`~moolib_tpu_torch.parallel.collectives.ppermute_many`, whose
backward runs the pipeline in reverse). The same ticks compute the same
values, and a rank holds O(n_micro/pp) microbatches.

:func:`pipeline_train_1f1b` is the scheduled one-forward-one-backward
pipeline with an explicit per-stage backward (a stage recomputed from
its stashed input) and weight-gradient accumulation; its stash is a
fixed ring of pp slots.

Every stage maps activations of one shape to the same shape. Stage
parameters are a tree stacked on a leading stage axis
(:func:`stack_stage_params`); a rank passes its own slice (leading
dim 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils.checkpoint

from ..utils import nest
from . import collectives

__all__ = [
    "pipeline_apply",
    "pipeline_train_1f1b",
    "stack_stage_params",
    "shard_microbatches",
    "unshard_microbatches",
    "stage_slice",
    "MICRO_SPEC",
]

# The spec of shard_microbatches' output, [k, pp, mb, ...]: the pipeline
# axis second (mesh.shard_batch takes a rank's slice by it).
MICRO_SPEC = (None, "pp")


def stack_stage_params(param_list) -> Any:
    """Stack per-stage parameter trees on a new leading axis."""
    return nest.map_structure(lambda *xs: torch.stack(xs, dim=0),
                              *param_list)


def stage_slice(stacked, mesh, axis_name: str = "pp") -> Any:
    """This rank's stage of a stacked tree (leading dim 1)."""
    i = collectives.axis_index(mesh, axis_name)
    return nest.map_structure(lambda p: p[i:i + 1], stacked)


def shard_microbatches(microbatches: torch.Tensor,
                       n_stages: int) -> torch.Tensor:
    """[n_micro, mb, ...] -> [n_micro//pp, pp, mb, ...], the round-robin
    layout: rank d's local slot s holds microbatch ``s * pp + d``."""
    n_micro = microbatches.shape[0]
    if n_micro % n_stages:
        raise ValueError(
            f"n_micro ({n_micro}) must be divisible by the pipeline size "
            f"({n_stages}) to shard the microbatch stream")
    return microbatches.reshape(
        (n_micro // n_stages, n_stages) + tuple(microbatches.shape[1:]))


def unshard_microbatches(sharded: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`shard_microbatches`."""
    return sharded.reshape((-1,) + tuple(sharded.shape[2:]))


def pipeline_apply(stage_fn: Callable, stage_params: Any,
                   microbatches: torch.Tensor, mesh, axis_name: str = "pp",
                   remat: bool = False) -> torch.Tensor:
    """Run this rank's microbatch shard through the stage pipeline over
    ``axis_name`` of ``mesh``.

    ``stage_fn(params, x_mb) -> y_mb`` is ONE stage, shape preserved;
    ``stage_params`` this rank's stage (leading dim 1); ``microbatches``
    [k, 1, mb, ...], this rank's shard of :func:`shard_microbatches`'
    layout (local slot s = microbatch ``s*pp + d``). With ``remat`` each
    stage application is recomputed in the backward
    (``torch.utils.checkpoint``) instead of keeping its internals.

    Returns [k, 1, mb, ...] in the same layout."""
    group = collectives.axis_group(mesh, axis_name)
    n_stages = collectives.axis_size(group)
    idx = collectives.axis_index(group)
    squeeze = microbatches.shape[1] == 1
    inp = microbatches[:, 0] if squeeze else microbatches
    k = inp.shape[0]
    n_micro = k * n_stages
    params = nest.map_structure(lambda p: p[0], stage_params)
    fn = stage_fn
    if remat:
        def fn(p, x):
            return torch.utils.checkpoint.checkpoint(
                stage_fn, p, x, use_reentrant=False)
    chain = [(d, d + 1) for d in range(n_stages - 1)]
    zero = torch.zeros_like(inp[0])

    def feed(t):
        """Microbatch t's move from its home (rank t % pp, slot t // pp)
        to stage 0; nothing in the drain, whose results never land."""
        if t >= n_micro:
            return zero, []
        src = t % n_stages
        return (inp[t // n_stages] if idx == src else zero), [(src, 0)]

    def land(out, y, pos):
        if idx != pos % n_stages:
            return out
        slot = torch.tensor([pos // n_stages], device=out.device)
        y = y.to(out.dtype)[None]
        if torch.is_grad_enabled() and (y.requires_grad or
                                        out.requires_grad):
            return out.index_copy(0, slot, y)
        out[pos // n_stages] = y[0]
        return out

    out = torch.zeros_like(inp)
    x0, perm = feed(0)
    (x_next,) = collectives.ppermute_many([x0], group, [perm])
    act = zero
    for t in range(n_micro + n_stages - 1):
        y = fn(params, x_next if idx == 0 else act)
        # The output of microbatch pos = t - (pp-1) emerges from the last
        # stage and goes home; the activations hop one stage; the next
        # microbatch comes to stage 0. One exchange.
        pos = t - (n_stages - 1)
        emit = [(n_stages - 1, pos % n_stages)] if pos >= 0 else []
        x1, perm = feed(t + 1)
        act, landed, x_next = collectives.ppermute_many(
            [y, y, x1], group, [chain, emit, perm])
        if pos >= 0:
            out = land(out, landed, pos)
    if out.requires_grad:
        # Each exchange feeds the next tick's stage on every rank, but the
        # last one feeds nothing off its outputs' home ranks: tie it to
        # the result with weight 0, so that every rank's backward runs
        # every exchange, in one order.
        out = out + 0.0 * (act.sum() + landed.sum() + x_next.sum())
    return out[:, None] if squeeze else out


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable,
                        stage_params: Any, microbatches: torch.Tensor,
                        mesh, axis_name: str = "pp"):
    """Scheduled 1F1B training pipeline over ``axis_name`` of ``mesh``:
    warm-up, steady one-forward-one-backward, drain, with an explicit
    per-stage backward and weight-gradient accumulation.

    Schedule (one tick = one F or one B per rank; S stages, M
    microbatches, rank d, microbatch m), the reference's lockstep
    just-in-time PipeDream-flush:

    - forward:  t = d + 2m
    - backward: t = 2S - 1 - d + 2m

    F(d, m) is one tick after F(d-1, m) and B(d, m) one after B(d+1, m),
    so one buffer per direction is the whole exchange; the stash slot
    ``m % S`` is freed before F of ``m + S`` reuses it. 2M + 2(S-1)
    ticks.

    ``stage_fn(params, x_mb) -> y_mb`` (shape preserved); ``loss_fn(y_mb)
    -> scalar`` on the last stage's output, summed over microbatches;
    ``stage_params`` this rank's stage (leading dim 1); ``microbatches``
    [M, mb, ...], the same on every rank. Returns ``(loss_sum,
    stage_grads)``: the loss summed over the axis (every rank), and this
    rank's stage's gradients with leading dim 1. Not differentiable
    itself: the gradients are its result."""
    group = collectives.axis_group(mesh, axis_name)
    S = collectives.axis_size(group)
    idx = collectives.axis_index(group)
    M = microbatches.shape[0]
    params = nest.map_structure(lambda p: p[0].detach(), stage_params)
    leaves = nest.flatten(params)
    dtype = microbatches.dtype
    act_shape = tuple(microbatches.shape[1:])
    zeros = microbatches.new_zeros(act_shape)
    chain_fwd = [(d, d + 1) for d in range(S - 1)]
    chain_bwd = [(d, d - 1) for d in range(1, S)]
    is_last = idx == S - 1

    act_in, gy_in, pending_gy = zeros, zeros, zeros
    stash = microbatches.new_zeros((S,) + act_shape)
    loss_acc = torch.zeros((), dtype=torch.float32, device=zeros.device)
    gacc = [torch.zeros_like(p) for p in leaves]

    def stage_vjp(x, dy):
        ps = [p.detach().requires_grad_() for p in leaves]
        xs = x.detach().requires_grad_()
        with torch.enable_grad():
            y = stage_fn(nest.unflatten_as(params, ps), xs)
            grads = torch.autograd.grad(y, [*ps, xs], dy.to(y.dtype),
                                        allow_unused=True)
        dps = [torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads[:-1])]
        return dps, grads[-1].to(dtype)

    with torch.no_grad():
        for t in range(2 * M + 2 * (S - 1)):
            tf = t - idx
            m_f = tf // 2
            do_f = tf >= 0 and tf % 2 == 0 and m_f < M
            tb = t - (2 * S - 1 - idx)
            m_b = tb // 2
            do_b = tb >= 0 and tb % 2 == 0 and m_b < M

            # -- forward ------------------------------------------------
            x = microbatches[min(max(m_f, 0), M - 1)] if idx == 0 \
                else act_in
            if do_f:
                y = stage_fn(params, x).to(dtype)
                stash[min(max(m_f, 0), M - 1) % S] = x
            else:
                y = x * 0
            if do_f and is_last:
                # The microbatch's loss and dL/dy, for the next tick's B.
                with torch.enable_grad():
                    yy = y.detach().requires_grad_()
                    lv = loss_fn(yy)
                    (gy,) = torch.autograd.grad(lv, yy)
                # f32 accumulator whatever the activations' dtype.
                loss_acc = loss_acc + lv.detach().float()
                pending_gy = gy.to(dtype)

            # -- backward -----------------------------------------------
            x_saved = stash[min(max(m_b, 0), M - 1) % S]
            dy = pending_gy if is_last else gy_in
            if do_b:
                dps, dx = stage_vjp(x_saved, dy)
                gacc = [a + g for a, g in zip(gacc, dps)]
            else:
                dx = x_saved * 0

            # -- hops ---------------------------------------------------
            act_in, gy_in = collectives.ppermute_many(
                [y, dx], group, [chain_fwd, chain_bwd])
        loss_sum = collectives.psum(loss_acc, group)
    grads = nest.unflatten_as(params, [g[None] for g in gacc])
    return loss_sum, grads
