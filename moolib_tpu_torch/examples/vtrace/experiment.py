"""Elastic IMPALA/V-trace training — the flagship experiment; the
counterpart of :mod:`moolib_tpu.examples.vtrace.experiment` on one card.

The loop, as in the reference: env workers step their batches over shared
memory (:class:`~moolib_tpu_torch.envpool.EnvPool`, double-buffered),
:class:`~moolib_tpu_torch.examples.common.EnvBatchState` cuts unrolls from
them, a :class:`~moolib_tpu_torch.ops.Batcher` cats the unrolls into learn
batches, the act step and the grad step run on the device, and the
:class:`~moolib_tpu_torch.parallel.Accumulator` decides when the reduced
gradients are applied. Leader checkpointing (resume wins the leader
election), the cluster-wide stats allreduce, backpressure, the TSV log and
wandb (optional) are the reference's.

Where the reference is JAX-specific:

- the reference shards every learn step over a ``dp`` mesh of the local
  devices, ``dp = gcd(devices, learn_batch_size)``, under one controller.
  Here it is one process a device (:mod:`~moolib_tpu_torch.parallel.
  local_dp`): this process is rank 0 and the Accumulator's one peer,
  ranks 1..dp-1 are learner followers it spawns. They get their slices of
  each learn batch, run the grad step on the mesh with it, apply the
  reduced gradients it broadcasts, take its state after a resume or a
  ``set_state`` (which only marks the state stale: the loop thread sends
  it before the next command, so no collective runs on an RPC thread),
  and stop with it;
- the model is built on ``device`` from ``cfg.seed`` with a
  :class:`torch.Generator`, which then samples the actions, and the optax
  chain is :class:`~moolib_tpu_torch.optim.ClippedRMSprop`;
- the steps update the model and the optimizer's state in place (what the
  reference's donation buys); the state hand-off and the checkpoint read
  them with :func:`~moolib_tpu_torch.learner.train_state_to_host` and
  write them with :func:`~moolib_tpu_torch.learner.load_train_state`,
  under the state lock that also covers the apply;
- observations go to the card through
  :func:`~moolib_tpu_torch.ops.stage_batch` (a pinned copy out of the
  pool's shared memory, then an asynchronous upload), the actions and
  behaviour logits come back in one wait, and the reduced mean goes up
  pinned and non-blocking before the apply.

The loop acts and learns on one thread:
:func:`~moolib_tpu_torch.models.common.f32_convolutions` is one
process-wide lock.

Run (one peer, starts its own broker; on the card unless ``device=cpu``):
    python -m moolib_tpu_torch.examples.vtrace.experiment total_steps=200000
Elastic multi-peer: start ``python -m moolib_tpu_torch.broker`` once, then
any number of peers with ``broker=tcp://HOST:4431``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import sys
import threading
import time
import typing
from typing import List, Optional

import numpy as np
import torch

from ... import create_uid
from ...envpool import EnvPool, WorkerDied, step_with_retry
from ...telemetry import StepScope, publish_metrics
from ...utils import resolve_device, stage_host_async
from .. import common
from .. import envs as env_factories
from ..common import EnvBatchState, StatMean, StatSum, Stats, host_result
from ..common.record import TsvLogger, write_metadata

__all__ = ["VtraceConfig", "train"]


@dataclasses.dataclass
class VtraceConfig:
    """Defaults mirror the reference's config
    (moolib_tpu/examples/vtrace/config.yaml)."""

    # env
    env: str = "synthetic"  # "synthetic" | "cartpole" | an ALE id
    num_actions: int = 6
    episode_length: int = 200  # synthetic env only
    # acting
    actor_batch_size: int = 32
    num_actor_processes: int = 2
    num_actor_batches: int = 2
    unroll_length: int = 20
    # learning
    learn_batch_size: int = 32  # envs per learner update (>= actor_batch_size)
    virtual_batch_size: int = 32
    # How many gradient reductions may overlap / queue unapplied
    # (the Accumulator's parallel_gradients); 1 = lock-step.
    parallel_gradients: int = 2
    # Leader re-pushes full state this often to heal silent drift; None
    # disables.
    state_broadcast_interval: Optional[float] = 600.0
    learning_rate: float = 6e-4
    grad_clip: float = 40.0
    discounting: float = 0.99
    baseline_cost: float = 0.5
    entropy_cost: float = 0.0006
    reward_clip: float = 1.0
    use_lstm: bool = False
    model: str = "auto"  # auto | mlp | resnet | transformer | nethack
    transformer_mlp: str = "dense"  # dense | moe
    num_experts: int = 8
    total_steps: int = 500_000
    max_seconds: Optional[float] = None  # wall-clock stop (benchmarks)
    # infra
    broker: Optional[str] = None  # None -> in-process broker
    # A standby broker (address + peer name) enables member-driven
    # failover; min_quorum commits gradient rounds with K-of-N
    # contributions after the straggler deadline.
    broker_standby: Optional[str] = None
    broker_standby_name: str = "broker2"
    min_quorum: Optional[int] = None
    straggler_timeout: Optional[float] = None
    group: str = "vtrace"
    savedir: Optional[str] = None
    # Capture a torch.profiler trace of updates [10, 13) — 3 steady-state
    # updates, warm-up excluded — into profile_dir/trace.json.
    profile_dir: Optional[str] = None
    wandb: bool = False  # log rows to wandb when the package is available
    wandb_project: str = "moolib_tpu"
    checkpoint_interval: float = 600.0
    checkpoint_history_interval: Optional[float] = 3600.0
    log_interval_steps: int = 10_000
    stats_interval: float = 5.0
    seed: int = 0
    compute_dtype: str = "bfloat16"

    @classmethod
    def from_fleet_spec(cls, spec, **overrides) -> "VtraceConfig":
        """Derive the launch shape from a declarative
        :class:`~moolib_tpu_torch.fleet.spec.FleetSpec`: the env tier's
        worker count and the learner cohort's quorum/straggler/group knobs
        come from the spec — one validated value drives both the fleet
        controller and the training example. Everything else keeps its
        default unless overridden."""
        cfg = cls(
            num_actor_processes=max(spec.env_workers.n, 1),
            min_quorum=spec.learners.min_quorum,
            straggler_timeout=spec.learners.straggler_timeout_s,
            group=spec.learners.group,
        )
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _make_env_fn(cfg: VtraceConfig):
    return env_factories.make_env_fn(
        cfg.env, num_actions=cfg.num_actions,
        episode_length=cfg.episode_length,
    )


def _obs_shape(cfg: VtraceConfig) -> tuple:
    """One observation's shape for ``cfg.env`` (the reference reads it
    off a dummy observation at init)."""
    if cfg.env == "cartpole":
        return (4,)
    if cfg.env == "procgen" or cfg.env.startswith("procgen:"):
        return (64, 64, 3)
    return (84, 84, 4)


def _make_model(cfg: VtraceConfig, device=None,
                generator: Optional[torch.Generator] = None):
    """The agent ``cfg`` names, on ``device``, its weights drawn from
    ``generator``."""
    from ...models import A2CNet, ImpalaNet, NetHackNet, TransformerNet

    num_actions = 2 if cfg.env == "cartpole" else cfg.num_actions
    dtype = (
        torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    )
    model = cfg.model
    if model == "auto":
        if cfg.env == "cartpole":
            model = "mlp"
        elif cfg.env == "nethack":
            model = "nethack"
        else:
            model = "resnet"
    if model == "nethack":
        return NetHackNet(num_actions, use_lstm=cfg.use_lstm,
                          compute_dtype=dtype, device=device,
                          generator=generator)
    obs_shape = _obs_shape(cfg)
    if model == "mlp":
        if len(obs_shape) != 1:
            raise ValueError(f"model='mlp' needs vector observations, "
                             f"env {cfg.env!r} gives {obs_shape}")
        return A2CNet(num_actions, obs_shape[0], use_lstm=cfg.use_lstm,
                      device=device, generator=generator)
    if model == "transformer":
        return TransformerNet(
            num_actions, obs_shape, compute_dtype=dtype,
            mlp=cfg.transformer_mlp, num_experts=cfg.num_experts,
            device=device, generator=generator,
        )
    if model == "resnet":
        return ImpalaNet(
            num_actions, obs_shape, use_lstm=cfg.use_lstm,
            compute_dtype=dtype, device=device, generator=generator,
        )
    raise ValueError(f"unknown model {cfg.model!r}")


def _learner(cfg: VtraceConfig, device, mesh=None, stepscope=None):
    """The learner of ``cfg`` on ``device``: ``(generator, state,
    grad_step, apply_step)``. One generator on the device draws the
    weights, then the actions. With a ``mesh`` the grad step is data
    parallel over its ``dp`` axis (every rank of a dp world builds it so).
    """
    from ...learner import (
        ImpalaConfig,
        call_model,
        make_apply_step,
        make_grad_step,
        make_train_state,
    )
    from ...optim import ClippedRMSprop

    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    net = _make_model(cfg, device, gen).train()
    optimizer = ClippedRMSprop(net.parameters(), cfg.learning_rate,
                               decay=0.99, eps=0.01, max_norm=cfg.grad_clip)
    state = make_train_state(net, optimizer)
    loss_cfg = ImpalaConfig(
        discounting=cfg.discounting,
        baseline_cost=cfg.baseline_cost,
        entropy_cost=cfg.entropy_cost,
        reward_clip=cfg.reward_clip,
    )
    learn_apply = call_model
    if getattr(net, "mlp", "dense") == "moe":
        # The MoE layers' aux (load-balance and z losses, drop fraction)
        # rides a 3-tuple apply, which folds it into the loss and the
        # training metrics (drops must never be silent).
        def learn_apply(model, obs, done, core_state):
            return model(obs, done, core_state, return_aux=True)

    # grad_scale folds the x batch_size "sum contribution" scaling into
    # the step, so the update loop never touches gradient values on the
    # host.
    grad_step = make_grad_step(
        learn_apply, config=loss_cfg, mesh=mesh,
        grad_scale=float(cfg.learn_batch_size), stepscope=stepscope,
    )
    return gen, state, grad_step, make_apply_step(stepscope=stepscope)


def _dp_follower(device, mesh, cfg: VtraceConfig):
    """A dp follower's learner (:class:`~moolib_tpu_torch.parallel.
    local_dp.LocalDP` calls it by name in each spawned rank)."""
    _, state, grad_step, apply_step = _learner(cfg, device, mesh)
    return state, grad_step, apply_step


def _learn_devices(device, devices) -> List[torch.device]:
    """The learn step's devices, rank 0's first: ``devices`` as given,
    else ``[device]`` when a device is named, else every visible card
    (the current one first); raises without a card unless the CPU is
    named."""
    if devices is None:
        if device is not None:
            return [resolve_device(device)]
        first = resolve_device(None)
        return [first] + [torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())
                          if i != first.index]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("devices is empty")
    if device is not None and resolve_device(device) != devices[0]:
        raise ValueError(f"device {device} is not devices[0] "
                         f"({devices[0]})")
    return devices


def _dp_world(cfg: VtraceConfig, devices):
    """The data-parallel world of the learn step over ``devices`` (dp
    above 1). The flash kernels are built here first, where the
    transformer runs them, so that the followers only load them."""
    from ...parallel.local_dp import LocalDP

    first = devices[0]
    if (cfg.model == "transformer" and first.type == "cuda"
            and torch.cuda.get_device_capability(first) == (9, 0)):
        from ...ops._kernels import build_all

        build_all()
    return LocalDP(devices, _dp_follower, args=(cfg,))


def train(cfg: VtraceConfig, log_fn=print, device=None,
          devices=None) -> List[dict]:
    """Run the experiment; returns the logged rows. ``device`` None means
    the card, and raises without one: pass ``device="cpu"`` to run on the
    CPU.

    ``devices`` are the local devices the learn step spreads over, one
    process each (the reference's ``jax.devices()``): ``dp =
    gcd(len(devices), learn_batch_size)`` of them, rank 0 (this process)
    on the first. Default: ``[device]`` when a device is named, else every
    visible card. ``["cpu", "cpu"]`` is a dp world of two CPU ranks;
    ``["cuda:0", "cuda:0"]`` two ranks sharing one card."""
    from ...parallel.local_dp import dp_size

    devices = _learn_devices(device, devices)
    dp = dp_size(devices, cfg.learn_batch_size)
    world = _dp_world(cfg, devices[:dp]) if dp > 1 else None
    try:
        return _train(cfg, log_fn, devices[0], world)
    finally:
        if world is not None:
            world.close()  # a no-op past _train's own STOP


def _train(cfg: VtraceConfig, log_fn, device, world) -> List[dict]:
    """:func:`train` on ``device``, rank 0 of ``world`` where there is
    one."""
    from ...learner import load_train_state, make_act_step, train_state_to_host
    from ...ops import Batcher, stage_batch
    from ...parallel import Accumulator, GlobalStatsAccumulator
    from ...rpc import Rpc
    from ...utils import Checkpointer
    from ...utils.profiling import StepWindowProfiler

    # --- model / learner ---------------------------------------------------
    # Phase attribution for this loop: the steps are scoped through the
    # learner factories (act / fwd_bwd / optimizer), the wait-shaped
    # phases (env_wait / host_sync / grad_allreduce / checkpoint) are
    # explicit below.
    scope = StepScope("vtrace_learner")
    gen, state, grad_step, apply_step = _learner(
        cfg, device, None if world is None else world.mesh, scope)
    net = state.model
    act = make_act_step(net, stepscope=scope)
    # apply_step updates the parameters and the optimizer's state in
    # place. get_state runs on Accumulator RPC threads (requestState
    # service) against the same state, so reading it and the apply must
    # be mutually exclusive — state_lock below. Lock order is always
    # accumulator._lock -> state_lock; nothing under state_lock takes the
    # accumulator's lock back.
    state_lock = threading.Lock()
    # The followers start from weights of their own: they take this
    # rank's state before their first command, and again after every
    # resume or set_state (stale is set under state_lock).
    stale = world is not None

    def sync_followers():
        """Under state_lock: the followers take this rank's state if it
        changed since they last did."""
        nonlocal state, stale
        if stale:
            state = world.replicate(state)
            stale = False

    # --- control plane -----------------------------------------------------
    broker = None
    broker_addr = cfg.broker
    if broker_addr is None:
        broker = common.InProcessBroker()
        broker_addr = broker.address
    rpc = Rpc(f"vtrace-{create_uid()[:8]}")
    rpc.listen("127.0.0.1:0")
    rpc.connect(broker_addr)

    # --- elasticity / persistence ------------------------------------------
    def get_state():
        with state_lock:
            return {"state": train_state_to_host(state)}

    def set_state(payload):
        # On an RPC thread: no collective here (it would interleave with
        # the loop thread's commands); the loop thread sends the state.
        nonlocal state, stale
        with state_lock:
            state = load_train_state(state, payload["state"])
            stale = world is not None

    accumulator = Accumulator(
        rpc,
        group_name=cfg.group,
        virtual_batch_size=cfg.virtual_batch_size,
        get_state=get_state,
        set_state=set_state,
        parallel_gradients=cfg.parallel_gradients,
        state_broadcast_interval=cfg.state_broadcast_interval,
        min_quorum=cfg.min_quorum,
        straggler_timeout=cfg.straggler_timeout,
    )
    if cfg.broker_standby:
        # Member-driven broker failover: a dark primary is written off
        # after a few ping intervals and the standby adopts the epoch
        # from cohort gossip.
        rpc.connect(cfg.broker_standby)
        accumulator.group.set_broker_candidates(
            ["broker", cfg.broker_standby_name]
        )

    ckpt = None
    if cfg.savedir:
        os.makedirs(cfg.savedir, exist_ok=True)
        write_metadata(
            os.path.join(cfg.savedir, "metadata.json"),
            config=dataclasses.asdict(cfg),
            peer=rpc.get_name(),
        )
        ckpt = Checkpointer(
            os.path.join(cfg.savedir, "checkpoint.ckpt"),
            interval=cfg.checkpoint_interval,
            history_interval=cfg.checkpoint_history_interval,
        )
        saved = ckpt.load()
        if saved is not None:
            with state_lock:
                state = load_train_state(state, saved["state"])
                stale = world is not None
            # The checkpoint holder must win leader election.
            accumulator.set_model_version(saved["model_version"])
            log_fn(f"resumed from {ckpt.path} at version "
                   f"{saved['model_version']}")

    # --- stats -------------------------------------------------------------
    applied_version = accumulator.model_version  # 0 or the resumed version

    stats = Stats(  # cumulative; global view via the stats allreduce
        env_steps=StatSum(),
        updates=StatSum(),
        skips=StatSum(),
        dropped_unrolls=StatSum(),
        episode_returns=StatMean(cumulative=True),
    )
    window = Stats(  # per-log-interval local view
        episode_returns=StatMean(),
        total_loss=StatMean(),
        entropy=StatMean(),
        grad_norm=StatMean(),
        sps=StatMean(),
        moe_drop_fraction=StatMean(),
    )
    gsa = GlobalStatsAccumulator(accumulator.group, stats)
    tsv = (
        TsvLogger(os.path.join(cfg.savedir, "logs.tsv")) if cfg.savedir else None
    )
    wandb_run = None
    if cfg.wandb:
        # Optional; absence degrades to tsv.
        try:
            import wandb

            wandb_run = wandb.init(
                project=cfg.wandb_project,
                name=rpc.get_name(),
                config=dataclasses.asdict(cfg),
            )
        except concurrent.futures.CancelledError:
            raise  # executor cancellation is control flow, not "no wandb"
        except Exception as e:
            log_fn(f"wandb disabled ({e}); logging to tsv only")
    logs: List[dict] = []
    profiler = StepWindowProfiler(cfg.profile_dir)

    # --- env pool ----------------------------------------------------------
    pool = EnvPool(
        _make_env_fn(cfg),
        num_processes=cfg.num_actor_processes,
        batch_size=cfg.actor_batch_size,
        num_batches=cfg.num_actor_batches,
        action_dtype=np.int64,
    )
    batch_states = [
        EnvBatchState(
            cfg.unroll_length, net.initial_state(cfg.actor_batch_size)
        )
        for _ in range(cfg.num_actor_batches)
    ]
    actions = [
        np.zeros(cfg.actor_batch_size, np.int64)
        for _ in range(cfg.num_actor_batches)
    ]
    # Two-stage batching: EnvBatchState time-batches unrolls; this cats them
    # along the batch axis into learn batches. Unroll leaves are
    # [T, B, ...] except core_state's [B, ...] — hence the per-key axis.
    learn_batcher = Batcher(
        batch_size=cfg.learn_batch_size, dim=1, dims={"core_state": 0}
    )
    max_ready_batches = 4  # backpressure: drop rollouts past this backlog

    env_steps = 0
    # Training metrics on their way to the host: drained in bulk at log
    # boundaries (and bounded below) instead of a blocking read per
    # update. By drain time the copies have long landed.
    pending_metrics: list = []

    def drain_metrics(keep_last: int = 0):
        while len(pending_metrics) > keep_last:
            m = pending_metrics.pop(0)
            window["total_loss"] += float(host_result(m["total_loss"]))
            window["entropy"] += float(host_result(m["entropy"]))
            window["grad_norm"] += float(host_result(m["grad_norm"]))
            if "moe_drop_fraction" in m:
                # Capacity drops must show in the logs, not vanish into
                # the residual path.
                window["moe_drop_fraction"] += float(
                    host_result(m["moe_drop_fraction"]))

    def checkpoint_state():
        with state_lock:
            host = train_state_to_host(state)
        return {
            "state": host,
            "model_version": applied_version,
            "config": dataclasses.asdict(cfg),
        }

    next_log = cfg.log_interval_steps
    last_stats_enqueue = 0.0
    t_start = time.monotonic()
    last_sps_mark = (t_start, 0)
    futures = [pool.step(i, actions[i]) for i in range(cfg.num_actor_batches)]

    finished = False
    try:
        while env_steps < cfg.total_steps and (
            cfg.max_seconds is None
            or time.monotonic() - t_start < cfg.max_seconds
        ):
            with scope.step():
                # -- acting (double-buffered) ---------------------------------
                for i in range(cfg.num_actor_batches):
                    # Bounded wait: a dead env worker must surface as an
                    # error, not hang the acting loop forever. WorkerDied
                    # is the RETRY-SAFE class (the pool respawns the
                    # worker; a same-action retry is exactly-once per
                    # env), so training survives an actor-process death.
                    with scope.phase("env_wait"):
                        try:
                            out = futures[i].result(timeout=300.0)
                        except WorkerDied:
                            out = step_with_retry(
                                pool, i, actions[i], timeout=300.0
                            )
                    bs = batch_states[i]
                    unroll = bs.observe(out)
                    if unroll is not None:
                        # Backpressure: while disconnected/electing/syncing
                        # the learner consumes nothing — drop rollouts
                        # rather than queue stale off-policy data.
                        if (
                            accumulator.connected()
                            and learn_batcher.ready() < max_ready_batches
                        ):
                            learn_batcher.cat(unroll)
                        else:
                            stats["dropped_unrolls"] += 1
                    now_in = stage_batch(
                        {"obs": common.obs_from_env_out(out),
                         "done": out["done"]}, device,
                    )
                    a, logits, core = act(
                        now_in["obs"], now_in["done"], bs.core_state, gen
                    )
                    with scope.phase("host_sync"):
                        # The actions must reach the host now to feed the
                        # pool's slab; the logits ride with them (one
                        # wait: both copies are on one stream).
                        a, logits = (
                            host_result(x) for x in
                            stage_host_async((a, logits.float()))
                        )
                        a = a.numpy()
                        bs.record_action(a, logits.numpy(), core)
                    actions[i][:] = a
                    futures[i] = pool.step(i, actions[i])
                    env_steps += cfg.actor_batch_size
                    stats["env_steps"] += cfg.actor_batch_size
                    for r in bs.recent_returns():
                        stats["episode_returns"] += r
                        window["episode_returns"] += r

                # -- learning (Accumulator-driven) ----------------------------
                accumulator.update()
                if accumulator.connected():
                    if accumulator.wants_gradients():
                        if not learn_batcher.empty():
                            if world is None:
                                batch = stage_batch(learn_batcher.get(),
                                                    device)
                                grads, metrics = grad_step(state.model, batch)
                            else:
                                with state_lock:
                                    sync_followers()
                                # Every rank's slice of the learn batch;
                                # rank 0 keeps the dp-mean gradients.
                                grads, metrics = world.grad(
                                    grad_step, state.model,
                                    learn_batcher.get())
                            # No host sync between the grad step and
                            # reduce_gradients' return: the metrics stay
                            # on their way to the host (drained at the
                            # next log boundary) and the Accumulator
                            # stages the gradients itself.
                            pending_metrics.append(stage_host_async(metrics))
                            if len(pending_metrics) >= 64:
                                # Bound the backlog; everything but the
                                # newest entry has had >=1 update of
                                # transfer time.
                                drain_metrics(keep_last=1)
                            with scope.phase("grad_allreduce"):
                                accumulator.reduce_gradients(
                                    grads, batch_size=cfg.learn_batch_size
                                )
                        else:
                            accumulator.skip_gradients()
                            stats["skips"] += 1
                    if accumulator.has_gradients():
                        mean_grads, _count = accumulator.result_gradients()
                        # Version label for the params apply_step produces
                        # — model_version itself can advance on RPC
                        # threads.
                        applied_version = accumulator.result_model_version()
                        # BEFORE the update: result() counts completed
                        # updates, i.e. the 0-based index of the one about
                        # to run — so the [start, stop) window captures
                        # exactly those.
                        profiler.step(int(stats["updates"].result()))
                        if world is None:
                            # Up pinned and non-blocking, before the apply.
                            mean_grads = stage_batch(mean_grads, device)
                        # Atomic with the state hand-off: a get_state on an
                        # RPC thread must never read a half-applied update.
                        with state_lock:
                            if world is None:
                                state = apply_step(state, mean_grads)
                            else:
                                # Every rank applies the same mean, which
                                # goes out from here.
                                sync_followers()
                                state = world.apply(apply_step, state,
                                                    mean_grads)
                        accumulator.zero_gradients()
                        stats["updates"] += 1

                # -- stats / checkpoint / logs --------------------------------
                now = time.monotonic()
                if now - last_stats_enqueue >= cfg.stats_interval:
                    last_stats_enqueue = now
                    gsa.enqueue_global_stats()
                if ckpt is not None and accumulator.is_leader():
                    with scope.phase("checkpoint"):
                        ckpt.maybe_save(checkpoint_state)
                if env_steps >= next_log:
                    next_log += cfg.log_interval_steps
                    drain_metrics()
                    t_mark, s_mark = last_sps_mark
                    window["sps"].add(
                        (env_steps - s_mark) / (now - t_mark + 1e-9))
                    last_sps_mark = (now, env_steps)
                    g = gsa.global_stats.results()
                    row = dict(
                        window.results(),
                        # The local gradient steps whose metrics this
                        # window holds: a window without one logs a NaN
                        # loss (an empty mean), not a diverged one.
                        grad_steps=int(window["total_loss"].count),
                        time=now,
                        env_steps=env_steps,
                        global_env_steps=g.get("env_steps", 0.0),
                        global_return=g.get("episode_returns", float("nan")),
                        updates=stats["updates"].result(),
                        skips=stats["skips"].result(),
                        model_version=accumulator.model_version,
                        leader=accumulator.is_leader(),
                    )
                    logs.append(row)
                    # Scrapeable progress: a __telemetry scrape of this
                    # peer's Rpc shows the same row the TSV/wandb sinks
                    # get.
                    publish_metrics(row, prefix="train", example="vtrace")
                    if tsv is not None:
                        tsv.log(row)
                    if wandb_run is not None:
                        wandb_run.log(row, step=env_steps)
                    log_fn(
                        "steps {env_steps:>9}  return {episode_returns:8.2f}  "
                        "global {global_return:8.2f}  loss {total_loss:8.4f}  "
                        "sps {sps:8.0f}  updates {updates:g}".format(**row)
                    )
                    window.reset()
        finished = True
    finally:
        scope.close()
        profiler.close()
        pool.close()
        learn_batcher.close()
        accumulator.close()
        rpc.close()
        if broker is not None:
            broker.close()
        if wandb_run is not None:
            wandb_run.finish()
        if world is not None:
            if finished and stale:
                with state_lock:
                    sync_followers()
            _stop_world(world, state, log_fn, finished)
    return logs


def _stop_world(world, state, log_fn, finished: bool) -> None:
    """``STOP``: the followers' reports, logged. At the end of a run that
    finished, every follower's parameters must be this rank's bits."""
    reports = world.close(state.model)
    if not reports:
        return  # a broken world: reaped, and its fault raised already
    log_fn(f"dp world of {world.dp} ({', '.join(world.devices)}, "
           f"{world.backend}): follower updates "
           f"{[r['updates'] for r in reports]}, kernel launches "
           f"{[r['launches'] for r in reports]}; the followers' parameter "
           f"checksums differ from rank 0's by {world.checksum_diff}")
    if finished and world.checksum_diff != 0:
        raise RuntimeError(f"the dp ranks' parameters diverged (checksums "
                           f"differ by {world.checksum_diff})")


def _apply_overrides(cfg: VtraceConfig, overrides: List[str]) -> VtraceConfig:
    """``key=value`` CLI overrides onto the dataclass, typed by the
    fields' declared types: an ``Optional[float]`` field such as
    ``max_seconds`` takes a float (or ``none``). The reference types a
    field by its current value, so an override of a field whose default
    is None stays a string (``max_seconds=60`` then fails in ``train``)."""
    values = dataclasses.asdict(cfg)
    hints = typing.get_type_hints(VtraceConfig)
    for item in overrides:
        if "=" not in item:
            raise SystemExit(f"override {item!r} is not key=value")
        k, v = item.split("=", 1)
        k = k.replace("-", "_")
        if k not in values:
            raise SystemExit(f"unknown config key {k!r}")
        field_type = hints[k]
        args = typing.get_args(field_type)
        if type(None) in args:
            if v.lower() in ("none", "null"):
                values[k] = None
                continue
            (field_type,) = (a for a in args if a is not type(None))
        if field_type is bool:
            values[k] = v.lower() in ("1", "true", "yes")
        else:
            values[k] = field_type(v)
    return VtraceConfig(**values)


def _load_config(path: str) -> VtraceConfig:
    """A yaml file of VtraceConfig fields, read by PyYAML where it is
    installed, else as the flat ``key: value`` lines (``#`` comments) the
    shipped configs hold, typed by the fields as CLI overrides are."""
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path) as f:
        if yaml is not None:
            return VtraceConfig(**(yaml.safe_load(f) or {}))
        items = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                k, v = (part.strip() for part in line.split(":", 1))
                items.append(f"{k}={v}")
    return _apply_overrides(VtraceConfig(), items)


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--config", type=str, default=None,
                   help="yaml file of VtraceConfig fields")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    p.add_argument("overrides", nargs="*",
                   help="key=value config overrides")
    # Flags may come after overrides (a launcher puts its own
    # ``broker=``/``savedir=`` first and the user's arguments after).
    args = p.parse_intermixed_args()
    cfg = _load_config(args.config) if args.config else VtraceConfig()
    cfg = _apply_overrides(cfg, args.overrides)
    rows = train(cfg, device=args.device)
    # The hand-written kernels this peer launched (none if it never
    # loaded them): a launcher reads its peers' counts from this line.
    kernels = sys.modules.get("moolib_tpu_torch.ops._kernels")
    report = json.dumps({
        "updates": int(rows[-1]["updates"]) if rows else 0,
        "kernel_launches": {} if kernels is None else {
            k.name: k.launches for k in kernels.KERNELS},
    })
    # One write, line and newline together: a launcher's peers share its
    # stdout, and print() writes the two apart on an unbuffered stream,
    # where another peer's line can land between them.
    sys.stdout.flush()
    sys.stdout.write(report + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
