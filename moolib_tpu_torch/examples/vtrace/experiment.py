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

- the data-parallel mesh is one device: the port's learner steps take no
  ``mesh`` (ROADMAP.md queue A, item 11);
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
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ... import create_uid
from ...envpool import EnvPool, WorkerDied, step_with_retry
from ...telemetry import StepScope, publish_metrics
from ...utils import HostStaged, resolve_device, stage_host_async
from .. import common
from .. import envs as env_factories
from ..common import EnvBatchState, StatMean, StatSum, Stats
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
    model: str = "auto"  # auto | mlp | resnet | transformer
    transformer_mlp: str = "dense"  # dense (moe is not ported yet)
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
    from ...models import A2CNet, ImpalaNet, TransformerNet

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
        raise NotImplementedError(
            "model='nethack' (NetHackNet) is not ported yet (ROADMAP.md "
            "queue A, item 8)"
        )
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
            mlp=cfg.transformer_mlp, device=device, generator=generator,
        )
    if model == "resnet":
        return ImpalaNet(
            num_actions, obs_shape, use_lstm=cfg.use_lstm,
            compute_dtype=dtype, device=device, generator=generator,
        )
    raise ValueError(f"unknown model {cfg.model!r}")


def _host(x):
    """A staged metric or action as a host tensor (waits for its copy)."""
    return x.result() if isinstance(x, HostStaged) else x


def train(cfg: VtraceConfig, log_fn=print, device=None) -> List[dict]:
    """Run the experiment; returns the logged rows. ``device`` None means
    the card, and raises without one: pass ``device="cpu"`` to run on the
    CPU."""
    device = resolve_device(device)

    from ...learner import (
        ImpalaConfig,
        load_train_state,
        make_act_step,
        make_apply_step,
        make_grad_step,
        make_train_state,
        train_state_to_host,
    )
    from ...ops import Batcher, stage_batch
    from ...optim import ClippedRMSprop
    from ...parallel import Accumulator, GlobalStatsAccumulator
    from ...rpc import Rpc
    from ...utils import Checkpointer
    from ...utils.profiling import StepWindowProfiler

    # --- model / learner ---------------------------------------------------
    # One generator on the device: it draws the weights, then the actions.
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
    # Phase attribution for this loop: the steps are scoped through the
    # learner factories (act / fwd_bwd / optimizer), the wait-shaped
    # phases (env_wait / host_sync / grad_allreduce / checkpoint) are
    # explicit below.
    scope = StepScope("vtrace_learner")
    act = make_act_step(net, stepscope=scope)
    # grad_scale folds the x batch_size "sum contribution" scaling into
    # the step, so the update loop never touches gradient values on the
    # host.
    grad_step = make_grad_step(
        config=loss_cfg, grad_scale=float(cfg.learn_batch_size),
        stepscope=scope,
    )
    # apply_step updates the parameters and the optimizer's state in
    # place. get_state runs on Accumulator RPC threads (requestState
    # service) against the same state, so reading it and the apply must
    # be mutually exclusive — state_lock below. Lock order is always
    # accumulator._lock -> state_lock; nothing under state_lock takes the
    # accumulator's lock back.
    apply_step = make_apply_step(stepscope=scope)
    state_lock = threading.Lock()

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
        nonlocal state
        with state_lock:
            state = load_train_state(state, payload["state"])

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
            window["total_loss"] += float(_host(m["total_loss"]))
            window["entropy"] += float(_host(m["entropy"]))
            window["grad_norm"] += float(_host(m["grad_norm"]))

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
                            _host(x) for x in
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
                            batch = stage_batch(learn_batcher.get(), device)
                            grads, metrics = grad_step(state.model, batch)
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
                        # Up pinned and non-blocking, before the apply.
                        mean_grads = stage_batch(mean_grads, device)
                        # Atomic with the state hand-off: a get_state on an
                        # RPC thread must never read a half-applied update.
                        with state_lock:
                            state = apply_step(state, mean_grads)
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
    return logs


def _apply_overrides(cfg: VtraceConfig, overrides: List[str]) -> VtraceConfig:
    """``key=value`` CLI overrides onto the dataclass."""
    values = dataclasses.asdict(cfg)
    for item in overrides:
        if "=" not in item:
            raise SystemExit(f"override {item!r} is not key=value")
        k, v = item.split("=", 1)
        k = k.replace("-", "_")
        if k not in values:
            raise SystemExit(f"unknown config key {k!r}")
        field_type = type(values[k]) if values[k] is not None else str
        if field_type is bool:
            values[k] = v.lower() in ("1", "true", "yes")
        elif values[k] is None:
            values[k] = v
        else:
            values[k] = field_type(v)
    return VtraceConfig(**values)


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--config", type=str, default=None,
                   help="yaml file of VtraceConfig fields (needs PyYAML)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    p.add_argument("overrides", nargs="*",
                   help="key=value config overrides")
    args = p.parse_args()
    values = {}
    if args.config:
        import yaml

        with open(args.config) as f:
            values = yaml.safe_load(f) or {}
    cfg = _apply_overrides(VtraceConfig(**values), args.overrides)
    train(cfg, device=args.device)


if __name__ == "__main__":
    main()
