"""Single-file A2C on CartPole with an in-process Broker and the elastic
Accumulator; the counterpart of :mod:`moolib_tpu.examples.a2c` on one
card.

As in the reference: an :class:`~moolib_tpu_torch.EnvPool` steps the envs
(double-buffered), :class:`~moolib_tpu_torch.examples.common.
EnvBatchState` cuts unrolls from its outputs, and each update is split
compute -> reduce -> apply around the
:class:`~moolib_tpu_torch.Accumulator`, so more peers can join the same
broker at any time and the virtual batch fills from all of them (run two
copies of this script with ``--broker tcp://HOST:PORT``).

Where the reference is JAX-specific:

- the model is built on ``device`` from ``cfg.seed`` with a
  :class:`torch.Generator`, which then samples the actions;
- optax's ``clip_by_global_norm`` then ``adam(eps=cfg.adam_eps)`` is
  :class:`~moolib_tpu_torch.optim.ClippedAdam`;
- the apply step updates the model and the optimizer's state in place
  (what the reference's donation buys), under the state lock that the
  state hand-off (``get_state``/``set_state``) also takes;
- the pixel variant (``env="synthetic"`` or an ALE id) builds the
  ``ImpalaNet`` in bf16 on the card and in f32 on the CPU (the reference
  picks bf16 on the TPU and f32 elsewhere).

Run (on the card unless ``--device cpu``):
``python -m moolib_tpu_torch.examples.a2c [--total-steps N] [--use-lstm]``
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import create_uid
from ..envpool import EnvPool, WorkerDied, step_with_retry
from ..telemetry import StepScope, publish_metrics
from ..utils import resolve_device, stage_host_async
from .common import (
    EnvBatchState,
    InProcessBroker,
    StatMean,
    StatSum,
    Stats,
    host_result,
)

__all__ = ["A2CConfig", "train", "a2c_loss"]


@dataclasses.dataclass
class A2CConfig:
    """Defaults mirror the reference's (rollout 64, lr 1e-3, baseline cost
    0.005, entropy cost 0.0006, adam eps 3e-7)."""

    total_steps: int = 50_000
    # "cartpole" | "synthetic" (Atari-shaped pixels) | an ALE id
    env: str = "cartpole"
    num_actions: int = 6  # pixel envs only (cartpole is 2)
    unroll_length: int = 64
    batch_size: int = 4  # envs per peer
    num_processes: int = 2
    num_batches: int = 2  # double buffering
    use_lstm: bool = False
    hidden_size: int = 64
    learning_rate: float = 1e-3
    adam_eps: float = 3e-7
    discounting: float = 0.99
    entropy_cost: float = 0.0006
    baseline_cost: float = 0.005
    grad_clip: float = 40.0
    virtual_batch_size: Optional[int] = None  # default: one peer's batch
    # Commit gradient rounds with K-of-N contributions after the
    # straggler deadline (None = all); a standby broker address and name
    # enable member-driven failover.
    min_quorum: Optional[int] = None
    straggler_timeout: Optional[float] = None
    # When False, the step blocks on the gradient reduction right after
    # contributing (the wire wait on the critical path); the default
    # overlaps the reduction with the next rollout.
    overlap_comms: bool = True
    broker: Optional[str] = None  # None -> start an in-process broker
    broker_standby: Optional[str] = None  # standby broker address
    broker_standby_name: str = "broker2"
    group: str = "a2c"
    log_interval_steps: int = 4_000
    seed: int = 0

    @classmethod
    def from_fleet_spec(cls, spec, **overrides) -> "A2CConfig":
        """Derive the launch shape from a declarative
        :class:`~moolib_tpu_torch.fleet.spec.FleetSpec`: the env tier's
        worker count and the learner cohort's quorum/straggler/group knobs
        come from the spec — one validated value drives both the fleet
        controller and the training example. Everything else keeps its
        default unless overridden."""
        cfg = cls(
            num_processes=max(spec.env_workers.n, 1),
            min_quorum=spec.learners.min_quorum,
            straggler_timeout=spec.learners.straggler_timeout_s,
            group=spec.learners.group,
        )
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


def a2c_loss(model, apply_fn, batch, config):
    """A2C loss on a time-major unroll -> (total loss with its graph,
    detached metrics): n-step bootstrapped returns, the advantage policy
    gradient, the baseline's squared error and the entropy bonus.
    ``config`` is an :class:`~moolib_tpu_torch.learner.ImpalaConfig`, so
    this plugs into ``make_grad_step(loss_fn=...)``."""
    (logits, baseline), _ = apply_fn(
        model, batch["obs"], batch["done"], batch["core_state"])[:2]
    logits_t = logits[:-1]
    baseline_t = baseline[:-1]

    rewards = batch["rewards"][1:]
    if config.reward_clip > 0:
        rewards = torch.clamp(rewards, -config.reward_clip,
                              config.reward_clip)
    discounts = (~batch["done"][1:]).float() * config.discounting

    # The reverse scan of the returns, bootstrapped from the last frame.
    ret = baseline[-1].detach()
    returns = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        ret = rewards[t] + discounts[t] * ret
        returns[t] = ret
    returns = torch.stack(returns).detach()
    adv = returns - baseline_t.detach()

    logp = torch.log_softmax(logits_t, dim=-1)
    action_logp = torch.gather(
        logp, -1, batch["actions"].long()[..., None]).squeeze(-1)
    pg_loss = -torch.mean(action_logp * adv)
    baseline_loss = 0.5 * torch.mean((returns - baseline_t) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))

    total = (pg_loss + config.baseline_cost * baseline_loss
             - config.entropy_cost * entropy)
    metrics = {
        "total_loss": total,
        "pg_loss": pg_loss,
        "baseline_loss": baseline_loss,
        "entropy": entropy,
        "mean_baseline": torch.mean(baseline_t),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def _make_model(cfg: A2CConfig, device: torch.device,
                generator: torch.Generator):
    from ..models import A2CNet, ImpalaNet

    if cfg.env == "cartpole":
        return A2CNet(2, 4, hidden_sizes=(cfg.hidden_size, cfg.hidden_size),
                      use_lstm=cfg.use_lstm, lstm_size=cfg.hidden_size,
                      device=device, generator=generator)
    # Pixel A2C: the IMPALA ResNet torso with the same loss and update.
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return ImpalaNet(cfg.num_actions, use_lstm=cfg.use_lstm,
                     compute_dtype=dtype, device=device, generator=generator)


def train(cfg: A2CConfig, log_fn=print, device=None) -> List[dict]:
    """Train A2C; returns the logged stat rows. ``device`` None means the
    card, and raises without one: pass ``device="cpu"`` to run on the
    CPU."""
    device = resolve_device(device)

    from ..learner import (
        ImpalaConfig,
        load_train_state,
        make_act_step,
        make_apply_step,
        make_grad_step,
        make_train_state,
        train_state_to_host,
    )
    from ..ops import stage_batch
    from ..optim import ClippedAdam
    from ..parallel import Accumulator
    from ..rpc import Rpc
    from .envs import make_env_fn

    broker = None
    broker_addr = cfg.broker
    if broker_addr is None:
        broker = InProcessBroker()
        broker_addr = broker.address

    rpc = Rpc(f"a2c-{create_uid()[:8]}")
    rpc.listen("127.0.0.1:0")
    rpc.connect(broker_addr)

    # One generator on the device: it draws the weights, then the actions.
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    net = _make_model(cfg, device, gen).train()
    optimizer = ClippedAdam(net.parameters(), cfg.learning_rate,
                            eps=cfg.adam_eps, max_norm=cfg.grad_clip)
    state = make_train_state(net, optimizer)

    loss_cfg = ImpalaConfig(
        discounting=cfg.discounting,
        baseline_cost=cfg.baseline_cost,
        entropy_cost=cfg.entropy_cost,
        reward_clip=0.0,
    )
    act = make_act_step(net)
    grad_step = make_grad_step(
        config=loss_cfg, loss_fn=a2c_loss, grad_scale=float(cfg.batch_size),
    )
    # The apply updates the state in place. get_state runs on the
    # Accumulator's RPC threads against the same state, so reading it and
    # the apply exclude each other (state_lock). Lock order is always
    # accumulator._lock -> state_lock; nothing under state_lock takes the
    # accumulator's lock back.
    apply_step = make_apply_step()
    state_lock = threading.Lock()

    def get_state():
        with state_lock:
            return {"state": train_state_to_host(state),
                    "model_version": accumulator.model_version}

    def set_state(payload):
        nonlocal state
        with state_lock:
            state = load_train_state(state, payload["state"])

    accumulator = Accumulator(
        rpc,
        group_name=cfg.group,
        virtual_batch_size=cfg.virtual_batch_size or cfg.batch_size,
        get_state=get_state,
        set_state=set_state,
        min_quorum=cfg.min_quorum,
        straggler_timeout=cfg.straggler_timeout,
    )
    if cfg.broker_standby:
        # Member-driven broker failover: a dark primary is written off
        # after a few ping intervals and the standby adopts the epoch.
        rpc.connect(cfg.broker_standby)
        accumulator.group.set_broker_candidates(
            ["broker", cfg.broker_standby_name]
        )

    pool = EnvPool(
        make_env_fn(cfg.env, num_actions=cfg.num_actions),
        num_processes=cfg.num_processes,
        batch_size=cfg.batch_size,
        num_batches=cfg.num_batches,
        action_dtype=np.int64,
    )

    stats = Stats(
        env_steps=StatSum(),
        updates=StatSum(),
        skips=StatSum(),
        dropped_unrolls=StatSum(),
        mean_episode_return=StatMean(),
        total_loss=StatMean(),
        entropy=StatMean(),
    )
    logs: List[dict] = []

    batch_states = [
        EnvBatchState(cfg.unroll_length, net.initial_state(cfg.batch_size))
        for _ in range(cfg.num_batches)
    ]
    actions = [
        np.zeros(cfg.batch_size, np.int64) for _ in range(cfg.num_batches)
    ]
    pending_unrolls: List[dict] = []
    # Metrics on their way to the host, drained in bulk at log boundaries:
    # no blocking read per update on the training thread.
    pending_metrics: List[dict] = []

    def drain_metrics(keep_last: int = 0):
        while len(pending_metrics) > keep_last:
            m = pending_metrics.pop(0)
            stats["total_loss"] += float(host_result(m["total_loss"]))
            stats["entropy"] += float(host_result(m["entropy"]))

    env_steps = 0
    next_log = cfg.log_interval_steps
    futures = [pool.step(i, actions[i]) for i in range(cfg.num_batches)]
    # One ledger per loop iteration: env_wait, host_sync, fwd_bwd,
    # grad_allreduce, optimizer.
    scope = StepScope("a2c_learner")

    try:
        while env_steps < cfg.total_steps:
            with scope.step():
                for i in range(cfg.num_batches):
                    # Bounded wait: a dead env worker surfaces as an
                    # error. WorkerDied is retry-safe (the pool respawns
                    # the worker; a same-action retry is exactly-once per
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
                        pending_unrolls.append(unroll)
                        # Backpressure: never queue stale rollouts without
                        # bound while disconnected or the learner lags.
                        while len(pending_unrolls) > 4:
                            pending_unrolls.pop(0)
                            stats["dropped_unrolls"] += 1
                    now_in = stage_batch(
                        {"obs": out["obs"], "done": out["done"]}, device)
                    a, logits, core = act(now_in["obs"], now_in["done"],
                                          bs.core_state, gen)
                    with scope.phase("host_sync"):
                        # The actions must reach the host now to feed the
                        # pool's slab; the logits ride with them.
                        a, logits = (
                            host_result(x) for x in
                            stage_host_async((a, logits.float()))
                        )
                        a = a.numpy()
                        bs.record_action(a, logits.numpy(), core)
                    actions[i][:] = a
                    futures[i] = pool.step(i, actions[i])
                    env_steps += cfg.batch_size
                    stats["env_steps"] += cfg.batch_size

                accumulator.update()
                if accumulator.connected():
                    if accumulator.wants_gradients():
                        if pending_unrolls:
                            batch = stage_batch(pending_unrolls.pop(0),
                                                device)
                            with scope.phase("fwd_bwd"):
                                grads, metrics = grad_step(state.model,
                                                           batch)
                                pending_metrics.append(
                                    stage_host_async(metrics))
                            if len(pending_metrics) >= 64:
                                # Bound the backlog; all but the newest
                                # have had an update of transfer time.
                                drain_metrics(keep_last=1)
                            # grad_scale already turned the batch-mean
                            # gradients into the batch-sum contribution.
                            with scope.phase("grad_allreduce"):
                                accumulator.reduce_gradients(
                                    grads, batch_size=cfg.batch_size
                                )
                                if not cfg.overlap_comms:
                                    # Serialized on purpose: the wire
                                    # wait sits on the critical path.
                                    deadline = time.monotonic() + 60.0
                                    while (
                                        accumulator.connected()
                                        and not accumulator.has_gradients()
                                        and time.monotonic() < deadline
                                    ):
                                        accumulator.update()
                                        time.sleep(0.0005)
                        else:
                            accumulator.skip_gradients()
                            stats["skips"] += 1
                    if accumulator.has_gradients():
                        with scope.phase("optimizer"):
                            mean_grads, _count = \
                                accumulator.result_gradients()
                            mean_grads = stage_batch(mean_grads, device)
                            # Atomic with the state hand-off: a get_state
                            # on an RPC thread never reads a half-applied
                            # update.
                            with state_lock:
                                state = apply_step(state, mean_grads)
                            accumulator.zero_gradients()
                        stats["updates"] += 1

                for bs in batch_states:
                    for r in bs.recent_returns():
                        stats["mean_episode_return"] += r

                if env_steps >= next_log:
                    next_log += cfg.log_interval_steps
                    drain_metrics()
                    row = dict(stats.results(), env_steps=env_steps,
                               model_version=accumulator.model_version)
                    logs.append(row)
                    # Scrapeable progress: the row lands in the registry
                    # too, so a __telemetry scrape shows training state.
                    publish_metrics(row, prefix="train", example="a2c")
                    log_fn(
                        "steps {env_steps:>8}  return "
                        "{mean_episode_return:7.2f}  loss {total_loss:8.4f}"
                        "  entropy {entropy:6.3f}  updates {updates:g}"
                        .format(**row)
                    )
                    stats["mean_episode_return"].reset()
                    stats["total_loss"].reset()
                    stats["entropy"].reset()
    finally:
        scope.close()
        pool.close()
        accumulator.close()
        rpc.close()
        if broker is not None:
            broker.close()
    return logs


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--total-steps", type=int, default=A2CConfig.total_steps)
    p.add_argument("--env", type=str, default=A2CConfig.env,
                   help="cartpole | synthetic | an ALE id (ALE/Pong-v5)")
    p.add_argument("--num-actions", type=int, default=A2CConfig.num_actions,
                   help="action count for pixel envs")
    p.add_argument("--batch-size", type=int, default=A2CConfig.batch_size)
    p.add_argument("--unroll-length", type=int,
                   default=A2CConfig.unroll_length)
    p.add_argument("--num-processes", type=int,
                   default=A2CConfig.num_processes)
    p.add_argument("--learning-rate", type=float,
                   default=A2CConfig.learning_rate)
    p.add_argument("--use-lstm", action="store_true")
    p.add_argument("--broker", type=str, default=None,
                   help="tcp://HOST:PORT of a running broker; default starts "
                        "one in-process")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' to run "
                        "on the CPU)")
    args = p.parse_args()
    cfg = A2CConfig(
        total_steps=args.total_steps,
        env=args.env,
        num_actions=args.num_actions,
        batch_size=args.batch_size,
        unroll_length=args.unroll_length,
        num_processes=args.num_processes,
        learning_rate=args.learning_rate,
        use_lstm=args.use_lstm,
        broker=args.broker,
        seed=args.seed,
    )
    train(cfg, device=args.device)


if __name__ == "__main__":
    main()
