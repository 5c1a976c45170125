"""Remote actors, central learner: the SEED-style split over the RPC
plane; the counterpart of :mod:`moolib_tpu.examples.remote_actors` on one
card.

- The **learner** peer owns the model and the card: it serves ``infer``
  with ``define(batch_size=..., pad=True)``, so concurrent actor calls are
  stacked into one forward (actors never hold parameters), and drains
  complete unrolls from ``define_queue("unroll")`` into the learn
  ``Batcher`` that feeds the IMPALA/V-trace update.
- **Actors** are thin: a local EnvPool for stepping, RPC calls for the
  policy and for shipping unrolls. Any number may connect or leave;
  inference batching right-sizes to whoever is present.

Where the reference is JAX-specific: the model's parameters are updated in
place by the train step, so ``infer`` copies them into a policy module of
its own under the state lock (on the card the copy is ordered on the
stream before the next update), and samples with a
:class:`torch.Generator` of its own per call, seeded from a counter
advanced under the same lock: a given seed replays the same action
sequence bit for bit on the same device.

Run (one learner, then any number of actors; the learner on the card
unless ``--device cpu``)::

    python -m moolib_tpu_torch.examples.remote_actors --role learner \\
        --listen 0.0.0.0:4440
    python -m moolib_tpu_torch.examples.remote_actors --role actor \\
        --learner tcp://HOST:4440
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import create_uid
from ..envpool import EnvPool, WorkerDied, step_with_retry
from ..rpc import Rpc, RpcError
from ..telemetry import publish_metrics
from .common import EnvBatchState
from .envs import make_env_fn

__all__ = ["RemoteConfig", "make_infer_fn", "run_learner", "run_actor"]


def _call_seed(seed: int, call: int) -> int:
    """The seed of the ``call``-th infer's generator: independent streams
    for every (seed, call) pair."""
    return int(np.random.SeedSequence((seed, call)).generate_state(
        1, np.uint64)[0] >> 1)


def make_infer_fn(model, get_params: Callable[[], dict], seed: int,
                  lock: threading.Lock):
    """Build the batched-inference callable ``run_learner`` serves as
    ``infer(obs, done) -> (actions, logits)``.

    A copy of ``model`` runs the forward on a snapshot of
    ``get_params()`` (a name -> tensor dict of the model's parameters),
    copied into it under ``lock`` together with this call's number:
    infer runs on RPC threads, and each call must sample from a fresh
    random stream of its own (a shared generator, drawn from by two
    threads at once, would break the replay). A given ``seed`` replays
    the same action sequence bit for bit on the same device. Calls to
    one infer run one at a time (the copy is its own)."""
    policy = copy.deepcopy(model).eval().requires_grad_(False)
    named = dict(policy.named_parameters())
    dev = next(iter(named.values())).device
    policy_lock = threading.Lock()
    calls = [0]

    @torch.no_grad()
    def infer(obs, done):
        # Stacked across actors by define(batch_size=): obs arrives
        # [n_calls, B_env, ...]. Both batch dims merge into the model's B
        # and the replies unmerge; pad=True keeps n_calls fixed.
        obs = np.asarray(obs)
        done = np.asarray(done)
        n, b = done.shape
        x = torch.from_numpy(np.ascontiguousarray(
            obs.reshape((n * b,) + obs.shape[2:]))).to(dev)
        d = torch.from_numpy(np.ascontiguousarray(
            done.reshape(n * b))).to(dev)
        with policy_lock:
            with lock:
                for k, v in get_params().items():
                    named[k].copy_(v)
                call = calls[0]
                calls[0] += 1
            gen = torch.Generator(device=dev).manual_seed(
                _call_seed(seed, call))
            (logits, _), _ = policy(x[None], d[None], ())
            logits = logits[0]
            probs = torch.softmax(logits.float(), dim=-1)
            a = torch.multinomial(probs, 1, generator=gen)[:, 0]
            return (a.cpu().numpy().reshape(n, b),
                    logits.float().cpu().numpy().reshape(n, b, -1))

    return infer


@dataclasses.dataclass
class RemoteConfig:
    env: str = "cartpole"
    num_actions: int = 2
    actor_batch_size: int = 4     # envs per actor process
    num_env_processes: int = 2
    unroll_length: int = 20
    infer_batch_size: int = 8     # max actor calls stacked per forward
    learn_batch_size: int = 8     # envs per learner update
    total_updates: int = 100_000
    max_seconds: Optional[float] = None
    learning_rate: float = 6e-4
    grad_clip: float = 40.0
    log_interval: float = 5.0
    seed: int = 0


def _make_model(cfg: RemoteConfig, device, generator):
    from ..models import A2CNet, ImpalaNet

    if cfg.env == "cartpole":
        return A2CNet(2, 4, hidden_sizes=(64, 64), device=device,
                      generator=generator)
    if cfg.env == "synthetic" or cfg.env.startswith("ALE/"):
        return ImpalaNet(cfg.num_actions, device=device, generator=generator)
    # Dict observations and other frame shapes belong to the vtrace
    # experiment, which has the full env -> model wiring.
    raise ValueError(
        f"remote_actors supports cartpole/synthetic/ALE envs, not "
        f"{cfg.env!r}"
    )


def run_learner(cfg: RemoteConfig, listen: str = "127.0.0.1:0",
                log_fn=print, ready_fn=None, device=None,
                stop_event: Optional[threading.Event] = None) -> List[dict]:
    """Serve inference, consume unrolls and train. ``ready_fn(addr)`` (if
    given) fires once every service is registered: use it to hand the
    bound address to actors race-free. ``device`` None means the card,
    and raises without one. ``stop_event``, when set, ends the run like
    ``cfg.max_seconds`` (a caller that lets its actors finish first: an
    actor whose call is in flight when the learner closes waits out the
    RPC timeout)."""
    from ..learner import (
        ImpalaConfig,
        make_impala_train_step,
        make_train_state,
    )
    from ..ops import Batcher, stage_batch
    from ..optim import ClippedRMSprop
    from ..utils import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    net = _make_model(cfg, device, gen).train()
    opt = ClippedRMSprop(net.parameters(), cfg.learning_rate, decay=0.99,
                         eps=0.01, max_norm=cfg.grad_clip)
    state = make_train_state(net, opt)
    state_lock = threading.Lock()
    step_fn = make_impala_train_step(config=ImpalaConfig())
    infer = make_infer_fn(net, lambda: dict(net.named_parameters()),
                          cfg.seed + 1, state_lock)

    rpc = Rpc("learner")
    rpc.listen(listen)
    rpc.define("infer", infer, batch_size=cfg.infer_batch_size, pad=True)

    batcher = Batcher(
        batch_size=cfg.learn_batch_size, dim=1, dims={"core_state": 0}
    )
    unroll_q = rpc.define_queue("unroll")
    stop = threading.Event()

    def drain_unrolls():
        while not stop.is_set():
            try:
                return_cb, args, _kw = unroll_q.get(timeout=0.5)
            except TimeoutError:
                continue
            except RpcError:
                return  # queue closed
            # Backpressure: hold the ack while the learner lags. Each
            # actor keeps one un-acked ship in flight, so this bounds the
            # Batcher's backlog; the timeout only bounds shutdown.
            while not batcher.wait_below(8, timeout=0.5):
                if stop.is_set():
                    break
            batcher.cat(args[0])
            return_cb(True)

    drainer = threading.Thread(target=drain_unrolls, daemon=True)
    drainer.start()

    # Announce only now: every service above is registered, so the first
    # actor request can never race define() and find no function.
    addr = rpc.debug_info()["listen"][0]
    log_fn(f"learner listening on {addr}")
    if ready_fn is not None:
        ready_fn(addr)

    logs: List[dict] = []
    updates = 0
    frames = 0
    metrics = None
    t0 = time.monotonic()
    last_log = t0
    try:
        while updates < cfg.total_updates and (
            cfg.max_seconds is None or time.monotonic() - t0 < cfg.max_seconds
        ) and not (stop_event is not None and stop_event.is_set()):
            try:
                batch = batcher.get(timeout=0.1)
            except TimeoutError:
                continue
            batch = stage_batch(batch, device)
            with state_lock:
                state, metrics = step_fn(state, batch)
            updates += 1
            frames += cfg.unroll_length * cfg.learn_batch_size
            now = time.monotonic()
            if now - last_log >= cfg.log_interval:
                last_log = now
                row = {
                    "updates": updates,
                    "frames": frames,
                    "total_loss": float(metrics["total_loss"]),
                    "fps": frames / (now - t0),
                }
                logs.append(row)
                # Scrapeable progress: the learner Rpc's __telemetry
                # scrape shows loss and fps beside the wire metrics.
                publish_metrics(row, prefix="train",
                                example="remote_actors")
                log_fn(
                    "updates {updates:>6}  frames {frames:>9}  "
                    "loss {total_loss:8.4f}  fps {fps:8.0f}".format(**row)
                )
        # Final flush: the loop publishes only on log ticks; a scrape
        # after exit shows the totals the learner reached.
        if updates:
            now = time.monotonic()
            publish_metrics(
                {
                    "updates": updates,
                    "frames": frames,
                    "total_loss": float(metrics["total_loss"]),
                    "fps": frames / max(now - t0, 1e-9),
                },
                prefix="train", example="remote_actors",
            )
    finally:
        stop.set()
        drainer.join(timeout=5)
        batcher.close()
        rpc.close()
    return logs


def run_actor(cfg: RemoteConfig, learner_addr: str,
              max_seconds: Optional[float] = None) -> int:
    """Thin actor: local envs, remote policy (the actor holds no
    parameters). Returns env frames stepped."""
    rpc = Rpc(f"actor-{create_uid()[:8]}")
    rpc.connect(learner_addr)

    pool = EnvPool(
        make_env_fn(cfg.env, num_actions=cfg.num_actions),
        num_processes=cfg.num_env_processes,
        batch_size=cfg.actor_batch_size,
        num_batches=2,
    )
    bs = [EnvBatchState(cfg.unroll_length, ()) for _ in range(2)]
    actions = [np.zeros(cfg.actor_batch_size, np.int64) for _ in range(2)]
    futures = [pool.step(i, actions[i]) for i in range(2)]
    frames = 0
    deadline = (
        None if max_seconds is None else time.monotonic() + max_seconds
    )
    pending_ship = None
    try:
        while deadline is None or time.monotonic() < deadline:
            try:
                for i in range(2):
                    # Bounded wait: a dead env worker surfaces as an
                    # error. WorkerDied is retry-safe (supervised respawn,
                    # exactly-once same-action retry).
                    try:
                        out = futures[i].result(timeout=300.0)
                    except WorkerDied:
                        out = step_with_retry(
                            pool, i, actions[i], timeout=300.0
                        )
                    unroll = bs[i].observe(out)
                    if unroll is not None:
                        # Ship the completed unroll; keep at most one in
                        # flight (backpressure against a slow learner).
                        if pending_ship is not None:
                            pending_ship.result(timeout=60)
                        pending_ship = rpc.async_("learner", "unroll", unroll)
                    a, logits = rpc.sync(
                        "learner", "infer", out["obs"], out["done"]
                    )
                    bs[i].record_action(np.asarray(a), np.asarray(logits), ())
                    actions[i][:] = a
                    futures[i] = pool.step(i, actions[i])
                    frames += cfg.actor_batch_size
            except RpcError:
                break  # learner gone: stop cleanly, keep the frame count
    finally:
        pool.close()
        rpc.close()
    return frames


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--role", choices=("learner", "actor"), required=True)
    p.add_argument("--listen", default="127.0.0.1:0")
    p.add_argument("--learner", default=None,
                   help="learner address (actor role)")
    p.add_argument("--env", default="cartpole")
    p.add_argument("--num-actions", type=int, default=2)
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="the learner's torch device (default: the card; "
                        "'cpu' to run on the CPU)")
    args = p.parse_args()
    cfg = RemoteConfig(
        env=args.env, num_actions=args.num_actions,
        max_seconds=args.max_seconds,
    )
    if args.role == "learner":
        run_learner(cfg, listen=args.listen, device=args.device)
    else:
        if not args.learner:
            p.error("--learner required for actor role")
        run_actor(cfg, args.learner, max_seconds=args.max_seconds)


if __name__ == "__main__":
    main()
