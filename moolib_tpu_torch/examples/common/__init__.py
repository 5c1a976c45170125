"""Rollout bookkeeping shared by the examples; the counterpart of
:mod:`moolib_tpu.examples.common`.

``EnvBatchState`` turns a stream of per-step EnvPool outputs + actions into
time-major learn-unrolls of the layout the learner expects
(:func:`moolib_tpu_torch.learner.impala_loss` batch contract): frames
overlap by one step so frame T of one unroll is frame 0 of the next, giving
every unroll its bootstrap frame for free. Frames, actions and logits are
host numpy arrays; the core state is kept as the act step returned it (an
LSTM's ``(c, h)`` stays on the card), so a learn batch mixes host and card
leaves, which :func:`~moolib_tpu_torch.utils.nest.cat_fields` and
:func:`~moolib_tpu_torch.ops.stage_batch` handle without a host sync.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np

from ...utils import nest  # noqa: F401  (re-export)
from ...utils.stats import StatMax, StatMean, StatSum, Stats

__all__ = [
    "EnvBatchState",
    "InProcessBroker",
    "StatMean",
    "StatSum",
    "StatMax",
    "Stats",
    "host_result",
    "nest",
    "obs_from_env_out",
]

_ENV_OUT_RESERVED = ("action", "reward", "done", "episode_step",
                     "episode_return")


def obs_from_env_out(env_out):
    """Extract the observation from an EnvPool step dict: a bare array when
    the env observes a single array (key 'obs'), else the dict of obs
    fields (NLE-style dict observations)."""
    obs_keys = [k for k in env_out if k not in _ENV_OUT_RESERVED]
    if obs_keys == ["obs"]:
        return env_out["obs"]
    return {k: env_out[k] for k in obs_keys}


def host_result(x):
    """A metric or action staged by :func:`~moolib_tpu_torch.utils.
    stage_host_async` as a host tensor (waits for its copy); anything
    else as it is."""
    from ...utils import HostStaged

    return x.result() if isinstance(x, HostStaged) else x


def _broker_pump_entry(wref, stop, interval):
    """Broker-pump thread entry (the weakref thread contract): holds the
    InProcessBroker only for one update tick, so an abandoned broker is
    still collectable instead of being pinned forever by its own pump
    thread."""
    while not stop.is_set():
        b = wref()
        if b is None:
            return
        b._broker.update()
        del b
        stop.wait(interval)


class InProcessBroker:
    """Broker on a background thread, for single-process runs
    (reference: the a2c example starts its own Broker in-process,
    examples/a2c.py:268-275)."""

    def __init__(self, update_interval: float = 0.05):
        from ...rpc import Rpc
        from ...rpc.broker import Broker

        self.rpc = Rpc("broker")
        self.rpc.listen("127.0.0.1:0")
        self.address = self.rpc.debug_info()["listen"][0]
        self._broker = Broker(self.rpc)
        self._closed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_broker_pump_entry,
            args=(weakref.ref(self), self._stop, update_interval),
            daemon=True,
        )
        self._thread.start()

    def close(self):
        if self._closed:  # the close() idempotence contract
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=5)
        self.rpc.close()


class EnvBatchState:
    """Per-EnvPool-batch rollout state: RNN core state, frame/action buffers,
    episode-return tracking.

    Protocol, once per pool step (one `i` of the double buffer)::

        out = pool.step(i, actions).result()       # frame t arrives
        unroll = state.observe(out)                # may complete an unroll
        if unroll is not None: learn_batcher.cat(unroll)
        a, logits, core = act(obs, done, state.core_state, generator)
        state.record_action(a, logits, core)
        actions = a
    """

    def __init__(self, unroll_length: int, initial_core_state: Any):
        self.T = unroll_length
        self.core_state = initial_core_state  # state at the newest frame
        self._unroll_start_state = initial_core_state  # state at buffered frame 0
        self._frames: List[Dict[str, np.ndarray]] = []
        self._actions: List[np.ndarray] = []
        self._logits: List[np.ndarray] = []
        # Episode stats harvested from done transitions, drained by
        # recent_returns()/recent_lengths().
        self._completed_returns: List[float] = []
        self._completed_lengths: List[float] = []

    def observe(self, env_out: Dict[str, np.ndarray]) -> Optional[Dict]:
        """Feed one EnvPool output dict (frame t); returns a completed
        time-major unroll every ``unroll_length`` frames, else None."""
        done = np.asarray(env_out["done"])
        if done.any():
            rets = np.asarray(env_out["episode_return"])[done]
            steps = np.asarray(env_out["episode_step"])[done]
            self._completed_returns.extend(float(r) for r in rets)
            self._completed_lengths.extend(float(s) for s in steps)
            # Bound both buffers: callers that never drain one must not
            # leak memory over millions of episodes.
            if len(self._completed_returns) > 10_000:
                del self._completed_returns[:-1_000]
            if len(self._completed_lengths) > 10_000:
                del self._completed_lengths[:-1_000]
        obs = obs_from_env_out(env_out)
        # Copy: EnvPool returns zero-copy views over shared memory that the
        # next step into this buffer will overwrite.
        frame = {
            "obs": nest.map_structure(np.array, obs),
            "done": np.array(done),
            "rewards": np.asarray(env_out["reward"], np.float32).copy(),
        }
        self._frames.append(frame)
        if len(self._frames) < self.T + 1:
            return None
        assert len(self._actions) == self.T, (
            f"{len(self._actions)} actions for {len(self._frames)} frames"
        )
        unroll = {
            "obs": nest.map_structure(
                lambda *xs: np.stack(xs), *[f["obs"] for f in self._frames]
            ),
            "done": np.stack([f["done"] for f in self._frames]),
            "rewards": np.stack([f["rewards"] for f in self._frames]),
            "actions": np.stack(self._actions).astype(np.int32),
            "behavior_logits": np.stack(self._logits),
            "core_state": self._unroll_start_state,
        }
        # Frame T becomes frame 0 of the next unroll (bootstrap overlap).
        self._frames = [self._frames[-1]]
        self._actions = []
        self._logits = []
        self._unroll_start_state = self.core_state
        return unroll

    def record_action(self, action, behavior_logits, new_core_state=None):
        """Record the action taken at the newest frame (and the core state
        that acting produced, which belongs to the *next* frame). The
        action and logits are host arrays (or host tensors); the core
        state is kept as given."""
        self._actions.append(np.asarray(action))
        self._logits.append(np.asarray(behavior_logits, np.float32))
        if new_core_state is not None:
            self.core_state = new_core_state

    def recent_returns(self, clear: bool = True) -> List[float]:
        out = self._completed_returns
        if clear:
            self._completed_returns = []
        return out

    def recent_lengths(self, clear: bool = True) -> List[float]:
        out = self._completed_lengths
        if clear:
            self._completed_lengths = []
        return out
