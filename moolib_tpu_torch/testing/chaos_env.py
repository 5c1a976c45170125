"""The env of the env-tier chaos scenarios, in a module of its own.

An :class:`~moolib_tpu_torch.envpool.EnvPool` pickles its env factory
into spawn workers, so every worker imports the module that defines the
env. This one imports numpy and the standard library only: a worker that
steps it pulls in neither torch nor the RPC stack, and a respawn costs
no torch import (the wedge and kill scenarios time their watchdogs
around respawns).
"""

import time

import numpy as np

__all__ = ["ChaosStepEnv"]


class ChaosStepEnv:
    """Deterministic env for the env-tier chaos scenarios (module-level so
    it pickles into spawn workers): obs ``[seed, t, last_action]``,
    episodes never terminate (so ``episode_step`` counts exactly-once
    stepping), an optional fixed per-step sleep (so process faults land
    mid-slice), and an optional poison index — that env raises forever
    once ``t`` reaches ``poison_at`` (a genuinely broken env, the
    quarantine class)."""

    def __init__(self, index: int, sleep_s: float = 0.0,
                 poison: "int | None" = None, poison_at: int = 1):
        self.seed = index
        self.t = 0
        self.sleep_s = sleep_s
        self.poison = poison
        self.poison_at = poison_at
        self.broken = False

    def reset(self):
        self.t = 0
        return self._obs(-1), {}

    def step(self, action):
        if self.sleep_s:
            time.sleep(self.sleep_s)
        if self.poison == self.seed and self.t >= self.poison_at:
            self.broken = True  # stays broken across auto-reset attempts
        if self.broken:
            raise RuntimeError(f"poison env {self.seed} at t={self.t}")
        self.t += 1
        return self._obs(int(action)), 1.0, False, False, {}

    def _obs(self, last_action):
        return np.array([self.seed, self.t, last_action], np.float32)

    def close(self):
        pass
