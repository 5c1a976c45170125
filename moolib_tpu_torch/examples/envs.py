"""Environment factories for the examples; the port's own copy of
:mod:`moolib_tpu.examples.envs` (numpy only, so the port imports nothing
of the JAX package). Same seeds, same frames, bit for bit.

- :class:`CartPole` — the classic cart-pole dynamics in numpy, so the
  examples and tests run with no env package; gymnasium's is used instead
  when present (same observation/action/reward contract).
- :class:`SyntheticAtari` — an Atari-shaped pixel env (84x84x4 uint8,
  discrete actions) with a learnable cue→action signal, for driving the
  whole pixel pipeline without ALE ROMs; :class:`SyntheticProcgen` and
  :class:`SyntheticNetHack` are the ProcGen- and NetHack-shaped stand-ins.
- :func:`create_atari` — the real ALE path (needs ale_py), with
  gymnasium's AtariPreprocessing and 4-frame stacking.

This module must stay import-light (numpy only, gymnasium lazily): EnvPool
workers import it on spawn, and worker startup cost is pool startup cost.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = [
    "CartPole",
    "SyntheticAtari",
    "SyntheticNetHack",
    "SyntheticProcgen",
    "create_cartpole",
    "create_synthetic_atari",
    "create_atari",
    "create_nethack",
    "create_procgen",
    "make_env_fn",
]


class CartPole:
    """CartPole-v1 dynamics (Barto-Sutton-Anderson), gymnasium-compatible API.

    Physics constants and termination bounds match gymnasium's CartPole-v1 so
    the built-in fallback and the gymnasium path are interchangeable.
    """

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    THETA_LIMIT = 12 * 2 * math.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    observation_size = 4
    num_actions = 2

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float64)
        self._steps = 0
        self._needs_reset = True

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        self._needs_reset = False
        return self._state.astype(np.float32), {}

    def step(self, action):
        if self._needs_reset:
            raise RuntimeError("step() called before reset()")
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costheta, sintheta = math.cos(theta), math.sin(theta)
        total_mass = self.MASSCART + self.MASSPOLE
        polemass_length = self.MASSPOLE * self.LENGTH

        temp = (
            force + polemass_length * theta_dot**2 * sintheta
        ) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH
            * (4.0 / 3.0 - self.MASSPOLE * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1

        terminated = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
        )
        truncated = self._steps >= self.MAX_STEPS
        self._needs_reset = terminated or truncated
        return (
            self._state.astype(np.float32),
            1.0,
            terminated,
            truncated,
            {},
        )


class SyntheticAtari:
    """Atari-shaped pixel env with a learnable signal.

    Observation: [84, 84, C] uint8. A cue patch in the top-left corner
    encodes which of ``num_actions`` actions yields reward +1 this step
    (wrong actions yield 0); the rest of the frame is procedural noise that
    scrolls with the episode step, so the policy must read the cue, not
    memorize frames. Episodes end after ``episode_length`` steps. Optimal
    mean reward per step is 1.0; a uniform policy gets 1/num_actions.
    """

    def __init__(
        self,
        num_actions: int = 6,
        channels: int = 4,
        size: int = 84,
        episode_length: int = 200,
        seed: Optional[int] = None,
    ):
        self.num_actions = num_actions
        self.channels = channels
        self.size = size
        self.episode_length = episode_length
        self._rng = np.random.default_rng(seed)
        # Fixed noise bank; frames index into it so stepping is cheap.
        self._noise = self._rng.integers(
            0, 255, size=(8, size, size, channels), dtype=np.uint8
        )
        self._cue = 0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        frame = self._noise[self._steps % len(self._noise)].copy()
        # Cue patch: rows 0-7, one 8-wide column band per action, all channels.
        frame[:8, :, :] = 0
        c0 = self._cue * 8
        frame[:8, c0 : c0 + 8, :] = 255
        return frame

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._steps = 0
        self._cue = int(self._rng.integers(self.num_actions))
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._cue else 0.0
        self._steps += 1
        self._cue = int(self._rng.integers(self.num_actions))
        terminated = False
        truncated = self._steps >= self.episode_length
        return self._obs(), reward, terminated, truncated, {}


class SyntheticProcgen(SyntheticAtari):
    """ProcGen-shaped pixel env: 64x64x3 uint8, 15 discrete actions
    (BASELINE.md benchmark config 4: IMPALA on ProcGen with ResNet encoder —
    same learnable-cue protocol as :class:`SyntheticAtari` so the pipeline
    can be exercised and benchmarked without the procgen package)."""

    def __init__(self, num_actions: int = 15, episode_length: int = 500,
                 seed: Optional[int] = None):
        super().__init__(
            num_actions=num_actions, channels=3, size=64,
            episode_length=episode_length, seed=seed,
        )

    def _obs(self) -> np.ndarray:
        frame = self._noise[self._steps % len(self._noise)].copy()
        # 15 actions x 4-wide cue bands fit the 64-px row.
        frame[:8, :, :] = 0
        c0 = self._cue * 4
        frame[:8, c0 : c0 + 4, :] = 255
        return frame


class SyntheticNetHack:
    """NetHack-shaped dict-observation env (BASELINE.md benchmark config 5:
    R2D2-style LSTM policy on NLE — recurrent rollout batching).

    Observation dict mirrors NLE's core keys: ``glyphs`` [21, 79] int16 and
    ``blstats`` [27] float32. A cue glyph row encodes which action yields
    reward this step, so an LSTM policy has a learnable signal without the
    nle package installed.
    """

    DUNGEON_SHAPE = (21, 79)
    BLSTATS_SIZE = 27
    NUM_GLYPHS = 5976  # nle.nethack.MAX_GLYPH

    def __init__(self, num_actions: int = 23, episode_length: int = 400,
                 seed: Optional[int] = None):
        self.num_actions = num_actions
        self.episode_length = episode_length
        self._rng = np.random.default_rng(seed)
        self._glyph_bank = self._rng.integers(
            0, self.NUM_GLYPHS, size=(8,) + self.DUNGEON_SHAPE, dtype=np.int16
        )
        self._cue = 0
        self._steps = 0

    def _obs(self):
        glyphs = self._glyph_bank[self._steps % 8].copy()
        glyphs[0, :] = 0
        glyphs[0, self._cue * 3 : self._cue * 3 + 3] = 42  # cue glyphs
        blstats = np.zeros(self.BLSTATS_SIZE, np.float32)
        blstats[0] = self._steps
        blstats[1] = self._cue
        return {"glyphs": glyphs, "blstats": blstats}

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._steps = 0
        self._cue = int(self._rng.integers(self.num_actions))
        return self._obs(), {}

    def step(self, action):
        reward = 1.0 if int(action) == self._cue else 0.0
        self._steps += 1
        self._cue = int(self._rng.integers(self.num_actions))
        return (
            self._obs(), reward, False,
            self._steps >= self.episode_length, {},
        )


def create_procgen(env_name: str = "coinrun", index: int = 0,
                   num_actions: int = 15):
    """ProcGen factory: the real gym3 env when procgen is installed, else
    the synthetic ProcGen-shaped stand-in (same contract).

    Only a missing package falls back; any other failure (typo'd env name,
    API mismatch) RAISES — silently training on the synthetic env while
    reporting "ProcGen" numbers would be worse than failing.
    """
    try:
        import gym
        import procgen  # noqa: F401
    except ImportError:
        return SyntheticProcgen(num_actions=num_actions, seed=index)

    env = gym.make(
        f"procgen:procgen-{env_name}-v0", start_level=index,
        num_levels=0, distribution_mode="easy",
    )

    class _Gym21:  # procgen ships the old gym API; adapt to gymnasium's
        num_actions = env.action_space.n

        def reset(self, seed=None):
            return env.reset(), {}

        def step(self, action):
            # No internal auto-reset: the EnvPool worker owns the reset
            # on done (doubling it would burn a level generation and
            # skip an episode per boundary).
            obs, reward, done, info = env.step(int(action))
            return obs, float(reward), bool(done), False, info

    return _Gym21()


def create_nethack(index: int = 0, num_actions: int = 23):
    """NetHack factory: the real NLE env when nle is installed, else the
    synthetic NetHack-shaped stand-in (same dict-obs contract). Only a
    missing package falls back; real-env construction errors raise."""
    try:
        import gymnasium
        import nle  # noqa: F401
    except ImportError:
        return SyntheticNetHack(num_actions=num_actions, seed=index)

    env = gymnasium.make("NetHackScore-v0",
                         observation_keys=("glyphs", "blstats"))
    env.reset(seed=index)
    return env


def make_env_fn(env: str, num_actions: int = 6, episode_length: int = 200):
    """Single source for example env selection (shared by the a2c and
    vtrace entry points): "cartpole" | "synthetic" | "nethack" |
    "procgen[:name]" | an ALE id."""
    import functools

    if env == "cartpole":
        return create_cartpole
    if env == "synthetic":
        return functools.partial(
            create_synthetic_atari,
            num_actions=num_actions,
            episode_length=episode_length,
        )
    if env == "nethack":
        return functools.partial(create_nethack, num_actions=num_actions)
    if env == "procgen" or env.startswith("procgen:"):
        name = env.split(":", 1)[1] if ":" in env else "coinrun"
        return functools.partial(
            create_procgen, name, num_actions=num_actions
        )
    return functools.partial(create_atari, env)


def create_cartpole(index: int = 0, prefer_gymnasium: bool = True):
    """CartPole factory for EnvPool (picklable, per-env seeding by index)."""
    if prefer_gymnasium:
        try:
            import gymnasium

            env = gymnasium.make("CartPole-v1")
            env.reset(seed=index)
            return env
        except Exception:
            pass
    return CartPole(seed=index)


def create_synthetic_atari(
    index: int = 0, num_actions: int = 6, episode_length: int = 200
):
    return SyntheticAtari(
        num_actions=num_actions, episode_length=episode_length, seed=index
    )


def create_atari(
    game: str = "ALE/Breakout-v5",
    index: int = 0,
    frame_stack: int = 4,
    noop_max: int = 30,
):
    """Real ALE Atari with seed_rl-style preprocessing (reference:
    examples/atari/environment.py + atari_preprocessing.py — noops applied
    before frameskip, grayscale 84x84, 4-frame stack). Requires ale_py."""
    try:
        import ale_py  # noqa: F401
        import gymnasium
        from gymnasium.wrappers import AtariPreprocessing
    except ImportError as e:
        raise ImportError(
            "create_atari requires gymnasium + ale_py (ALE ROMs); use "
            "create_synthetic_atari for an Atari-shaped env without them"
        ) from e
    env = gymnasium.make(game, frameskip=1)
    env = AtariPreprocessing(
        env, noop_max=noop_max, frame_skip=4, screen_size=84
    )
    try:
        from gymnasium.wrappers import FrameStackObservation

        env = FrameStackObservation(env, frame_stack)
    except ImportError:  # older gymnasium
        from gymnasium.wrappers import FrameStack

        env = FrameStack(env, frame_stack)

    class _ChannelsLast(gymnasium.ObservationWrapper):
        """Frame stacking stacks on a new LEADING axis; the models and
        the EnvPool layout are channels-last [84, 84, C]."""

        def __init__(self, env):
            super().__init__(env)
            old = env.observation_space
            self.observation_space = gymnasium.spaces.Box(
                low=np.moveaxis(old.low, 0, -1),
                high=np.moveaxis(old.high, 0, -1),
                dtype=old.dtype,
            )

        def observation(self, obs):
            return np.moveaxis(np.asarray(obs), 0, -1)

    env = _ChannelsLast(env)
    env.reset(seed=index)
    return env
