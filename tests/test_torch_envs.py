"""The port's copy of the examples' envs against the reference's: the
same seeds and actions give the same observations, rewards and episode
ends, bit for bit, over three episodes of each env."""

import numpy as np
import pytest

from moolib_tpu.examples import envs as ref_envs
from moolib_tpu_torch.examples import envs as port_envs

ENVS = {
    "CartPole": (lambda m, s: m.CartPole(seed=s), 2),
    "SyntheticAtari": (lambda m, s: m.SyntheticAtari(seed=s), 6),
    "SyntheticProcgen": (lambda m, s: m.SyntheticProcgen(seed=s), 15),
    "SyntheticNetHack": (lambda m, s: m.SyntheticNetHack(seed=s), 23),
}


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(ENVS))
@pytest.mark.parametrize("seed", [0, 5])
def test_env_matches_the_reference_over_three_episodes(name, seed):
    make, num_actions = ENVS[name]
    ref, port = make(ref_envs, seed), make(port_envs, seed)
    _same(ref.reset()[0], port.reset()[0])
    rng = np.random.default_rng(seed)
    episodes = steps = 0
    while episodes < 3:
        a = int(rng.integers(num_actions))
        r_out, p_out = ref.step(a), port.step(a)
        for r, p in zip(r_out[:4], p_out[:4]):
            _same(r, p)
        steps += 1
        if r_out[2] or r_out[3]:
            episodes += 1
            _same(ref.reset()[0], port.reset()[0])
    assert steps >= 3


@pytest.mark.parametrize("env", ["cartpole", "synthetic", "nethack",
                                 "procgen", "procgen:coinrun"])
def test_make_env_fn_builds_the_same_env(env):
    ref = ref_envs.make_env_fn(env)(index=3)
    port = port_envs.make_env_fn(env)(index=3)
    assert type(ref).__name__ == type(port).__name__
    _same(ref.reset()[0], port.reset()[0])
    for a in (0, 1, 1, 0):
        for r, p in zip(ref.step(a)[:4], port.step(a)[:4]):
            _same(r, p)


def test_create_cartpole_falls_back_to_the_builtin_env():
    env = port_envs.create_cartpole(7, prefer_gymnasium=False)
    assert isinstance(env, port_envs.CartPole)
    _same(env.reset()[0],
          ref_envs.create_cartpole(7, prefer_gymnasium=False).reset()[0])


def test_atari_factory_needs_ale():
    try:
        import ale_py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ale_py"):
            port_envs.create_atari()
        return
    assert port_envs.create_atari().reset()[0].shape == (84, 84, 4)
