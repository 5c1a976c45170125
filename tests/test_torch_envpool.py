"""The port's EnvPool against the reference's, and its supervision.

The parity cases run a port pool and a reference pool on the same env
factory and action script and compare every key of every step bit for
bit. The rest mirrors the reference's supervision cases on the port:
a killed worker, a SIGSTOP'd one, a poison env, device staging.

Env workers import the module that defines their env factory. This
module keeps its top-level imports to numpy, pytest and the port's env
tier (the reference package and torch are imported inside the tests), so
the probe env defined here can tell what a worker imports."""

import functools
import os
import signal
import sys
import time

import numpy as np
import pytest

from fake_env import DictObsEnv, FakeEnv, PoisonEnv, SlowEnv
from moolib_tpu_torch.envpool import (EnvPool, EnvStepper, WorkerDied,
                                      step_with_retry)

_PROBED = ("jax", "flax", "optax", "ml_dtypes", "moolib_tpu", "torch")


class ModuleProbeEnv:
    """Observes, per name in _PROBED, whether its worker has imported it."""

    def __init__(self, seed: int):
        self.seed = seed

    def _obs(self):
        return np.array([any(m == p or m.startswith(p + ".")
                             for m in sys.modules) for p in _PROBED])

    def reset(self):
        return self._obs(), {}

    def step(self, action):
        return self._obs(), 0.0, False, False, {}


def _ref_pool(*args, **kwargs):
    from moolib_tpu.envpool import EnvPool as RefPool

    return RefPool(*args, **kwargs)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _lockstep(env_fn, B, W, steps, num_actions, seed=0, **kwargs):
    """Step a port and a reference pool with the same double-buffered
    action script; every key of every step equal bit for bit."""
    rng = np.random.default_rng(seed)
    with EnvPool(env_fn, num_processes=W, batch_size=B, num_batches=2,
                 **kwargs) as port, \
            _ref_pool(env_fn, num_processes=W, batch_size=B, num_batches=2,
                      **kwargs) as ref:
        for step in range(steps):
            b = step % 2
            a = rng.integers(0, num_actions, B)
            fp, fr = port.step(b, a), ref.step(b, a)
            p, r = fp.result(timeout=30), fr.result(timeout=30)
            assert sorted(p) == sorted(r)
            for k in r:
                _same(p[k], r[k])


@pytest.mark.parametrize("env_fn", [FakeEnv, DictObsEnv],
                         ids=["array-obs", "dict-obs"])
def test_pool_matches_the_reference_pool(env_fn):
    _lockstep(env_fn, B=8, W=4, steps=40, num_actions=5)


@pytest.mark.parametrize("native", [True, False], ids=["native", "pipe"])
def test_pool_of_synthetic_atari_matches_the_reference_pool(native,
                                                             monkeypatch):
    """The examples' pixel env (the port's own copy in the port's pool,
    the reference's in the reference's), on both data planes."""
    from moolib_tpu.envpool import pool as ref_pool_mod
    from moolib_tpu.examples import envs as ref_envs
    from moolib_tpu_torch.envpool import pool as port_pool_mod
    from moolib_tpu_torch.examples import envs as port_envs

    if not native:
        monkeypatch.setattr(port_pool_mod, "_get_native", lambda: None)
        monkeypatch.setattr(ref_pool_mod, "_get_native", lambda: None)
    kw = dict(num_actions=6, episode_length=7)
    rng = np.random.default_rng(1)
    with EnvPool(functools.partial(port_envs.create_synthetic_atari, **kw),
                 num_processes=2, batch_size=4) as port, \
            _ref_pool(functools.partial(ref_envs.create_synthetic_atari, **kw),
                      num_processes=2, batch_size=4) as ref:
        assert (port._ctrl is None) == (not native)
        for step in range(16):
            a = rng.integers(0, 6, 4)
            p = port.step(step % 2, a).result(timeout=30)
            r = ref.step(step % 2, a).result(timeout=30)
            for k in r:
                _same(p[k], r[k])


def test_workers_import_neither_jax_nor_the_reference_nor_torch():
    with EnvPool(ModuleProbeEnv, num_processes=2, batch_size=2) as pool:
        obs = np.array(pool.step(0, np.zeros(2, np.int64)).result(
            timeout=30)["obs"])  # a copy: the views die with the pool
    imported = {p: bool(obs[:, i].any()) for i, p in enumerate(_PROBED)}
    assert not any(imported.values()), imported


def test_busy_buffer_and_validation_errors():
    assert EnvStepper is EnvPool
    with pytest.raises(ValueError, match="divisible"):
        EnvPool(FakeEnv, num_processes=3, batch_size=4)
    with EnvPool(FakeEnv, num_processes=1, batch_size=2, num_batches=1) as pool:
        fut = pool.step(0, np.zeros(2, np.int64))
        with pytest.raises(RuntimeError, match="in flight"):
            pool.step(0, np.zeros(2, np.int64))
        fut.result(timeout=10)
        with pytest.raises(IndexError):
            pool.step(5, np.zeros(2, np.int64))
        with pytest.raises(ValueError, match="action shape"):
            pool.step(0, np.zeros(3, np.int64))


def test_device_cpu_staging_copies_out_of_the_segment():
    """device="cpu": tensors equal to the host pool's views, and copies:
    the buffer's next step does not change them."""
    import torch

    with EnvPool(FakeEnv, num_processes=2, batch_size=4, device="cpu") as dev, \
            EnvPool(FakeEnv, num_processes=2, batch_size=4) as host:
        a = np.arange(4)
        got = dev.step(0, a).result(timeout=10)
        want = {k: np.array(v) for k, v in
                host.step(0, a).result(timeout=10).items()}
        kept = {k: v.clone() for k, v in got.items()}
        for k, v in got.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            _same(v.numpy(), want[k])
        dev.step(0, a).result(timeout=10)  # overwrites the segment
        for k, v in got.items():
            assert torch.equal(v, kept[k]), k


def test_device_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EnvPool(FakeEnv, num_processes=1, batch_size=1, device="cuda")


def _retry_step(pool, b, a, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return pool.step(b, a).result(timeout=30)
        except WorkerDied:
            assert time.monotonic() < deadline, "pool never recovered"
            time.sleep(0.02)


def test_killed_worker_raises_worker_died_and_the_retry_is_exactly_once():
    pool = EnvPool(SlowEnv, num_processes=2, batch_size=4, num_batches=2,
                   restart_backoff=0.05, name="torch-kill")
    try:
        a = np.zeros(4, np.int64)
        pre = np.array(pool.step(0, a).result(timeout=30)["episode_step"])
        fut = pool.step(0, a)
        time.sleep(0.05)  # mid-batch: SlowEnv steps take 0.15 s each
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        with pytest.raises(WorkerDied) as ei:
            fut.result(timeout=30)
        assert ei.value.worker == 0
        assert fut.exception(timeout=0) is ei.value
        out = _retry_step(pool, 0, a)
        # The surviving slice advanced by exactly one step; the respawned
        # slice's fresh envs are on their first.
        assert (out["episode_step"][2:] == pre[2:] + 1).all()
        assert (out["episode_step"][:2] == 1).all()
        assert pool.step(1, a).result(timeout=30)["obs"].shape[0] == 4
    finally:
        pool.close()


def test_step_with_retry_steps_each_env_once():
    from moolib_tpu_torch.telemetry import global_telemetry

    pool = EnvPool(FakeEnv, num_processes=2, batch_size=4, num_batches=1,
                   restart_backoff=0.05, name="torch-helper")
    try:
        a = np.zeros(4, np.int64)
        pre = np.array(pool.step(0, a).result(timeout=30)["episode_step"])
        os.kill(pool._procs[1].pid, signal.SIGKILL)
        out = step_with_retry(pool, 0, a, timeout=30.0)
        assert (out["episode_step"][:2] == pre[:2] + 1).all()
        assert (out["episode_step"][2:] == 1).all()
        assert global_telemetry().registry.value(
            "envpool_respawns_total", pool="torch-helper") >= 1
    finally:
        pool.close()


def test_close_is_bounded_with_a_stopped_worker():
    pool = EnvPool(SlowEnv, num_processes=2, batch_size=2, num_batches=1,
                   close_timeout=2.0, name="torch-close")
    shm_name = pool._shm.name
    pool.step(0, np.zeros(2, np.int64)).result(timeout=30)
    fut = pool.step(0, np.zeros(2, np.int64))
    os.kill(pool._procs[1].pid, signal.SIGSTOP)
    t0 = time.monotonic()
    pool.close()
    assert time.monotonic() - t0 < 6.0
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=0)
    pool.close()  # idempotent
    assert not any(p.is_alive() for p in pool._procs)
    from multiprocessing import shared_memory as mp_shm

    with pytest.raises(FileNotFoundError):
        mp_shm.SharedMemory(name=shm_name)


def test_poison_env_is_quarantined_and_its_worker_survives():
    from moolib_tpu_torch.telemetry import global_telemetry

    pool = EnvPool(PoisonEnv, num_processes=2, batch_size=4, num_batches=1,
                   poison_threshold=2, name="torch-poison")
    try:
        a = np.ones(4, np.int64)
        deadline = time.monotonic() + 20
        while pool.quarantined() != (1,):
            assert time.monotonic() < deadline, "poison never quarantined"
            pool.step(0, a).result(timeout=30)
        out = pool.step(0, a).result(timeout=30)
        assert bool(out["done"][1]) and out["episode_step"][1] == 0
        assert out["episode_step"][0] > 0
        reg = global_telemetry().registry
        assert reg.value("envpool_quarantined_total", pool="torch-poison") == 1
        assert reg.value("envpool_worker_deaths_total", pool="torch-poison",
                         kind="exit") is None
    finally:
        pool.close()
