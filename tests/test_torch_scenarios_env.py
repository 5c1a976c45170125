"""Port parity: the env tier's chaos scenarios (``ChaosStepEnv``,
``EnvFleet``, ``envpool_worker_kill``, ``envpool_wedge``,
``envpool_poison``): the port's ProcChaos signals the port's own EnvPool
workers, served to a RemoteEnvStepper over the port's Rpc.

Each scenario runs with its reference test's seed (tests/test_chaos.py)
and must return that test's summary on two runs with one event log.
``ChaosStepEnv`` lives in a module whose imports hold no torch: a spawn
worker that unpickles it imports neither torch nor JAX nor the reference
package.
"""

import functools
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from moolib_tpu_torch.testing import scenarios
from moolib_tpu_torch.testing.chaos_env import ChaosStepEnv
from test_torch_scenarios_wire import replayed

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name, seed, want", [
    ("envpool_worker_kill", 606, {"proc_kill": 1}),
    ("envpool_wedge", 707, {"proc_stop": 1}),
    ("envpool_poison", 808, {}),
])
def test_env_scenario_replays_its_pinned_log(monkeypatch, name, seed, want):
    (s1, log1), (s2, log2) = replayed(monkeypatch, name, seed)
    assert s1 == s2 == want
    assert log1 == log2
    assert [e[1] for e in log1] == [k for k, n in want.items()
                                    for _ in range(n)]


_FRESH = r"""
import json, pickle, sys
env_fn = pickle.loads(bytes.fromhex(sys.argv[1]))
env = env_fn(2)
obs, _ = env.reset()
print(json.dumps({"obs": obs.tolist(), "bad": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "moolib_tpu"))}))
"""


def test_chaos_step_env_unpickles_without_torch_jax_or_the_reference():
    """What a spawn worker does with the pickled factory, in a fresh
    interpreter: the env's module chain imports no torch, no JAX and
    nothing of the reference package."""
    blob = pickle.dumps(functools.partial(ChaosStepEnv, sleep_s=0.0))
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, blob.hex()], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"obs": [2.0, 0.0, -1.0], "bad": []}
    assert scenarios.ChaosStepEnv is ChaosStepEnv


def test_envpool_of_chaos_step_envs_steps_on_the_cpu():
    """An EnvPool of ChaosStepEnv workers: obs [index, t, last action],
    every env stepped once per call, a poisoned index quarantined as a
    terminal row."""
    from moolib_tpu_torch.envpool import EnvPool

    with EnvPool(functools.partial(ChaosStepEnv, poison=3), num_processes=2,
                 batch_size=4, poison_threshold=1) as pool:
        for t in range(1, 4):
            out = pool.step(0, np.full(4, t, np.int64)).result(timeout=60)
            obs = np.array(out["obs"], copy=True)
            steps = np.array(out["episode_step"], copy=True)
        # The worker's report rides its pipe to the pool's drain thread.
        scenarios._await(lambda: pool.quarantined() == (3,), 30,
                         "poison env never reported quarantined")
    np.testing.assert_array_equal(obs[:3], [[0, 3, 3], [1, 3, 3], [2, 3, 3]])
    np.testing.assert_array_equal(steps, [3, 3, 3, 0])
