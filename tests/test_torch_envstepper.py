"""The port's EnvPoolServer and RemoteEnvStepper over the port's Rpc, and
across packages: the wire is shared, so a port client steps a reference
server and a reference client steps a port server, with the same results
as a local pool."""

import os
import signal
import time

import numpy as np
import pytest

from fake_env import FakeEnv, SlowEnv
from moolib_tpu_torch.envpool import EnvPool, EnvPoolServer, RemoteEnvStepper
from moolib_tpu_torch.rpc import Rpc, RpcError


def _pkg(name):
    """(EnvPool, EnvPoolServer, RemoteEnvStepper, Rpc) of a package."""
    if name == "port":
        return EnvPool, EnvPoolServer, RemoteEnvStepper, Rpc
    from moolib_tpu.envpool import EnvPool as P, EnvPoolServer as S
    from moolib_tpu.envpool import RemoteEnvStepper as C
    from moolib_tpu.rpc import Rpc as R

    return P, S, C, R


class _Served:
    def __init__(self, pkg, env=FakeEnv, num_batches=2, **server_kw):
        pool_cls, server_cls, _, rpc_cls = _pkg(pkg)
        self.pool = pool_cls(env, num_processes=2, batch_size=4,
                             num_batches=num_batches, restart_backoff=0.05)
        self.rpc = rpc_cls("env-server")
        self.rpc.listen("127.0.0.1:0")
        self.server = server_cls(self.rpc, self.pool, **server_kw)
        self.addr = self.rpc.debug_info()["listen"][0]
        self.clients = []

    def client(self, pkg, name):
        _, _, stepper_cls, rpc_cls = _pkg(pkg)
        rpc = rpc_cls(name)
        rpc.connect(self.addr)
        stepper = stepper_cls(rpc, "env-server")
        self.clients.append((rpc, stepper))
        return stepper

    def close(self):
        for rpc, stepper in self.clients:
            stepper.close()
            rpc.close()
        self.server.close()
        self.rpc.close()
        self.pool.close()


def test_two_port_clients_step_one_port_pool_concurrently():
    served = _Served("port")
    try:
        a, b = served.client("port", "actor-a"), served.client("port",
                                                               "actor-b")
        assert {a.batch_index, b.batch_index} == {0, 1}
        assert a.batch_size == 4 and a.num_batches == 2
        for step in range(10):
            fa = a.step(np.zeros(4, np.int64))
            fb = b.step(np.ones(4, np.int64))
            ra, rb = fa.result(timeout=60), fb.result(timeout=60)
            for r in (ra, rb):
                assert r["obs"].shape == (4, 3)
        # The buffers share the envs: each served step advanced them once.
        assert (np.maximum(ra["episode_step"], rb["episode_step"]) >= 1).all()
        with pytest.raises(RuntimeError, match="already registered"):
            EnvPoolServer(served.rpc, served.pool)
    finally:
        served.close()


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("ref", "port"), ("port", "ref")])
def test_a_client_of_one_package_steps_a_server_of_the_other(server_pkg,
                                                             client_pkg):
    """Every served step equals a local pool's step of the same envs and
    actions, bit for bit."""
    served = _Served(server_pkg, num_batches=1)
    rng = np.random.default_rng(0)
    try:
        stepper = served.client(client_pkg, "actor")
        with EnvPool(FakeEnv, num_processes=2, batch_size=4) as local:
            for _ in range(12):
                a = rng.integers(0, 5, 4)
                got = stepper.step(a).result(timeout=60)
                want = local.step(0, a).result(timeout=60)
                for k in want:
                    g = np.asarray(got[k])
                    assert g.dtype == want[k].dtype, k
                    assert g.tobytes() == want[k].tobytes(), k
    finally:
        served.close()


def test_lease_reclaim_and_stale_step_refused():
    served = _Served("port", num_batches=1, lease_timeout=0.5)
    try:
        a = served.client("port", "actor-a")
        a.step(np.zeros(4, np.int64)).result(timeout=60)
        time.sleep(0.7)  # actor-a goes silent past its lease
        b = served.client("port", "actor-b")  # reclaims buffer 0
        assert b.batch_index == 0
        b.step(np.zeros(4, np.int64)).result(timeout=60)
        with pytest.raises(RpcError, match="not owned"):
            a.step(np.zeros(4, np.int64), retry=False).result(60)
        reg = served.rpc.telemetry.registry
        assert reg.value("envpool_lease_reclaims_total", pool="envpool") == 1
    finally:
        served.close()


def test_retrying_future_survives_a_worker_death():
    """A served step whose worker is killed comes back as the typed
    WorkerDied wire error; the client's future retries it on the same
    lease and the surviving slice is stepped exactly once."""
    served = _Served("port", env=SlowEnv, num_batches=1)
    try:
        c = served.client("port", "actor")
        a = np.zeros(4, np.int64)
        pre = np.array(c.step(a).result(timeout=60)["episode_step"])
        fut = c.step(a)
        time.sleep(0.05)
        os.kill(served.pool._procs[0].pid, signal.SIGKILL)
        out = fut.result(timeout=60)
        assert (out["episode_step"][2:] == pre[2:] + 1).all()
        assert (out["episode_step"][:2] == 1).all()
        assert c.retries_total >= 1 and "WorkerDied" in c.last_error
    finally:
        served.close()
