"""Port parity: the membership broker of moolib_tpu_torch and its CLI.

The reference's Group members (on reference Rpcs) agree on membership,
reduce and heal through a port Broker, which holds the port's broker to
the reference's membership protocol on the wire. The CLI prints the one
address line launchers parse. Every wait has a timeout of its own.
"""

import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import pytest

from moolib_tpu.rpc import Rpc as RefRpc
from moolib_tpu.rpc.group import Group
from moolib_tpu_torch.rpc import Rpc
from moolib_tpu_torch.rpc.broker import DEFAULT_PORT, Broker

REPO_ROOT = Path(__file__).resolve().parent.parent


def _broker_pump(ref):
    while True:
        self = ref()
        if self is None or self._stop.is_set():
            return
        self.broker.update()
        del self
        time.sleep(0.05)


class Cluster:
    """A port Broker and reference Group members, all in-process."""

    def __init__(self):
        self.broker_rpc = Rpc("broker")
        self.broker_rpc.listen("127.0.0.1:0")
        self.addr = self.broker_rpc.debug_info()["listen"][0]
        self.broker = Broker(self.broker_rpc)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_broker_pump, args=(weakref.ref(self),), daemon=True
        )
        self._thread.start()
        self.clients = []
        self._closed = False

    def spawn(self, name):
        rpc = RefRpc(name)
        rpc.listen("127.0.0.1:0")
        rpc.connect(self.addr)
        g = Group(rpc, broker_name="broker", group_name="g", timeout=5.0)
        self.clients.append((rpc, g))
        return rpc, g

    def wait_members(self, n, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for _, g in self.clients:
                g.update()
            if all(len(g.members) == n and g.active()
                   for _, g in self.clients) and len(
                       {g.sync_id for _, g in self.clients}) == 1:
                return
            time.sleep(0.02)
        raise TimeoutError(f"group never stabilized at {n} members")

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=5)
        assert not self._thread.is_alive()
        for rpc, g in self.clients:
            g.close()
            rpc.close()
        self.broker_rpc.close()


@pytest.fixture
def cluster():
    c = Cluster()
    yield c
    c.close()


def test_reference_members_agree_on_membership_through_a_port_broker(cluster):
    for i in range(3):
        cluster.spawn(f"peer-{i}")
    cluster.wait_members(3)
    for _, g in cluster.clients:
        assert sorted(g.members) == ["peer-0", "peer-1", "peer-2"]
    assert sorted(g.rank for _, g in cluster.clients) == [0, 1, 2]
    futs = [g.all_reduce("sum", float(i + 1))
            for i, (_, g) in enumerate(cluster.clients)]
    assert [f.result(timeout=10) for f in futs] == [6.0, 6.0, 6.0]


def test_dead_member_expires_and_the_group_heals(cluster):
    for i in range(4):
        cluster.spawn(f"peer-{i}")
    cluster.wait_members(4)
    dead_rpc, dead_g = cluster.clients.pop(-1)
    dead_g.close()
    dead_rpc.close()
    cluster.wait_members(3, timeout=20.0)
    futs = [g.all_reduce("heal", 2.0) for _, g in cluster.clients]
    for f in futs:
        assert f.result(timeout=10) == pytest.approx(6.0)


def test_broker_cli_loop(monkeypatch):
    import moolib_tpu_torch.broker as cli

    calls = {"n": 0}

    class FakeBroker:
        def __init__(self, rpc):
            pass

        def update(self):
            calls["n"] += 1
            if calls["n"] >= 3:
                raise KeyboardInterrupt

    class FakeRpc:
        def __init__(self, name):
            pass

        def listen(self, addr):
            calls["addr"] = addr

        def debug_info(self):
            return {"listen": ["tcp://x"]}

        def close(self):
            calls["closed"] = True

    monkeypatch.setattr(cli, "Broker", FakeBroker)
    monkeypatch.setattr(cli, "Rpc", FakeRpc)
    cli.main(["--interval", "0.001"])
    assert calls == {"n": 3, "addr": f"0.0.0.0:{DEFAULT_PORT}",
                     "closed": True}


def test_broker_cli_prints_the_address_line():
    """``python -m moolib_tpu_torch.broker`` prints the reference's
    address line, which a reference member can dial."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "moolib_tpu_torch.broker", "127.0.0.1:0"],
        cwd=str(REPO_ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
    )
    got = {}
    reader = threading.Thread(
        target=lambda: got.setdefault("line", proc.stdout.readline()),
        daemon=True,
    )
    reader.start()
    try:
        reader.join(timeout=60)
        assert not reader.is_alive(), "the CLI printed no line in 60 s"
        line = got["line"]
        assert line.startswith("moolib_tpu broker listening on "), line
        addr = line.rsplit(" ", 1)[-1].strip()
        assert addr.startswith("tcp://127.0.0.1:")
        member = RefRpc("cli-member")
        try:
            member.set_timeout(20.0)
            member.connect(addr)
            # The broker's own endpoint answers over the wire.
            reply = member.async_("broker", "__telemetry").result(timeout=20)
            assert reply["name"] == "broker"
        finally:
            member.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
