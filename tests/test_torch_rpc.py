"""Port parity: the RPC core of moolib_tpu_torch.

Two parts. The reference's loopback cases (tests/test_rpc.py, the
deadline cases of tests/test_serving.py) on pairs of port peers; then
cross-package pairs, a port peer and a reference peer calling each other
in both directions over tcp, unix sockets and the same-host shm lane,
which holds the port to the reference's wire: frames, function ids, the
greeting and the shm rendezvous. Every wait has a timeout of its own.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import moolib_tpu.rpc as ref_rpc
import moolib_tpu.telemetry as ref_tel
import moolib_tpu_torch.rpc as port_rpc
from moolib_tpu_torch.rpc import Future, Rpc, RpcError

WAIT = 20.0  # seconds: the bound of every wait below


def _unix_name(tag: str) -> str:
    """A unique abstract unix socket name (test files run in parallel)."""
    return f"unix:mltt-{tag}-{os.getpid()}-{os.urandom(4).hex()}"


def _close(*peers):
    for p in peers:
        p.close()


@pytest.fixture
def pair():
    host = Rpc("host")
    client = Rpc("client")
    host.set_timeout(WAIT)
    client.set_timeout(WAIT)
    host.listen("127.0.0.1:0")
    client.connect(host.debug_info()["listen"][0])
    yield host, client
    _close(client, host)


# -- the reference's loopback cases on port peers ----------------------------


def test_sync_call(pair):
    host, client = pair
    host.define("add", lambda a, b: a + b)
    assert client.sync("host", "add", 2, 3) == 5


def test_async_call_and_kwargs(pair):
    host, client = pair
    host.define("fmt", lambda x, suffix="!": f"{x}{suffix}")
    fut = client.async_("host", "fmt", "hi", suffix="?")
    assert fut.result(timeout=WAIT) == "hi?"
    assert fut.done()


def test_async_callback(pair):
    host, client = pair
    host.define("double", lambda x: 2 * x)
    got = {}
    ev = threading.Event()

    def cb(result, error):
        got["result"], got["error"] = result, error
        ev.set()

    client.async_callback("host", "double", cb, 21)
    assert ev.wait(WAIT)
    assert got == {"result": 42, "error": None}


def test_bidirectional(pair):
    host, client = pair
    host.define("ping", lambda: "pong")
    client.define("rping", lambda: "rpong")
    assert client.sync("host", "ping") == "pong"
    assert host.sync("client", "rping") == "rpong"


def test_remote_exception(pair):
    host, client = pair

    def boom():
        raise ValueError("kapow")

    host.define("boom", boom)
    with pytest.raises(RpcError, match="kapow"):
        client.sync("host", "boom")


def test_unknown_function(pair):
    _host, client = pair
    with pytest.raises(RpcError, match="not found"):
        # Deliberately undefined endpoint: the FNF path IS the test.
        client.sync("host", "nope")  # moolint: disable=rpc-endpoint-unknown


def test_unknown_peer_times_out():
    rpc = Rpc("lonely")
    rpc.set_timeout(0.5)
    try:
        with pytest.raises(RpcError, match="timed out"):
            # No such peer anywhere: the unknown-peer timeout is the test.
            rpc.async_("ghost", "fn").result(  # moolint: disable=rpc-endpoint-unknown
                timeout=WAIT)
    finally:
        rpc.close()


def _payloads():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 8)).astype(np.float32)
    return {
        "numpy": (a, a),
        "nested numpy": ({"x": rng.standard_normal((3, 3)),
                          "y": [np.int64(2), "s"]},) * 2,
        "torch": ({"t": torch.arange(12).reshape(3, 4),
                   "f": [torch.ones(2, 5), "s"]},
                  {"t": np.arange(12).reshape(3, 4),
                   "f": [np.ones((2, 5), np.float32), "s"]}),
        "bfloat16": (torch.full((4, 3), 1.5, dtype=torch.bfloat16),
                     torch.full((4, 3), 1.5, dtype=torch.bfloat16)),
    }


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("kind", sorted(_payloads()))
def test_tensor_payloads_echo(pair, kind):
    """Numpy leaves come back as numpy views, torch leaves as their numpy
    twins, bfloat16 as torch.bfloat16 tensors."""
    host, client = pair
    host.define("echo", lambda tree: tree)
    sent, want = _payloads()[kind]
    _assert_tree_equal(client.sync("host", "echo", sent), want)


class Slots:
    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __getstate__(self):
        return (self.a, self.b)

    def __setstate__(self, st):
        self.a, self.b = st

    def __eq__(self, other):
        return (self.a, self.b) == (other.a, other.b)


def test_pickled_custom_class(pair):
    host, client = pair
    host.define("echo2", lambda o: o)
    assert client.sync("host", "echo2", Slots(1, "z")) == Slots(1, "z")


def test_undefine_and_decorator(pair):
    host, client = pair

    @host.define("decorated")
    def decorated(x):
        return x + 1

    assert host.defined("decorated")
    assert client.sync("host", "decorated", 1) == 2
    host.undefine("decorated")
    assert not host.defined("decorated")
    with pytest.raises(RpcError, match="not found"):
        client.sync("host", "decorated", 1)


def test_concurrent_calls(pair):
    host, client = pair
    host.define("slow_id", lambda x: (time.sleep(0.01), x)[1])
    futs = [client.async_("host", "slow_id", i) for i in range(50)]
    assert [f.result(timeout=WAIT) for f in futs] == list(range(50))


def test_deferred_return(pair):
    host, client = pair
    pending = []
    host.define_deferred("later", lambda dr, x: pending.append((dr, x)))
    fut = client.async_("host", "later", 7)
    deadline = time.monotonic() + WAIT
    while not pending:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    dr, x = pending[0]
    assert not fut.done()
    dr(x * 10)
    assert fut.result(timeout=WAIT) == 70


def test_queue(pair):
    host, client = pair
    q = host.define_queue("qfn")
    fut = client.async_("host", "qfn", 5)
    return_cb, args, kwargs = q.get(timeout=WAIT)
    assert args == (5,) and kwargs == {}
    return_cb(args[0] + 1)
    assert fut.result(timeout=WAIT) == 6


def test_enqueue_on_rpc_queue_never_expires(pair):
    host, _client = pair
    host.set_timeout(0.2)
    q = host.define_queue("mixedq")
    q.enqueue("precious")
    time.sleep(0.5)
    assert q.get(timeout=5) == "precious"


@pytest.mark.parametrize("device", [None, "cpu"])
def test_batched_define(pair, device):
    """define(batch_size=) stacks concurrent calls; with device= the
    handler gets torch tensors there (the port's stage_batch), without
    it numpy, as in the reference."""
    host, client = pair
    calls = []

    def batched(x):
        calls.append((x.shape[0], type(x)))
        time.sleep(0.02)  # let later calls pile up into one batch
        return x * 2

    host.define("bdouble", batched, batch_size=8, device=device)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(3).astype(np.float32) for _ in range(16)]
    futs = [client.async_("host", "bdouble", x) for x in xs]
    for x, f in zip(xs, futs):
        np.testing.assert_allclose(f.result(timeout=WAIT), x * 2, rtol=1e-6)
    assert max(n for n, _ in calls) > 1
    want = np.ndarray if device is None else torch.Tensor
    assert all(t is want for _, t in calls), calls


def test_batched_define_pads_bfloat16_leaves(pair):
    host, client = pair
    shapes = []

    def fn(x):
        shapes.append(tuple(x.shape))
        return x.float() * 2

    host.define("bf", fn, batch_size=4, pad=True)
    x = torch.full((3,), 1.25, dtype=torch.bfloat16)
    out = client.async_("host", "bf", x).result(timeout=WAIT)
    np.testing.assert_array_equal(out, np.full(3, 2.5, np.float32))
    assert shapes == [(4, 3)]


def test_batched_queue_dynamic(pair):
    host, client = pair
    q = host.define_queue("bq", batch_size=4, dynamic_batching=True)
    futs = [client.async_("host", "bq", np.float32(i)) for i in range(6)]
    served = 0
    while served < 6:
        return_cb, args, _kwargs = q.get(timeout=WAIT)
        (vals,) = args
        return_cb(vals + 1)
        served += return_cb.batch_size
    for i, f in enumerate(futs):
        assert f.result(timeout=WAIT) == pytest.approx(i + 1)


def test_three_peer_discovery():
    a, b, c = Rpc("A"), Rpc("B"), Rpc("C")
    try:
        a.listen("127.0.0.1:0")
        b.listen("127.0.0.1:0")
        b.connect(a.debug_info()["listen"][0])
        c.connect(b.debug_info()["listen"][0])
        a.define("hello", lambda: "from A")
        assert c.async_("A", "hello").result(timeout=WAIT) == "from A"
    finally:
        _close(a, b, c)


def test_unix_transport():
    host, client = Rpc("uh"), Rpc("uc")
    addr = _unix_name("port")
    try:
        host.listen(addr)
        host.define("f", lambda: "ok")
        client.connect(addr)
        assert client.sync("uh", "f") == "ok"
        assert "unix" in client.debug_info()["peers"]["uh"]["connections"]
    finally:
        _close(client, host)


def test_debug_info(pair):
    host, client = pair
    host.define("n", lambda: None)
    client.sync("host", "n")
    info = client.debug_info()
    assert info["name"] == "client" and "host" in info["peers"]
    conns = info["peers"]["host"]["connections"]
    assert any(c["latency_ms"] >= 0 for c in conns.values())


def test_transport_bandit_explores():
    import types

    from moolib_tpu_torch.rpc import rpc as rpc_mod

    fast = types.SimpleNamespace(latency=types.SimpleNamespace(value=0.001))
    slow = types.SimpleNamespace(latency=types.SimpleNamespace(value=0.050))
    peer = types.SimpleNamespace(conns={"unix": fast, "tcp": slow})
    picks = {id(fast): 0, id(slow): 0}
    for _ in range(5000):
        picks[id(rpc_mod._best_conn(peer))] += 1
    assert picks[id(slow)] > 0
    assert picks[id(fast)] > picks[id(slow)] * 10


def test_future_timeout_validation_and_poll_semantics(pair):
    host, client = pair
    host.define("vadd", lambda a, b: a + b)
    fut = client.async_("host", "vadd", 1, 2)
    assert fut.result(timeout=WAIT) == 3
    assert fut.result(timeout=0) == 3 and fut.exception(timeout=0) is None
    pending = Future()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        pending.result(timeout=0)
    assert time.monotonic() - t0 < 1.0
    for bad in (-1, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="positive finite"):
            pending.result(timeout=bad)
        with pytest.raises(ValueError, match="positive finite"):
            pending.exception(timeout=bad)


@pytest.mark.parametrize("bad", [0, -0.5, float("inf"), float("nan")])
def test_timeout_validation(pair, bad):
    _host, client = pair
    with pytest.raises(ValueError, match="positive finite"):
        client.set_timeout(bad)
    with pytest.raises(ValueError, match="positive finite"):
        client.call_with_deadline("host", "dl.echo", bad, 1)


def test_call_with_deadline_propagates_budget(pair):
    host, client = pair
    seen = {}

    def handler(dr, x):
        seen["deadline"], seen["budget"] = dr.deadline, dr.budget
        dr(x * 2)

    host.define_deferred("dl.echo", handler)
    t0 = time.monotonic()
    assert client.call_with_deadline(
        "host", "dl.echo", 3.5, 21).result(timeout=WAIT) == 42
    assert seen["budget"] == pytest.approx(3.5)
    assert seen["deadline"] == pytest.approx(t0 + 3.5, abs=1.0)
    client.async_("host", "dl.echo", 1).result(timeout=WAIT)
    assert seen["budget"] is None and seen["deadline"] is None


def test_reroute_disabled_fails_fast_on_conn_loss():
    host = Rpc("ffhost")
    host.listen("127.0.0.1:0")
    host.define_deferred("ff.slow", lambda dr, x: None)  # never replies
    client = Rpc("ffclient")
    client.connect(host.debug_info()["listen"][0])
    try:
        fut = client.call_with_deadline("ffhost", "ff.slow", 20.0, 1)
        time.sleep(0.3)
        t0 = time.monotonic()
        host.close()
        with pytest.raises(RpcError, match="lost before reply"):
            fut.result(timeout=WAIT)
        assert time.monotonic() - t0 < 5.0
    finally:
        _close(client, host)


def test_executor_reads_the_ports_max_threads(monkeypatch):
    import moolib_tpu_torch

    monkeypatch.setattr(moolib_tpu_torch, "_max_threads", None)
    with pytest.raises(ValueError):
        moolib_tpu_torch.set_max_threads(0)
    moolib_tpu_torch.set_max_threads(3)
    assert moolib_tpu_torch.get_max_threads() == 3
    rpc = Rpc("threads")
    try:
        assert rpc._executor._max_workers == 3
    finally:
        rpc.close()


def test_group_and_allreduce_are_not_ported():
    # They are now: the package exports the port's own Group and
    # AllReduce (tests/test_torch_group.py drives them).
    assert port_rpc.Broker.__module__ == "moolib_tpu_torch.rpc.broker"
    for name in ("Group", "AllReduce"):
        assert getattr(port_rpc, name).__module__ == \
            "moolib_tpu_torch.rpc.group"
    with pytest.raises(AttributeError):
        port_rpc.NotAThing


# -- cross-package pairs ------------------------------------------------------

PKGS = {"port": port_rpc, "ref": ref_rpc}


def _wait_lane(rpc, peer: str) -> bool:
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        p = rpc._peers.get(peer)
        if p and "shm" in p.conns and not p.conns["shm"].is_closing():
            return True
        time.sleep(0.01)
    return False


def _cross_pair(client_pkg: str, host_pkg: str, transport: str):
    """A host of one package and a client of the other, joined over
    ``transport`` only (tcp, unix) or with the shm lane mounted."""
    host = PKGS[host_pkg].Rpc(f"x-host-{host_pkg}")
    client = PKGS[client_pkg].Rpc(f"x-client-{client_pkg}")
    for p in (host, client):
        p.set_timeout(WAIT)
        if transport != "shm":
            p.set_transports({transport})
    if transport == "unix":
        addr = _unix_name("cross")
        host.listen(addr)
    else:
        host.listen("127.0.0.1:0")
        addr = host.debug_info()["listen"][0]
    client.connect(addr)
    host.define("warm", lambda: "ok")
    assert client.async_(host.get_name(), "warm").result(timeout=WAIT) == "ok"
    if transport == "shm":
        assert _wait_lane(client, host.get_name())
        assert _wait_lane(host, client.get_name())
    return host, client


def _case_sync(host, client, hname, _pkg):
    host.define("add", lambda a, b: a + b)
    assert client.sync(hname, "add", 2, 3) == 5


def _case_async_kwargs(host, client, hname, _pkg):
    host.define("fmt", lambda x, suffix="!": f"{x}{suffix}")
    fut = client.async_(hname, "fmt", "hi", suffix="?")
    assert fut.result(timeout=WAIT) == "hi?"


def _case_tensor_nests(host, client, hname, client_pkg):
    rng = np.random.default_rng(3)
    tree = {"f32": rng.standard_normal((64, 33)).astype(np.float32),
            "nest": [np.arange(5), {"u8": np.ones((2, 2), np.uint8)}],
            "big": rng.standard_normal(1 << 18).astype(np.float32),
            "s": ("x", None, 2**70)}
    want = dict(tree)
    if client_pkg == "port":
        # Torch leaves from the port: numpy twins come back, and bf16
        # crosses as ml_dtypes on the reference side, torch here.
        tree["t"] = torch.arange(6.0).reshape(2, 3)
        want["t"] = np.arange(6.0, dtype=np.float32).reshape(2, 3)
        tree["bf"] = torch.full((3,), -2.5, dtype=torch.bfloat16)
        want["bf"] = tree["bf"]
    host.define("echo", lambda t: t)
    _assert_tree_equal(client.sync(hname, "echo", tree), want)


def _case_deferred(host, client, hname, _pkg):
    host.define_deferred("later", lambda dr, x: dr(x * 10))
    assert client.async_(hname, "later", 7).result(timeout=WAIT) == 70


def _case_queue(host, client, hname, _pkg):
    q = host.define_queue("qfn")
    fut = client.async_(hname, "qfn", 5)
    return_cb, args, kwargs = q.get(timeout=WAIT)
    assert args == (5,) and kwargs == {}
    return_cb(args[0] + 1)
    assert fut.result(timeout=WAIT) == 6


def _case_batched(host, client, hname, _pkg):
    def batched(x):
        time.sleep(0.02)
        return x * 2

    host.define("bdouble", batched, batch_size=4)
    xs = [np.full(3, i, np.float32) for i in range(10)]
    futs = [client.async_(hname, "bdouble", x) for x in xs]
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(f.result(timeout=WAIT), x * 2)


def _case_remote_exception(host, client, hname, _pkg):
    def boom():
        raise ValueError("kapow")

    host.define("boom", boom)
    with pytest.raises(PKGS_ERR[_pkg], match="kapow"):
        client.sync(hname, "boom")


def _case_unknown_function(host, client, hname, _pkg):
    with pytest.raises(PKGS_ERR[_pkg], match="not found"):
        # Deliberately undefined endpoint: the FNF path IS the test.
        client.sync(hname, "nope")  # moolint: disable=rpc-endpoint-unknown


def _case_deadline(host, client, hname, _pkg):
    seen = {}

    def handler(dr, x):
        seen["budget"] = dr.budget
        dr(x + 1)

    host.define_deferred("dl", handler)
    fut = client.call_with_deadline(hname, "dl", 4.0, 1)
    assert fut.result(timeout=WAIT) == 2
    assert seen["budget"] == pytest.approx(4.0)


def _case_bidirectional(host, client, hname, _pkg):
    client.define("rping", lambda: "rpong")
    assert host.sync(client.get_name(), "rping") == "rpong"


PKGS_ERR = {"port": port_rpc.RpcError, "ref": ref_rpc.RpcError}
CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_sync, _case_async_kwargs, _case_tensor_nests, _case_deferred,
    _case_queue, _case_batched, _case_remote_exception,
    _case_unknown_function, _case_deadline, _case_bidirectional)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("transport", ["tcp", "unix", "shm"])
@pytest.mark.parametrize("client_pkg,host_pkg", [("port", "ref"),
                                                 ("ref", "port")])
def test_cross_package_call(client_pkg, host_pkg, transport, case):
    host, client = _cross_pair(client_pkg, host_pkg, transport)
    try:
        CASES[case](host, client, host.get_name(), client_pkg)
        conns = client.debug_info()["peers"][host.get_name()]["connections"]
        if transport == "shm":
            assert "shm" in conns, conns
        else:
            assert set(conns) == {transport}, conns
    finally:
        _close(client, host)


@pytest.mark.parametrize("creator", ["port", "ref"])
def test_cross_package_shm_lane_carries_a_spill_frame(creator):
    """Either package may create the segment (the smaller peer id does):
    a 2 MB frame rides the lane both ways."""
    other = "ref" if creator == "port" else "port"
    host = PKGS[creator].Rpc("lane-host")
    client = PKGS[other].Rpc("lane-client")
    host._peer_id = "0" + host._peer_id[1:]
    client._peer_id = "f" + client._peer_id[1:]
    try:
        host.set_timeout(WAIT)
        client.set_timeout(WAIT)
        host.define("echo", lambda x: x)
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        client.sync("lane-host", "echo", 1)
        assert _wait_lane(client, "lane-host")
        assert _wait_lane(host, "lane-client")
        assert [e["lane"] for e in host._shm_pairs.values()][0].path \
            .startswith(os.path.join("/dev/shm", "moolib-tpu-torch-shm-"
                                     if creator == "port"
                                     else "moolib-tpu-shm-"))
        arr = np.arange(1 << 19, dtype=np.float32)
        reg = client.telemetry.registry
        for _ in range(5):  # the bandit may route one send over tcp
            np.testing.assert_array_equal(
                client.sync("lane-host", "echo", arr), arr)
            shm_out = reg.value("rpc_bytes_out_total", transport="shm") or 0
            if shm_out > arr.nbytes:
                break
        assert shm_out > arr.nbytes
    finally:
        _close(client, host)


@pytest.mark.parametrize("scraper_pkg,served_pkg", [("ref", "port"),
                                                    ("port", "ref")])
def test_telemetry_scrape_across_packages(scraper_pkg, served_pkg):
    """A peer of one package scrapes the other's __telemetry: the JSON
    metrics and the Prometheus text (read back by the reference's
    parser) hold the served peer's own counters."""
    served = PKGS[served_pkg].Rpc("scraped")
    scraper = PKGS[scraper_pkg].Rpc("scraper")
    try:
        served.listen("127.0.0.1:0")
        served.define("n", lambda: None)
        scraper.connect(served.debug_info()["listen"][0])
        for _ in range(3):
            scraper.sync("scraped", "n")
        js = scraper.async_("scraped", "__telemetry").result(timeout=WAIT)
        assert js["name"] == "scraped"
        text = scraper.async_("scraped", "__telemetry",
                              fmt="prometheus").result(timeout=WAIT)
        parsed = ref_tel.parse_prometheus(text)  # strict: raises on junk
        calls = 'rpc_server_calls_total{endpoint="n"}'
        assert js["metrics"][calls]["value"] == 3 == parsed[calls]
        assert js["metrics"]['rpc_server_handle_seconds{endpoint="n"}'][
            "count"] == 3
        assert parsed['rpc_server_handle_seconds_count{endpoint="n"}'] == 3
        assert parsed['rpc_peers{peer="scraped"}'] == 1
        # Every counter of the served peer's own registry is in the text.
        own = served.telemetry.snapshot()
        for sid, series in own.items():
            if series["type"] == "counter" and not sid.startswith(
                    ("rpc_bytes", "rpc_server_calls_total{endpoint=\"__")):
                assert sid in parsed, sid
    finally:
        _close(scraper, served)
