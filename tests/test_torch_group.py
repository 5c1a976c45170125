"""Port parity: the Group membership view and its tree allreduce
(moolib_tpu_torch.rpc.group), on port members and in groups that mix
port and reference members.

The port-only cases mirror tests/test_group.py: builtin and custom ops,
trees, churn cancellation, straggler partial commits, parked and expired
shares, explicit chunk sizes, the child-index merge order and duplicate
delivery. The mixed cases put port and reference members into one group
(through a port Broker and through a reference Broker) and hold every
member's result bitwise to a reference-only group's over the same
payloads: sum, product, min and max over seeded trees with a bf16 leaf
(a torch bf16 tensor on a port member, an ml_dtypes array on a reference
member), whole and chunked. Tolerance: exact (bits). Every wait has a
deadline of its own.
"""

import threading
import time
import weakref

import ml_dtypes
import numpy as np
import pytest
import torch

from moolib_tpu.rpc import Rpc as RefRpc
from moolib_tpu.rpc.broker import Broker as RefBroker
from moolib_tpu.rpc.group import Group as RefGroup
from moolib_tpu_torch.rpc import AllReduce, Group, Rpc, RpcError
from moolib_tpu_torch.rpc.broker import Broker

PKG = {"port": (Rpc, Group, Broker), "ref": (RefRpc, RefGroup, RefBroker)}


def _broker_pump(ref):
    while True:
        self = ref()
        if self is None or self._stop.is_set():
            return
        self.broker.update()
        del self
        time.sleep(0.05)


class Cluster:
    """A Broker of one package and members of either, all in-process."""

    def __init__(self, broker_pkg="port"):
        rpc_cls, _, broker_cls = PKG[broker_pkg]
        self.broker_rpc = rpc_cls("broker")
        self.broker_rpc.listen("127.0.0.1:0")
        self.addr = self.broker_rpc.debug_info()["listen"][0]
        self.broker = broker_cls(self.broker_rpc)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=_broker_pump, args=(weakref.ref(self),), daemon=True
        )
        self._thread.start()
        self.clients = []

    def spawn(self, name, group="g", pkg="port"):
        rpc_cls, group_cls, _ = PKG[pkg]
        rpc = rpc_cls(name)
        rpc.listen("127.0.0.1:0")
        rpc.connect(self.addr)
        g = group_cls(rpc, broker_name="broker", group_name=group,
                      timeout=5.0)
        self.clients.append((rpc, g))
        return rpc, g

    def wait_members(self, group, n, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            gs = [g for _, g in self.clients if g.group_name == group]
            for g in gs:
                g.update()
            if gs and all(len(g.members) == n and g.active() for g in gs) \
                    and len({g.sync_id for g in gs}) == 1:
                return
            time.sleep(0.02)
        raise TimeoutError(f"group {group} never stabilized at {n} members")

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=5)
        for rpc, g in self.clients:
            g.close()
            rpc.close()
        self.broker_rpc.close()


@pytest.fixture
def cluster():
    c = Cluster()
    yield c
    c.close()


def _spawn_n(cluster, n, prefix="peer"):
    for i in range(n):
        cluster.spawn(f"{prefix}-{i}")
    cluster.wait_members("g", n)
    return [g for _, g in cluster.clients]


def test_membership_join(cluster):
    groups = _spawn_n(cluster, 3)
    assert sorted(groups[0].members) == ["peer-0", "peer-1", "peer-2"]
    assert groups[0].rank is not None


def test_allreduce_sum_scalars(cluster):
    groups = _spawn_n(cluster, 4)
    futs = [g.all_reduce("s1", float(i + 1)) for i, g in enumerate(groups)]
    assert all(isinstance(f, AllReduce) for f in futs)
    assert [f.result(timeout=10) for f in futs] == [10.0] * 4


def test_allreduce_tensors_and_trees(cluster, rng):
    """numpy leaves and torch CPU leaves (which enter as numpy views) sum
    alike."""
    groups = _spawn_n(cluster, 5)
    datas = [{"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
             for _ in groups]
    futs = [g.all_reduce("grads", {"w": d["w"],
                                   "b": torch.from_numpy(d["b"])}
                         if i % 2 else d)
            for i, (g, d) in enumerate(zip(groups, datas))]
    expect_w = sum(d["w"] for d in datas)
    expect_b = sum(d["b"] for d in datas)
    for f in futs:
        out = f.result(timeout=10)
        np.testing.assert_allclose(out["w"], expect_w, rtol=1e-5)
        np.testing.assert_allclose(out["b"], expect_b, rtol=1e-5)


@pytest.mark.parametrize("op,expect", [("min", 1.0), ("max", 4.0),
                                       ("product", 24.0)])
def test_allreduce_builtin_ops(cluster, op, expect):
    groups = _spawn_n(cluster, 4)
    futs = [g.all_reduce("o", float(i + 1), op=op)
            for i, g in enumerate(groups)]
    for f in futs:
        assert f.result(timeout=10) == pytest.approx(expect)


def test_allreduce_custom_op_and_election_max(cluster):
    groups = _spawn_n(cluster, 3)
    futs = [g.all_reduce("cat", [g.rpc.get_name()], op=lambda a, b: a + b)
            for g in groups]
    for f in futs:
        assert sorted(f.result(timeout=10)) == ["peer-0", "peer-1", "peer-2"]
    # (model_version, name) max: the Accumulator's election.
    versions = [3, 7, 7]
    futs = [g.all_reduce("elect", (versions[i], g.rpc.get_name()),
                         op=lambda a, b: max(a, b))
            for i, g in enumerate(groups)]
    for f in futs:
        assert tuple(f.result(timeout=10)) == (7, "peer-2")


def test_membership_churn_cancels_and_recovers(cluster):
    groups = _spawn_n(cluster, 3)
    old_sync = groups[0].sync_id
    # An op in flight on one member is cancelled by the join's new epoch.
    stranded = groups[0].all_reduce("stranded", 1.0)
    cluster.spawn("peer-3")
    cluster.wait_members("g", 4)
    assert groups[0].sync_id != old_sync
    with pytest.raises(RpcError, match="membership changed"):
        stranded.result(timeout=10)
    futs = [g.all_reduce("after", 1.0) for _, g in cluster.clients]
    assert [f.result(timeout=10) for f in futs] == [4.0] * 4


def test_peer_leave_expires_and_group_heals(cluster):
    _spawn_n(cluster, 3)
    dead_rpc, dead_g = cluster.clients.pop(-1)
    dead_g.close()
    dead_rpc.close()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        for _, g in cluster.clients:
            g.update()
        if all(len(g.members) == 2 for _, g in cluster.clients):
            break
        time.sleep(0.1)
    else:
        raise AssertionError("dead peer never expired")
    futs = [g.all_reduce("heal", 2.0) for _, g in cluster.clients]
    assert [f.result(timeout=10) for f in futs] == [4.0] * 2


def test_allreduce_unsynced_raises_and_two_groups_are_independent(cluster):
    rpc = Rpc("solo")
    try:
        g = Group(rpc, group_name="nope")
        with pytest.raises(RpcError, match="not synchronized"):
            g.all_reduce("x", 1.0)
    finally:
        rpc.close()
    cluster.spawn("a0", group="ga")
    cluster.spawn("a1", group="ga")
    cluster.spawn("b0", group="gb")
    cluster.wait_members("ga", 2)
    cluster.wait_members("gb", 1)
    fa = [g.all_reduce("x", 1.0) for _, g in cluster.clients[:2]]
    fb = cluster.clients[2][1].all_reduce("x", 5.0)
    assert [f.result(timeout=10) for f in fa] == [2.0, 2.0]
    assert fb.result(timeout=10) == 5.0
    # One member: completes at once, so the same name runs again.
    gb = cluster.clients[2][1]
    assert gb.all_reduce("dup", 2.0).result(timeout=10) == 2.0


def test_allreduce_refuses_device_tensors(cluster):
    """A leaf that is not on the host is refused before anything is sent
    (no hidden device-to-host copy)."""
    (g,) = _spawn_n(cluster, 1)
    with pytest.raises(TypeError, match="stage device tensors"):
        g.all_reduce("dev", {"w": torch.empty(3, device="meta")})
    assert g.all_reduce("host", {"w": np.ones(3)}).result(timeout=10)[
        "w"].tolist() == [1.0] * 3


def test_allreduce_explicit_chunk_bytes(cluster):
    """chunk_bytes overrides the env default deterministically, and 0
    disables chunking for a payload that would otherwise chunk; both
    give the same bits."""
    groups = _spawn_n(cluster, 4)
    chunk_calls = []
    orig = Group._all_reduce_chunked

    def spy(self, name, data, leaves, op_fn, chunk_floor):
        chunk_calls.append((name, chunk_floor))
        return orig(self, name, data, leaves, op_fn, chunk_floor)

    Group._all_reduce_chunked = spy
    try:
        rng = np.random.default_rng(5)
        datas = [(rng.standard_normal(1 << 18) * 10 ** i).astype(np.float32)
                 for i in range(4)]  # 1 MB each, mixed exponents
        outs = {}
        for tag, cb in (("explicit", 1 << 17), ("mono", 0)):
            chunk_calls.clear()
            futs = [g.all_reduce(tag, d, chunk_bytes=cb)
                    for g, d in zip(groups, datas)]
            outs[tag] = [np.asarray(f.result(timeout=20)) for f in futs]
            if cb:
                assert chunk_calls and all(c[1] == cb for c in chunk_calls)
            else:
                assert not chunk_calls, "chunk_bytes=0 must disable chunking"
        for o in outs["explicit"] + outs["mono"]:
            assert o.tobytes() == outs["mono"][0].tobytes()
    finally:
        Group._all_reduce_chunked = orig


def test_allreduce_straggler_timeout_partial_commit(cluster):
    peers = [cluster.spawn(f"s{i}") for i in range(3)]
    groups = [g for _, g in peers]
    cluster.wait_members("g", 3)
    members = groups[0].members
    active = [g for g in groups if g.rpc.get_name() != members[-1]]

    def merge(a, b):
        return (a[0] + b[0], tuple(a[1]) + tuple(b[1]))

    t0 = time.monotonic()
    futs = [g.all_reduce("part", (1, (g.rpc.get_name(),)), op=merge,
                         straggler_timeout=0.4)
            for g in active]
    deadline = time.monotonic() + 10
    while not all(f.done() for f in futs):
        assert time.monotonic() < deadline
        for g in groups:
            g.update()
        time.sleep(0.02)
    assert time.monotonic() - t0 < 5.0
    results = [f.result(timeout=1) for f in futs]
    for total, names in results:
        assert total == 2 and set(names) == {g.rpc.get_name()
                                             for g in active}
    root_rpc = next(r for r, g in peers if r.get_name() == members[0])
    assert (root_rpc.telemetry.registry.value(
        "group_partial_commits_total", group="g") or 0) >= 1

    # The late member completes from the parked share, identically.
    late = next(g for g in groups if g.rpc.get_name() == members[-1])
    got = late.all_reduce("part", (1, (late.rpc.get_name(),)), op=merge,
                          straggler_timeout=0.4).result(timeout=2)
    assert got[0] == 2 and set(got[1]) == set(results[0][1])


def test_expired_key_share_not_parked_for_retry(cluster):
    rpc, g = cluster.spawn("ek0")
    cluster.spawn("ek1")
    cluster.wait_members("g", 2)
    g2 = cluster.clients[1][1]
    g.set_timeout(0.5)
    fut = g.all_reduce("stranded", np.ones(2))
    key = fut.op_key
    deadline = time.monotonic() + 10
    while not fut.done():
        assert time.monotonic() < deadline
        g.update()
        g2.update()
        time.sleep(0.02)
    assert fut.exception(timeout=1) is not None
    g._share_in(key, np.full((2,), 99.0))
    assert key not in g._parked_shares
    fut2 = g.all_reduce("stranded", np.ones(2))
    time.sleep(0.05)
    assert not fut2.done(), "retry must not complete from a stale share"


def _root_group(cluster):
    for rpc, g in cluster.clients:
        if rpc.get_name() == g.members[0]:
            return g
    raise AssertionError("no root member found")


def _order_payloads():
    """Mixed-exponent fp32 payloads: fp32 summation order changes bits."""
    rng = np.random.default_rng(3)
    return [(rng.standard_normal(256) * s).astype(np.float32)
            for s in (1e4, 3e2, 1.0)]


@pytest.mark.parametrize("case", ["child_order", "duplicate", "legacy"])
def test_allreduce_merge_order(cluster, case):
    """The reduction-order contract at the root: child partials injected
    out of order still fold as (own + child1) + child2; a duplicate from
    the same child is dropped; partials without a sender index (a peer
    from before the contract) merge on arrival."""
    _spawn_n(cluster, 3)
    g0 = _root_group(cluster)
    d0, p1, p2 = _order_payloads()
    fixed = (d0 + p1) + p2
    arrival = (d0 + p2) + p1
    assert fixed.tobytes() != arrival.tobytes()
    fut = g0.all_reduce(case, d0.copy())
    key = fut.op_key
    if case == "legacy":
        g0._reduce_in(key, p2.copy(), None)
        g0._reduce_in(key, p1.copy(), None)
        want = arrival
    else:
        g0._reduce_in(key, p2.copy(), 2)
        op = g0._active.get(key)
        assert op is not None and op.received == 0 and op.pending
        if case == "duplicate":
            g0._reduce_in(key, p2.copy(), 2)
        g0._reduce_in(key, p1.copy(), 1)
        want = fixed
    assert np.asarray(fut.result(timeout=10)).tobytes() == want.tobytes()


def test_close_unregisters_gauges_and_is_idempotent(cluster):
    rpc, g = cluster.spawn("closer")
    reg = rpc.telemetry.registry
    assert reg.value("group_members", group="g") is not None
    g.close()
    assert reg.value("group_members", group="g") is None
    g.close()


# -- groups mixing port and reference members --------------------------------


def _bits(x):
    """A result leaf's bytes (bf16 as its int16 bits, either form)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return x.tobytes()


def _tree_bits(tree):
    return {k: _bits(v) for k, v in sorted(tree.items())}


def _payload(rank, pkg):
    """Member ``rank``'s seeded tree: mixed-exponent f32, an f64 and an
    int32 leaf, and a bf16 leaf in the member's package's form."""
    rng = np.random.default_rng(100 + rank)
    bf = (rng.standard_normal(300) * 4).astype(np.float32)
    if pkg == "port":
        h = torch.from_numpy(bf).to(torch.bfloat16)
    else:
        h = bf.astype(ml_dtypes.bfloat16)
    return {"w": (rng.standard_normal((80, 66)) * 10.0 ** (rank % 3))
            .astype(np.float32),
            "b": rng.standard_normal(7),
            "i": rng.integers(-3, 4, 50).astype(np.int32),
            "h": h}


@pytest.mark.parametrize("broker_pkg", ["port", "ref"])
def test_mixed_group_matches_a_reference_only_group(broker_pkg):
    """Four members alternating port and reference, and four reference
    members in a second group on the same broker; payload i goes to the
    member at tree index i in both. Every member of both groups holds the
    same bits, for each op, whole and chunked."""
    cluster = Cluster(broker_pkg)
    try:
        for i in range(4):
            cluster.spawn(f"m{i}", group="mixed",
                          pkg="port" if i % 2 == 0 else "ref")
            cluster.spawn(f"r{i}", group="ref", pkg="ref")
        cluster.wait_members("mixed", 4)
        cluster.wait_members("ref", 4)
        members = {gn: [(rpc, g) for rpc, g in cluster.clients
                        if g.group_name == gn] for gn in ("mixed", "ref")}
        for op in ("sum", "product", "min", "max"):
            got = []
            for gn, pairs in members.items():
                for chunk in (0, 4096):  # whole; chunked (a ~22 KB payload)
                    futs = []
                    for rpc, g in pairs:
                        pkg = "port" if isinstance(rpc, Rpc) else "ref"
                        rank = g.members.index(rpc.get_name())
                        futs.append(g.all_reduce(
                            f"{op}.{chunk}", _payload(rank, pkg), op=op,
                            chunk_bytes=chunk))
                    for (rpc, _), f in zip(pairs, futs):
                        out = f.result(timeout=20)
                        if isinstance(rpc, Rpc):
                            assert isinstance(out["h"], torch.Tensor)
                            assert out["h"].dtype == torch.bfloat16
                        got.append(_tree_bits(out))
            assert all(t == got[0] for t in got), op
        # The chunked rounds really went chunked on every member.
        for rpc, g in members["mixed"]:
            assert (rpc.telemetry.registry.value(
                "group_rounds_total", group="mixed") or 0) > 8
    finally:
        cluster.close()


def test_bf16_sum_matches_ml_dtypes_numpy():
    """The host reduce of a bf16 leaf: torch's CPU add rounds each
    partial once, as np.add on ml_dtypes' bf16 does, so the fold over a
    port tree is the numpy fold bit for bit."""
    from moolib_tpu_torch.rpc.group import REDUCE_OPS

    rng = np.random.default_rng(7)
    xs = [(rng.standard_normal(1000) * 10.0 ** (i - 2)).astype(np.float32)
          for i in range(5)]
    for name in ("sum", "product", "min", "max"):
        fn = REDUCE_OPS[name]
        ref = xs[0].astype(ml_dtypes.bfloat16)
        port = torch.from_numpy(xs[0]).to(torch.bfloat16)
        for x in xs[1:]:
            ref = {"sum": np.add, "product": np.multiply,
                   "min": np.minimum, "max": np.maximum}[name](
                ref, x.astype(ml_dtypes.bfloat16))
            port = fn(port, torch.from_numpy(x).to(torch.bfloat16))
        assert _bits(port) == _bits(ref), name
