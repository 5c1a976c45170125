"""Port parity: the elastic Accumulator (moolib_tpu_torch.parallel).

The port-only cases mirror tests/test_accumulator.py on port peers (port
Rpc, Group and Broker): election, the virtual batch, skips, state sync to
a joiner, peer death, parallel_gradients, drift healing, chunk-geometry
negotiation and quorum rounds; and that reduce_gradients never converts
a staged leaf on the training thread. A mixed group of port and
reference peers gives every member the same bits. The slice as a whole:
two port peers and two reference peers train a small TransformerNet
(d_model 32, 1 layer, 2 heads) two elastic updates each from the same
converted parameters on the same seeded per-peer batches; the port's
parameters afterwards are held to the reference's at 1e-6 absolute (the
train-step tolerance of tests/test_torch_learner.py) and its two peers
to each other bitwise. Every wait has a deadline of its own.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moolib_tpu import learner as jlearner
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.parallel import Accumulator as RefAccumulator
from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.models import TransformerNet, transformer_params_from_flax
from moolib_tpu_torch.optim import ClippedRMSprop
from moolib_tpu_torch.parallel import Accumulator
from moolib_tpu_torch.rpc import Rpc
from test_torch_group import Cluster


@pytest.fixture
def cluster():
    c = Cluster()
    yield c
    c.close()


def _spawn_acc(cluster, name, vbs, pkg="port", group="g", **kw):
    rpc, g = cluster.spawn(name, group=group, pkg=pkg)
    cls = Accumulator if pkg == "port" else RefAccumulator
    return cls(rpc, group=g, virtual_batch_size=vbs, **kw)


def _pump(accs, until, timeout=20.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for a in accs:
            a.update()
        if until():
            return
        time.sleep(interval)
    raise TimeoutError("condition never reached; stats: "
                       + str([a.get_gradient_stats() for a in accs]))


def _ready(accs):
    _pump(accs, lambda: all(a.connected() and a.wants_gradients()
                            for a in accs))


def test_leader_election_and_connect(cluster):
    accs = [_spawn_acc(cluster, f"p{i}", vbs=4) for i in range(3)]
    accs[1].set_model_version(10)  # p1 must win the election
    _pump(accs, lambda: all(a.connected() for a in accs))
    assert {a.get_leader() for a in accs} == {"p1"}
    assert accs[1].is_leader() and not accs[0].is_leader()


def test_gradient_reduction_virtual_batch(cluster):
    n, vbs = 3, 6
    accs = [_spawn_acc(cluster, f"p{i}", vbs=vbs) for i in range(n)]
    _ready(accs)
    # Batch-sum gradients for batch size 2 each; torch CPU leaves too.
    grads = [{"w": torch.full((3,), float(i + 1)) * 2, "b": np.float64(i) * 2}
             for i in range(n)]
    for a, g in zip(accs, grads):
        a.reduce_gradients(g, batch_size=2)
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    for a in accs:
        mean, count = a.result_gradients()
        assert count == vbs
        np.testing.assert_allclose(mean["w"], np.full((3,), 2.0))
        np.testing.assert_allclose(mean["b"], (0 + 1 + 2) * 2 / 6)
        assert a.model_version == accs[0].model_version
    for a in accs:
        a.zero_gradients()
        assert not a.has_gradients() and a.wants_gradients()
    assert accs[0].model_version >= 1


class _FakeStaged:
    """A staged device copy's stand-in (the HostStaged protocol): records
    when, and on which thread, its host value is taken."""

    def __init__(self, arr):
        self._arr = np.asarray(arr)
        self.taken_on = []

    @property
    def shape(self):
        return self._arr.shape

    @property
    def dtype(self):
        return self._arr.dtype

    def is_ready(self):
        return True

    def result(self):
        self.taken_on.append(threading.current_thread().name)
        return self._arr


def test_reduce_gradients_never_blocks_on_device_transfer(cluster):
    """reduce_gradients returns without taking a staged leaf's host value;
    the conversion happens later, off the calling thread, once the count
    round resolves."""
    accs = [_spawn_acc(cluster, f"p{i}", vbs=4) for i in range(2)]
    _ready(accs)
    leaves = [_FakeStaged(np.full((3,), float(i + 1) * 2)) for i in range(2)]
    for a, leaf in zip(accs, leaves):
        a.reduce_gradients({"w": leaf}, batch_size=2)
        assert leaf.taken_on == [], "reduce_gradients waited for a copy"
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    main = threading.current_thread().name
    for a, leaf in zip(accs, leaves):
        mean, count = a.result_gradients()
        assert count == 4
        np.testing.assert_allclose(mean["w"], np.full((3,), (2 + 4) / 4))
        assert leaf.taken_on and all(t != main for t in leaf.taken_on)


def test_reduce_gradients_refuses_unstaged_device_leaves(cluster):
    """A device tensor that is not on a CUDA card (so cannot be staged)
    never reaches a blocking copy: the round's readback refuses it and
    the contribution is dropped, as for a failed readback."""
    from moolib_tpu_torch.parallel.accumulator import _to_numpy_tree

    with pytest.raises(TypeError, match="stage device tensors"):
        _to_numpy_tree({"w": torch.empty(2, device="meta")})


def test_accumulation_across_rounds(cluster):
    accs = [_spawn_acc(cluster, f"p{i}", vbs=8) for i in range(2)]
    _ready(accs)
    for step in range(2):
        for i, a in enumerate(accs):
            a.reduce_gradients({"g": np.ones(2) * (i + 1)}, batch_size=2)
        if step == 0:
            time.sleep(0.2)
            for a in accs:
                a.update()
            assert not any(a.has_gradients() for a in accs)
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    mean, count = accs[0].result_gradients()
    assert count == 8
    np.testing.assert_allclose(mean["g"], np.full(2, 6 / 8))


def test_skip_gradients_keeps_cluster_moving(cluster):
    accs = [_spawn_acc(cluster, f"p{i}", vbs=4) for i in range(3)]
    _ready(accs)
    accs[0].reduce_gradients({"g": np.ones(3) * 4}, batch_size=4)
    accs[1].skip_gradients()
    accs[2].skip_gradients()
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    mean, count = accs[1].result_gradients()
    assert count == 4
    np.testing.assert_allclose(mean["g"], np.ones(3))


def test_state_sync_to_joiner(cluster):
    state = {"params": np.arange(4.0), "bf": torch.arange(3.0).bfloat16(),
             "step": 7}
    leader = _spawn_acc(cluster, "veteran", vbs=2, get_state=lambda: state)
    leader.set_model_version(5)
    _pump([leader], lambda: leader.connected())
    received = {}
    joiner = _spawn_acc(cluster, "rookie", vbs=2,
                        set_state=lambda s: received.update(s))
    accs = [leader, joiner]
    _pump(accs, lambda: joiner.connected()
          and joiner.get_gradient_stats()["synced"])
    np.testing.assert_array_equal(received["params"], state["params"])
    assert torch.equal(received["bf"], state["bf"])
    assert received["step"] == 7
    assert joiner.model_version == 5
    assert leader.is_leader() and not joiner.is_leader()


def test_get_state_must_return_host_leaves(cluster):
    """get_state copies its state to the host itself (under the lock that
    orders it against the apply step); a device leaf is refused."""
    acc = _spawn_acc(cluster, "lone", vbs=2,
                     get_state=lambda: {"w": torch.empty(2, device="meta")})
    with pytest.raises(TypeError, match="stage device tensors"):
        acc._serve_state()


def test_elastic_join_midstream_and_peer_death(cluster):
    accs = [_spawn_acc(cluster, f"p{i}", vbs=2) for i in range(2)]
    _ready(accs)
    for a in accs:
        a.reduce_gradients({"g": np.ones(1)}, batch_size=1)
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    for a in accs:
        a.zero_gradients()
    # A new peer joins: new epoch, re-election, the cluster keeps going.
    accs.append(_spawn_acc(cluster, "late", vbs=2))
    _ready(accs)
    for a in accs:
        a.reduce_gradients({"g": np.ones(1)}, batch_size=1)
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    assert accs[-1].result_gradients()[1] >= 2
    for a in accs:
        a.zero_gradients()
    # One peer dies: the broker expires it and the survivors go on.
    accs.pop()
    dead_rpc, dead_g = cluster.clients.pop()
    dead_g.close()
    dead_rpc.close()
    _pump(accs, lambda: all(a.connected() and len(a.group.members) == 2
                            for a in accs), timeout=30)
    _pump(accs, lambda: all(a.wants_gradients() for a in accs), timeout=30)
    for a in accs:
        a.reduce_gradients({"g": np.ones(1)}, batch_size=1)
    _pump(accs, lambda: all(a.has_gradients() for a in accs), timeout=30)
    assert accs[0].result_gradients()[1] == 2


def test_parallel_gradients_pipelining(cluster):
    accs = [_spawn_acc(cluster, f"p{i}", vbs=2, parallel_gradients=2)
            for i in range(2)]
    _ready(accs)
    for a in accs:
        a.reduce_gradients({"g": np.ones(2)}, batch_size=1)
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    _pump(accs, lambda: all(a.wants_gradients() for a in accs))
    for a in accs:
        a.reduce_gradients({"g": np.full(2, 3.0)}, batch_size=1)
    _pump(accs, lambda: all(len(a._results) == 2 for a in accs), timeout=30)
    for a in accs:
        mean0, count0 = a.result_gradients()
        np.testing.assert_allclose(mean0["g"], np.ones(2))
        assert count0 == 2
        a.zero_gradients()
        mean1, count1 = a.result_gradients()
        np.testing.assert_allclose(mean1["g"], np.full(2, 3.0))
        a.zero_gradients()
    assert accs[0].model_version == accs[1].model_version >= 2


def test_leader_broadcast_heals_drift(cluster):
    leader_state = {"w": np.arange(4.0)}
    leader = _spawn_acc(cluster, "leader", vbs=2,
                        get_state=lambda: leader_state,
                        state_broadcast_interval=0.3)
    leader.set_model_version(3)
    member_state = {}
    member = _spawn_acc(cluster, "member", vbs=2,
                        set_state=lambda s: member_state.update(s),
                        state_broadcast_interval=0.3)
    accs = [leader, member]
    _pump(accs, lambda: all(a.connected() for a in accs)
          and member.get_gradient_stats()["synced"])
    np.testing.assert_array_equal(member_state["w"], leader_state["w"])
    member_state["w"] = np.full(4, -99.0)
    _pump(accs, lambda: np.array_equal(member_state["w"], leader_state["w"]),
          timeout=15)
    assert member.model_version == 3


def test_chunked_wire_format_and_negotiated_geometry(cluster):
    """Round A: a template-less peer flips the round to the custom merge.
    Round B: every peer has a template, the peers' chunk sizes differ, the
    count round negotiates the smaller one, and the bundle goes chunked
    (a bf16 torch leaf included). Both formats give the same means."""
    accs = [_spawn_acc(cluster, "p0", vbs=6, chunk_bytes=1 << 12),
            _spawn_acc(cluster, "p1", vbs=6, chunk_bytes=1 << 14),
            _spawn_acc(cluster, "p2", vbs=6, chunk_bytes=1 << 14)]
    _ready(accs)
    big = np.ones(20_000, dtype=np.float32)  # 80 KB > 2 * 4 KB
    half = torch.ones(1000, dtype=torch.bfloat16)

    def bundle(scale):
        return {"w": big * scale, "b": np.float64(scale), "h": half * scale}

    for i in (0, 1):
        accs[i].reduce_gradients(bundle(2 * (i + 1)), batch_size=3)
    accs[2].skip_gradients()
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    for a in accs:
        res, count = a.result_gradients()
        assert count == 6
        np.testing.assert_allclose(res["w"], big * 6 / 6)
        assert res["h"].dtype == torch.bfloat16
        a.zero_gradients()
    assert all(a.get_gradient_stats()["chunked_gradient_rounds"] == 0
               for a in accs)

    _pump(accs, lambda: all(a.wants_gradients() for a in accs))
    accs[0].reduce_gradients(bundle(1.0), batch_size=2)
    accs[0].reduce_gradients(bundle(1.0), batch_size=1)
    accs[1].reduce_gradients(bundle(1.0), batch_size=3)
    accs[2].skip_gradients()
    _pump(accs, lambda: all(a.has_gradients() for a in accs), timeout=30)
    for a in accs:
        res, count = a.result_gradients()
        assert count == 6
        np.testing.assert_allclose(res["w"], big * 3 / 6)
        np.testing.assert_allclose(res["b"], 3.0 / 6)
        assert torch.equal(res["h"], half * 3 / 6)
        a.zero_gradients()
        stats = a.get_gradient_stats()
        assert stats["chunked_gradient_rounds"] == 1, stats
        assert stats["negotiated_chunk_bytes"] == 1 << 12, stats


def test_get_leader_set_virtual_batch_size_and_validation(cluster):
    accs = [_spawn_acc(cluster, f"p{i}", vbs=4) for i in range(2)]
    _ready(accs)
    leaders = {a.get_leader() for a in accs}
    assert len(leaders) == 1 and leaders != {None}
    accs[0].set_virtual_batch_size(2)
    accs[0].reduce_gradients({"w": np.ones(4)}, batch_size=2)
    accs[1].skip_gradients()
    time.sleep(0.5)
    for a in accs:
        a.update()
    assert not any(a.has_gradients() for a in accs)
    accs[1].set_virtual_batch_size(2)
    _pump(accs, lambda: all(a.has_gradients() for a in accs))
    for a in accs:
        res, count = a.result_gradients()
        assert count == 2
        np.testing.assert_allclose(res["w"], np.ones(4) / 2)
        a.zero_gradients()
    with pytest.raises(ValueError):
        accs[0].set_virtual_batch_size(0)
    with pytest.raises(ValueError):
        Accumulator(cluster.clients[0][0], virtual_batch_size=0)
    with pytest.raises(RuntimeError, match="already registered"):
        Accumulator(cluster.clients[0][0])
    rpc = Rpc("qv")
    try:
        with pytest.raises(ValueError):
            Accumulator(rpc, min_quorum=0)
        with pytest.raises(ValueError):
            Accumulator(rpc, straggler_timeout=0.0)
    finally:
        rpc.close()


def test_quorum_round_commits_without_stalled_member(cluster):
    accs = [_spawn_acc(cluster, f"q{i}", vbs=2, min_quorum=2,
                       straggler_timeout=0.5) for i in range(3)]
    _pump(accs, lambda: all(
        a.connected() and a.wants_gradients()
        and a.get_gradient_stats()["negotiated_quorum"] == 2 for a in accs))
    members = accs[0].group.members
    stalled = next(a for a in accs if a.rpc.get_name() == members[-1])
    fast = [a for a in accs if a is not stalled]
    for a in fast:
        a.reduce_gradients({"w": np.full((3,), 4.0)}, batch_size=2)
    t0 = time.monotonic()
    _pump(fast, lambda: all(a.has_gradients() for a in fast), timeout=10)
    assert time.monotonic() - t0 < 5.0
    for a in fast:
        mean, count = a.result_gradients()
        assert count == 4
        np.testing.assert_allclose(np.asarray(mean["w"]), 2.0)
        stats = a.get_gradient_stats()
        assert stats["last_participation"] == (2, 3), stats
        assert stats["straggler_writeoffs"] >= 1, stats
        assert a.rpc.telemetry.registry.value(
            "acc_partial_gradient_rounds_total") >= 1


def test_close_releases_registrations_and_is_idempotent(cluster):
    rpc, g = cluster.spawn("closer")
    acc = Accumulator(rpc, group=g, virtual_batch_size=8)
    reg = rpc.telemetry.registry
    assert reg.value("acc_model_version") is not None
    assert rpc.defined("AccumulatorService::requestState")
    acc.close()
    assert reg.value("acc_model_version") is None
    assert not rpc.defined("AccumulatorService::requestState")
    assert not rpc.defined("AccumulatorService::pushState")
    acc.close()
    acc2 = Accumulator(rpc, group=g, virtual_batch_size=8)
    assert rpc.defined("AccumulatorService::requestState")
    acc2.close()


# -- port and reference peers -------------------------------------------------


def _bits(tree):
    return {k: np.asarray(v).tobytes() for k, v in sorted(tree.items())}


@pytest.mark.parametrize("broker_pkg", ["port", "ref"])
def test_mixed_accumulator_group_is_bitwise_equal(broker_pkg):
    """Two port and two reference peers in one group, three of them
    contributing a seeded dict-of-numpy bundle of one structure, the last
    (a reference peer) skipping: the first round goes through the custom
    merge (the skipper has no template yet), the second chunked (the
    skipper ships zeros); every member's result_gradients holds the same
    bits."""
    cluster = Cluster(broker_pkg)
    try:
        accs = [_spawn_acc(cluster, f"x{i}", vbs=6,
                           pkg="port" if i % 2 == 0 else "ref",
                           chunk_bytes=1 << 12)
                for i in range(4)]
        _ready(accs)
        for rnd in range(2):
            for i, a in enumerate(accs[:3]):
                rng = np.random.default_rng(10 * rnd + i)
                a.reduce_gradients(
                    {"w": (rng.standard_normal((50, 40)) * 10.0 ** i)
                     .astype(np.float32),
                     "b": rng.standard_normal(9)}, batch_size=2)
            accs[3].skip_gradients()
            _pump(accs, lambda: all(a.has_gradients() for a in accs))
            got = [_bits(a.result_gradients()[0]) for a in accs]
            assert all(g == got[0] for g in got), rnd
            assert {a.result_gradients()[1] for a in accs} == {6}
            for a in accs:
                a.zero_gradients()
            _pump(accs, lambda: all(a.wants_gradients() for a in accs))
        assert [a.get_gradient_stats()["chunked_gradient_rounds"]
                for a in accs] == [1] * 4
    finally:
        cluster.close()


SLICE = dict(d_model=32, num_layers=1, num_heads=2)
A, T, B = 6, 4, 2


def _slice_batch(peer, update):
    rng = np.random.default_rng(1000 + 10 * peer + update)
    return {
        "obs": rng.standard_normal((T + 1, B, 5)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.25,
        "rewards": (2.0 * rng.standard_normal((T + 1, B))).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }


class _RefPeer:
    def __init__(self, jnet, params):
        tx = optax.chain(optax.clip_by_global_norm(40.0),
                         optax.rmsprop(6e-4, decay=0.99, eps=0.01))
        self.grad = jlearner.make_grad_step(jnet.apply, grad_scale=float(B))
        self.apply = jlearner.make_apply_step(tx, donate=False)
        self.state = jlearner.make_train_state(params, tx)

    def grads(self, batch):
        g, _ = self.grad(self.state.params, {
            **{k: jnp.asarray(v) for k, v in batch.items()},
            "core_state": ()})
        return g

    def step(self, mean):
        self.state = self.apply(self.state,
                                jax.tree_util.tree_map(jnp.asarray, mean))


class _PortPeer:
    def __init__(self, state_dict):
        net = TransformerNet(A, (5,), attention_backend="flash",
                             device="cpu", **SLICE)
        net.load_state_dict(state_dict)
        opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                             max_norm=40.0)
        self.grad = tlearner.make_grad_step(grad_scale=float(B))
        self.apply = tlearner.make_apply_step()
        self.state = tlearner.make_train_state(net, opt)

    def grads(self, batch):
        g, _ = self.grad(self.state.model, {
            **{k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
            "core_state": ()})
        return g

    def step(self, mean):
        self.state = self.apply(self.state, {
            k: torch.from_numpy(np.array(v)) for k, v in mean.items()})


def test_two_elastic_updates_match_the_reference(cluster):
    """The slice as a whole: grad step x B, the Accumulator's mean over two
    peers (virtual batch 2B), the apply step; twice, in each package."""
    jnet = JaxTransformerNet(num_actions=A, attention_backend="flash",
                             compute_dtype=jnp.float32, **SLICE)
    b0 = _slice_batch(0, 0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(b0["obs"]),
                       jnp.asarray(b0["done"]), ())
    converted = transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))
    peers = []
    for pkg in ("port", "ref"):
        for i in range(2):
            acc = _spawn_acc(cluster, f"{pkg}{i}", vbs=2 * B, pkg=pkg,
                             group=pkg)
            peer = _PortPeer(converted) if pkg == "port" \
                else _RefPeer(jnet, params)
            peers.append((pkg, i, acc, peer))
    accs = [p[2] for p in peers]
    _ready(accs)
    # Each peer contributes once an update and skips the count rounds
    # that poll it again before its group's virtual batch fills, so an
    # update is exactly both peers' batches.
    done = {id(a): 0 for a in accs}
    sent = {id(a): False for a in accs}
    deadline = time.monotonic() + 120
    while min(done.values()) < 2:
        assert time.monotonic() < deadline, [a.get_gradient_stats()
                                             for a in accs]
        for pkg, i, acc, peer in peers:
            acc.update()
            if done[id(acc)] >= 2:
                continue
            if acc.wants_gradients():
                if sent[id(acc)]:
                    acc.skip_gradients()
                else:
                    acc.reduce_gradients(
                        peer.grads(_slice_batch(i, done[id(acc)])),
                        batch_size=B)
                    sent[id(acc)] = True
            if acc.has_gradients():
                mean, count = acc.result_gradients()
                assert count == 2 * B
                peer.step(mean)
                acc.zero_gradients()
                done[id(acc)] += 1
                sent[id(acc)] = False
        time.sleep(0.002)
    port = [p[3] for p in peers if p[0] == "port"]
    ref = [p[3] for p in peers if p[0] == "ref"]
    assert port[0].state.step == 2
    for a, b in zip(port[0].state.model.state_dict().items(),
                    port[1].state.model.state_dict().values()):
        assert torch.equal(a[1], b), a[0]
    want = transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, ref[0].state.params))
    moved = 0.0
    for name, p in port[0].state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        moved = max(moved, float((want[name] - converted[name]).abs().max()))
    assert moved > 1e-4  # the two updates really moved the parameters


def test_train_state_hand_off_to_a_joiner_is_bitwise(cluster):
    """A leader's TrainState (parameters and ClippedRMSprop's nu after a
    step) reaches a joiner through get_state/set_state and the wire, and
    loads there bit for bit (train_state_to_host / load_train_state,
    under a state lock each)."""
    def train_state(seed):
        net = TransformerNet(A, (5,), attention_backend="flash",
                             device="cpu",
                             generator=torch.Generator().manual_seed(seed),
                             **SLICE)
        opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                             max_norm=40.0)
        return tlearner.make_train_state(net, opt)

    lead = train_state(0)
    batch = {**{k: torch.from_numpy(np.array(v))
                for k, v in _slice_batch(0, 0).items()}, "core_state": ()}
    lead, _ = tlearner.make_impala_train_step()(lead, batch)
    held = {"joiner": train_state(1)}
    lock = threading.Lock()

    def get_state():
        with lock:
            return tlearner.train_state_to_host(lead)

    def set_state(payload):
        with lock:
            held["joiner"] = tlearner.load_train_state(held["joiner"],
                                                       payload)

    leader = _spawn_acc(cluster, "lead", vbs=2, get_state=get_state)
    leader.set_model_version(1)
    joiner = _spawn_acc(cluster, "join", vbs=2, set_state=set_state)
    _pump([leader, joiner], lambda: joiner.connected()
          and joiner.get_gradient_stats()["synced"])
    got = held["joiner"]
    assert got.step == lead.step == 1
    for (n, a), b in zip(lead.model.named_parameters(),
                         got.model.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(lead.optimizer.state[a]["nu"],
                           got.optimizer.state[b]["nu"]), n
    assert got.optimizer.param_groups[0]["lr"] == 6e-4


def test_a_leader_serves_no_state_between_an_apply_and_its_zero(cluster):
    """The user applies a result, then zero_gradients() pops it. A state
    request served in between would hand out the applied params under the
    version before them (the reference serves that torn pair, and the
    joiner stays one update ahead of its version for good). The leader
    refuses while a result is queued; the joiner syncs once it is
    zeroed, at the leader's version, on the applied params."""
    w = {"lead": np.zeros(3)}
    lead = _spawn_acc(cluster, "tornlead", vbs=1,
                      get_state=lambda: {"w": w["lead"].copy()})
    lead.set_model_version(5)
    _pump([lead], lambda: lead.connected() and lead.wants_gradients())
    lead.reduce_gradients({"w": np.ones(3)}, batch_size=1)
    _pump([lead], lead.has_gradients)
    mean, _ = lead.result_gradients()
    w["lead"] = w["lead"] - np.asarray(mean["w"])  # applied, not zeroed
    got = []
    joiner = _spawn_acc(cluster, "tornjoin", vbs=1,
                        set_state=lambda s: got.append(np.array(s["w"])))
    _pump([lead, joiner], lambda: joiner.connected()
          and joiner.get_leader() == "tornlead")
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline:
        for a in (lead, joiner):
            a.update()
        time.sleep(0.005)
    assert got == [] and not joiner.get_gradient_stats()["synced"]
    lead.zero_gradients()
    _pump([lead, joiner], lambda: joiner.get_gradient_stats()["synced"])
    np.testing.assert_array_equal(got[-1], w["lead"])
    assert joiner.model_version == lead.model_version == 6


def test_a_joiner_polled_faster_than_its_set_state_syncs_once(cluster):
    """The state-request gate stays closed until set_state has finished:
    a joiner whose update() runs every 2 ms and whose set_state takes
    0.2 s is synced by its first transfer (a gate reopened before the
    apply lets each poll send a request that supersedes the one being
    applied, and the joiner never syncs)."""
    leader = _spawn_acc(cluster, "slowlead", vbs=2,
                        get_state=lambda: {"w": np.arange(4.0)})
    leader.set_model_version(3)
    _pump([leader], leader.connected)
    applied = []

    def slow_set_state(state):
        applied.append(np.array(state["w"]))
        time.sleep(0.2)

    joiner = _spawn_acc(cluster, "slowjoin", vbs=2,
                        set_state=slow_set_state)
    _pump([leader, joiner], lambda: joiner.connected()
          and joiner.get_gradient_stats()["synced"], interval=0.002)
    assert len(applied) == 1
    np.testing.assert_array_equal(applied[0], np.arange(4.0))
    assert joiner.model_version == 3
