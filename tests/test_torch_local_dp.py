"""The experiment's data-parallel learner over the local devices
(moolib_tpu_torch.parallel.local_dp and train(devices=...)) against the
reference's dp mesh, on the CPU: worlds of two gloo ranks, the second a
spawned follower (tests/torch_local_dp_cases.py builds its learner).

Tolerances, f32: the dp=2 grad step and the RMSprop apply against the
reference's make_grad_step(mesh=make_mesh(dp=2)) and its optax apply on
the conftest's virtual devices at 1e-5 of each leaf's largest entry
(gradients, parameters after each apply) and 1e-5 relative (metrics);
the ranks' parameters after every apply: the same bits.
"""

import multiprocessing as mp
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_local_dp_cases as cases
from moolib_tpu import learner as jlearner
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.parallel import mesh as jmesh
from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.examples.vtrace import experiment as port_exp
from moolib_tpu_torch.models import transformer_params_from_flax
from moolib_tpu_torch.parallel import local_dp
from moolib_tpu_torch.parallel.local_dp import (
    LocalDP,
    choose_backend,
    dp_size,
    fold_digest,
    param_checksums,
    split_batch,
)

VtraceConfig = port_exp.VtraceConfig
T, B, A, F = 3, 4, 6, 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (the followers take one each too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_children():
    deadline = time.monotonic() + 10.0
    while mp.active_children() and time.monotonic() < deadline:
        time.sleep(0.1)
    return mp.active_children() == []


def _digest(sums):
    """The follower's running digest over the checksums after each apply."""
    digest = torch.zeros(2, dtype=torch.int64)
    for row in sums:
        digest = fold_digest(digest, row)
    return digest


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale, err_msg=err_msg)


# -- the rules --------------------------------------------------------------------


@pytest.mark.parametrize("n, batch", [
    (1, 32), (2, 32), (8, 32), (3, 32), (6, 32), (8, 4), (8, 12), (4, 6),
    (5, 5), (7, 1),
])
def test_dp_is_the_references_gcd_of_devices_and_learn_batch(n, batch):
    # The reference's rule (experiment.py:214): over its jax.devices().
    import math

    assert dp_size(["cpu"] * n, batch) == math.gcd(n, batch)
    assert dp_size(jax.devices()[:n], batch) == math.gcd(
        len(jax.devices()[:n]), batch)


@pytest.mark.parametrize("devices, want", [
    (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo"),
    (["cuda", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1", "cuda:1"], "gloo"),
    (["cpu", "cpu"], "gloo"),
])
def test_backend_nccl_for_distinct_cards_gloo_for_shared_or_cpu(devices,
                                                                want):
    assert choose_backend(devices) == want


def test_backend_refuses_cards_mixed_with_the_cpu():
    with pytest.raises(ValueError, match="all cards or all CPU"):
        choose_backend(["cuda:0", "cpu"])


def _learn_batch(seed, core=False):
    rng = np.random.default_rng(seed)
    batch = {
        "obs": rng.standard_normal((T + 1, B, F)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.25,
        "rewards": (2.0 * rng.standard_normal((T + 1, B))).astype(
            np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }
    if core:
        batch["core_state"] = (rng.standard_normal((B, 7)).astype(np.float32),
                               rng.standard_normal((B, 7)).astype(np.float32))
    return batch


def test_split_batch_gives_each_rank_the_references_shard():
    batch = _learn_batch(0, core=True)
    mesh = jmesh.make_mesh(dp=2, devices=jax.devices()[:2])
    ref = jmesh.shard_batch(mesh, {k: jnp.asarray(v) if k != "core_state"
                                   else tuple(map(jnp.asarray, v))
                                   for k, v in batch.items()})
    for rank, part in enumerate(split_batch(batch, 2)):
        dev = jax.devices()[rank]

        def shard(arr):
            return next(np.asarray(s.data) for s in arr.addressable_shards
                        if s.device == dev)

        for k in ("obs", "done", "rewards", "actions", "behavior_logits"):
            np.testing.assert_array_equal(part[k].numpy(), shard(ref[k]),
                                          err_msg=k)
        for got, want in zip(part["core_state"], ref["core_state"]):
            np.testing.assert_array_equal(got.numpy(), shard(want))


def test_pack_round_trips_every_dtype_and_the_structure():
    tree = {"a": torch.arange(5, dtype=torch.int64),
            "b": (torch.ones(3, 2, dtype=torch.bfloat16),
                  torch.tensor([True, False, True])),
            "c": (), "d": torch.zeros(0, 4), "e": torch.tensor(2.5)}
    spec, buf = local_dp._pack(tree)
    assert buf.dtype == torch.uint8
    out = local_dp._unpack(spec, buf.clone())
    assert out["c"] == ()
    for got, want in zip(local_dp.nest.flatten(out),
                         local_dp.nest.flatten(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)


# -- the world against the reference's dp=2 mesh ------------------------------------


def _jax_transformer(batch):
    jnet = JaxTransformerNet(num_actions=A, attention_backend="dense",
                             d_model=32, num_layers=2, num_heads=2)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(batch["obs"]),
                       jnp.asarray(batch["done"]), ())
    return jnet, params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checksums_see_one_changed_bit_and_a_swap_and_the_digest_its_order(
        dtype):
    model = cases.transformer("cpu", (F,), seed=0).model.to(dtype)
    base = param_checksums(model)
    assert base.shape == (2,) and base.dtype == torch.int64
    assert torch.equal(param_checksums(model), base)
    p = next(model.parameters())
    with torch.no_grad():
        bits = p.view(-1).view({4: torch.int32, 2: torch.int16}[
            p.element_size()])
        bits[0] ^= 1  # the lowest bit of the first element
        flipped = param_checksums(model)
        bits[0] ^= 1
        first, second = p.view(-1)[0].clone(), p.view(-1)[1].clone()
        assert not torch.equal(first, second)
        p.view(-1)[0], p.view(-1)[1] = second, first  # the same bytes, moved
        swapped = param_checksums(model)
    assert not torch.equal(flipped, base)
    assert swapped[0] == base[0] and swapped[1] != base[1]
    assert not torch.equal(_digest([base, swapped]), _digest([swapped, base]))


def test_dp2_grad_and_apply_match_the_reference_mesh_and_ranks_stay_bitwise():
    batches = [_learn_batch(10 + k) for k in range(3)]
    jnet, params = _jax_transformer(batches[0])
    mesh = jmesh.make_mesh(dp=2, devices=jax.devices()[:2])
    opt = optax.chain(optax.clip_by_global_norm(40.0),
                      optax.rmsprop(6e-4, decay=0.99, eps=0.01))
    jgrad = jlearner.make_grad_step(jnet.apply, mesh=mesh)
    japply = jlearner.make_apply_step(opt, donate=False)
    jstate = jlearner.make_train_state(params, opt)

    state = cases.transformer("cpu", (F,), seed=0)
    sd = transformer_params_from_flax(_np(params))
    state.model.load_state_dict(sd)
    world = LocalDP(["cpu", "cpu"], cases.build_transformer,
                    args=((F,), 1))
    try:
        assert world.backend == "gloo" and world.dp == 2
        grad_step = tlearner.make_grad_step(mesh=world.mesh)
        apply_step = tlearner.make_apply_step()
        state = world.replicate(state)
        mine = []
        for batch in batches:
            jg, jm = jgrad(jstate.params, jmesh.shard_batch(
                mesh, {**{k: jnp.asarray(v) for k, v in batch.items()},
                       "core_state": ()}))
            jstate = japply(jstate, jg)
            grads, metrics = world.grad(grad_step, state.model,
                                        {**batch, "core_state": ()})
            state = world.apply(apply_step, state, grads)
            mine.append(param_checksums(state.model))
            want_g = transformer_params_from_flax(_np(jg))
            for k, g in grads.items():
                _close_rel(g.numpy(), want_g[k].numpy(), 1e-5, k)
            for k in ("total_loss", "pg_loss", "baseline_loss", "entropy",
                      "grad_norm"):
                _close_rel(float(metrics[k]), float(jm[k]), 1e-5, k)  # hotlint: sync -- the test compares each step's metrics
            want_p = transformer_params_from_flax(_np(jstate.params))
            for k, p in state.model.named_parameters():
                _close_rel(p.detach().numpy(), want_p[k].numpy(), 1e-5, k)
        (report,) = world.close(state.model)
    finally:
        world.close()
    assert world.checksum_diff == 0
    assert report["updates"] == len(batches)
    # After every APPLY the follower's parameters were rank 0's bits.
    assert torch.equal(report["digest"], _digest(mine))
    assert set(world.send_ms) == {"GRAD", "STEP", "APPLY", "STATE", "STOP"}
    assert len(world.send_ms["GRAD"]) == 3 and len(world.send_ms["APPLY"]) == 3
    assert _no_children()


def test_a_step_reuses_the_slices_and_every_rank_applies_its_own():
    batch = {**_learn_batch(3), "core_state": ()}
    world = LocalDP(["cpu", "cpu"], cases.build_transformer, args=((F,), 1))
    try:
        state = world.replicate(cases.transformer("cpu", (F,), seed=0))
        grad_step = tlearner.make_grad_step(mesh=world.mesh)
        apply_step = tlearner.make_apply_step()
        mine = []
        for k in range(2):
            state, _ = world.step(grad_step, apply_step, state, batch,
                                  reuse=k > 0)
            mine.append(param_checksums(state.model))
        (report,) = world.close(state.model)
    finally:
        world.close()
    assert world.checksum_diff == 0 and report["updates"] == 2
    assert torch.equal(report["digest"], _digest(mine))
    assert not torch.equal(mine[0], mine[1])
    # Against the plain step on the whole batch, twice.
    plain = cases.transformer("cpu", (F,), seed=0)
    step = tlearner.make_impala_train_step()
    whole = {**{k: torch.from_numpy(v) for k, v in _learn_batch(3).items()},
             "core_state": ()}
    for _ in range(2):
        plain, _ = step(plain, whole)
    for (k, p), q in zip(state.model.named_parameters(),
                         plain.model.parameters()):
        _close_rel(p.detach().numpy(), q.detach().numpy(), 1e-5, k)


def test_a_follower_whose_build_raises_fails_the_world_naming_its_rank():
    with pytest.raises(RuntimeError, match=r"dp rank 1 raised(.|\n)*"
                       r"a follower whose build raises"):
        with LocalDP(["cpu", "cpu"], cases.build_raising) as world:
            world.replicate(cases.transformer("cpu", (F,)))
    assert _no_children()
    assert not torch.distributed.is_initialized()


def test_a_follower_that_exits_while_it_builds_fails_the_world_naming_it():
    with pytest.raises(RuntimeError, match=r"dp rank 1 died before it "
                       r"built its learner \(exit code 7\)"):
        LocalDP(["cpu", "cpu"], cases.build_exiting)
    assert _no_children()
    assert not torch.distributed.is_initialized()


# -- train() over a dp world --------------------------------------------------------


class _Recording(LocalDP):
    """A LocalDP that keeps every world train() makes."""

    made: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Recording.made.append(self)


@pytest.fixture
def recording(monkeypatch):
    _Recording.made = []
    monkeypatch.setattr(local_dp, "LocalDP", _Recording)
    return _Recording.made


def _pixels(**kw):
    # tests/test_examples.py:74-93's synthetic-pixel config.
    base = dict(env="synthetic", num_actions=4, episode_length=40,
                total_steps=320, actor_batch_size=4, learn_batch_size=4,
                virtual_batch_size=4, num_actor_processes=2,
                num_actor_batches=2, unroll_length=4, log_interval_steps=160,
                stats_interval=1e9, seed=0)
    return VtraceConfig(**{**base, **kw})


def test_train_on_two_cpu_ranks_updates_checkpoints_and_resumes(tmp_path,
                                                              recording):
    cfg = _pixels(savedir=str(tmp_path), checkpoint_interval=0.0,
                  checkpoint_history_interval=None)
    lines = []
    logs = port_exp.train(cfg, log_fn=lines.append, devices=["cpu", "cpu"])
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])
    assert (tmp_path / "checkpoint.ckpt").exists()
    (world,) = recording
    assert world.dp == 2 and world.backend == "gloo"
    (report,) = world.reports
    # The follower applied every update rank 0 did, and ends on its bits.
    assert report["updates"] == len(world.send_ms["APPLY"]) >= 1
    assert world.checksum_diff == 0
    assert len(world.send_ms["STATE"]) >= 1
    assert any(line.startswith("dp world of 2") for line in lines)

    # The resume's state reaches the follower through STATE: it starts
    # from weights of its own seed and ends on rank 0's bits.
    resumed = []
    logs2 = port_exp.train(_pixels(savedir=str(tmp_path), seed=7,
                                   total_steps=160, log_interval_steps=80),
                           log_fn=resumed.append, devices=["cpu", "cpu"])
    assert any(line.startswith("resumed from") for line in resumed)
    assert logs2[0]["model_version"] >= logs[-1]["model_version"]
    world2 = recording[1]
    assert world2.checksum_diff == 0 and len(world2.send_ms["STATE"]) >= 1
    assert _no_children()


def test_train_transformer_config_on_two_cpu_ranks(tmp_path, recording):
    # tests/test_examples.py:117-136's transformer config.
    cfg = VtraceConfig(
        env="cartpole", model="transformer", total_steps=1_000,
        actor_batch_size=4, learn_batch_size=8, virtual_batch_size=8,
        num_actor_processes=2, unroll_length=5, log_interval_steps=500,
        stats_interval=1e9, seed=0, savedir=str(tmp_path),
        checkpoint_interval=0.0, checkpoint_history_interval=None)
    logs = port_exp.train(cfg, log_fn=lambda *a: None,
                          devices=["cpu", "cpu"])
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])
    assert (tmp_path / "checkpoint.ckpt").exists()
    (world,) = recording
    assert world.dp == 2 and world.checksum_diff == 0
    assert world.reports[0]["updates"] == len(world.send_ms["APPLY"]) >= 1


def test_devices_the_learn_batch_does_not_divide_take_the_plain_step(
        recording):
    # gcd(3, 4) = 1: no world, today's one-device path.
    logs = port_exp.train(_pixels(env="cartpole", total_steps=160),
                          log_fn=lambda *a: None, devices=["cpu"] * 3)
    assert logs and recording == []


def _peer(cfg, devices, out, name):
    try:
        out[name] = port_exp.train(cfg, log_fn=lambda *a: None,
                                   devices=devices)
    except Exception as e:  # moolint: disable=swallow-cancelled -- reported by the test; no event loop in this thread
        out[name] = e


def test_elastic_peer_with_a_dp_world_keeps_its_follower_on_the_leaders_params(
        recording, monkeypatch):
    """Two peers in one group: the leader on one device, a joiner on a dp
    world of two. Each rank's parameters after every apply are recorded:
    the joiner's follower must apply on exactly the leader's parameters,
    version by version, from the state it took at the join on."""
    from moolib_tpu_torch.examples import common
    from moolib_tpu_torch.parallel.local_dp import param_checksums as sums

    applied = {}
    make_apply = tlearner.make_apply_step

    def recording_apply(stepscope=None):
        inner = make_apply(stepscope=stepscope)

        def apply(state, grads):
            state = inner(state, grads)
            applied.setdefault(threading.current_thread().name, []).append(
                sums(state.model))
            return state
        return apply

    monkeypatch.setattr(tlearner, "make_apply_step", recording_apply)
    broker = common.InProcessBroker()
    try:
        base = dict(env="cartpole", total_steps=10**9, actor_batch_size=4,
                    learn_batch_size=4, virtual_batch_size=8,
                    num_actor_processes=1, num_actor_batches=1,
                    unroll_length=4, log_interval_steps=200,
                    stats_interval=1e9, broker=broker.address,
                    group="dp-elastic")
        out = {}
        leader = threading.Thread(target=_peer, name="leader", args=(
            VtraceConfig(**base, seed=1, max_seconds=25.0), ["cpu"], out,
            "leader"))
        leader.start()
        time.sleep(3.0)
        joiner = threading.Thread(target=_peer, name="joiner", args=(
            VtraceConfig(**base, seed=2, max_seconds=12.0), ["cpu", "cpu"],
            out, "joiner"))
        joiner.start()
        joiner.join(120)
        leader.join(120)
    finally:
        broker.close()
    assert not isinstance(out["joiner"], Exception), out["joiner"]
    assert not isinstance(out["leader"], Exception), out["leader"]
    (world,) = recording
    (report,) = world.reports
    mine, lead = applied["joiner"], applied["leader"]
    assert report["updates"] == len(mine) >= 2
    assert torch.equal(report["digest"], _digest(mine))
    assert world.checksum_diff == 0
    # The joiner's k-th apply is one of the leader's, and the rest follow
    # it one for one.
    first = next(i for i, row in enumerate(lead)
                 if torch.equal(row, mine[0]))
    for k, row in enumerate(mine):
        assert torch.equal(row, lead[first + k]), k


def test_a_follower_killed_mid_run_makes_train_raise_and_leaves_no_child(
        recording):
    lines, out = [], {}

    def log(line):
        lines.append(line)

    def run():
        try:
            port_exp.train(_pixels(env="cartpole", total_steps=10**9,
                                   max_seconds=120.0),
                           log_fn=log, devices=["cpu", "cpu"])
            out["err"] = None
        except Exception as e:  # moolint: disable=swallow-cancelled -- the test asserts on it; no event loop in this thread
            out["err"] = e

    t = threading.Thread(target=run)
    t.start()
    deadline = time.monotonic() + 60
    while not (recording and recording[0].send_ms["APPLY"]):
        assert time.monotonic() < deadline, "no update before the kill"
        time.sleep(0.1)
    victim = recording[0]._procs[0]
    victim.kill()
    t0 = time.monotonic()
    t.join(60)
    assert not t.is_alive()
    err = out["err"]
    assert isinstance(err, RuntimeError), err
    assert "dp rank 1" in str(err) and "exit code" in str(err), err
    assert time.monotonic() - t0 < recording[0].timeout
    assert _no_children()
    assert not torch.distributed.is_initialized()


def test_train_refuses_the_cpu_unasked_and_a_device_other_than_devices0():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_exp.train(_pixels(), log_fn=lambda *a: None)
    with pytest.raises(ValueError, match="is not devices"):
        port_exp._learn_devices("cpu:1", ["cpu", "cpu"])
    assert port_exp._learn_devices("cpu", None) == [torch.device("cpu")]
