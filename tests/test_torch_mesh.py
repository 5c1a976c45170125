"""Port parity: moolib_tpu_torch.parallel.mesh and the learner's mesh path
against moolib_tpu's on the conftest's virtual CPU mesh.

The port runs on one world of 4 gloo ranks (torch_spmd_cases.py, a
FileStore rendezvous in tmp_path); the reference on meshes of 2 or 4 of
the conftest's 8 CPU devices, fed the same numpy inputs.

Tolerances, f32:
- shard_batch, psum and pmean exact (the same values, the same sums);
- the A2C dp gradients rtol 1e-5, atol 1e-6 (the reference test's);
- the TransformerNet dp step: metrics 1e-5 relative, gradients 1e-4 of
  each tensor's largest entry and parameters after one RMSprop step 1e-6
  absolute (tests/test_torch_learner.py's: the same sums in other
  orders, and a step scales gradient differences by < 0.1);
- a dp=1 mesh's step against the plain step: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import torch_spmd_cases as cases
from moolib_tpu import learner as jlearner
from moolib_tpu.models import A2CNet as JaxA2CNet
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.parallel import mesh as jmesh
from moolib_tpu.utils.jaxenv import shard_map
from moolib_tpu_torch.models import (
    a2c_params_from_flax,
    transformer_params_from_flax,
)
from moolib_tpu_torch.testing.spmd import SpmdWorld

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with SpmdWorld(N, str(tmp_path_factory.mktemp("spmd"))) as w:
        yield w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale, err_msg=err_msg)


def test_make_mesh_shapes(world):
    got = world.run(cases.mesh_layouts)
    want_shapes = {"[]": (4, 1, 1, 1, 1), "[('sp', 2), ('tp', 2)]":
                   (1, 2, 2, 1, 1), "[('ep', 2), ('pp', 2)]":
                   (1, 1, 1, 2, 2)}
    devices = jax.devices()[:N]
    for key, kw in (("[]", {}), ("[('sp', 2), ('tp', 2)]",
                                 dict(tp=2, sp=2)),
                    ("[('ep', 2), ('pp', 2)]", dict(pp=2, ep=2))):
        ref = jmesh.make_mesh(devices=devices, **kw)
        assert ref.devices.shape == want_shapes[key]
        for rank, out in enumerate(got):
            shape, coords = out[key]
            assert shape == want_shapes[key]
            # Rank r sits where the reference puts device r.
            where = np.argwhere(ref.devices == devices[rank])[0]
            assert coords == list(where), (key, rank)
    with pytest.raises(ValueError) as e:
        jmesh.make_mesh(dp=3, tp=3, devices=devices)
    assert all(out["error"] == str(e.value) for out in got)


def test_shard_batch_places_on_dp(world):
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((4, 16, 3)).astype(np.float32)
    r = rng.standard_normal((4, 16)).astype(np.float32)
    core = rng.standard_normal((16, 5)).astype(np.float32)
    mesh = jmesh.make_mesh(devices=jax.devices()[:N])
    ref = jmesh.shard_batch(mesh, {"obs": obs, "r": r, "core_state": (core,)})
    assert ref["obs"].sharding.spec[1] == "dp"
    assert jmesh.data_parallel_spec()[1] == "dp"
    from moolib_tpu_torch.parallel import mesh as tmesh

    assert tmesh.data_parallel_spec() == (None, "dp")
    assert tmesh.replicated_spec() == ()

    def shard_of(arr, device):
        return next(np.asarray(s.data) for s in arr.addressable_shards
                    if s.device == device)

    for rank, (o, rr, c) in enumerate(world.run(cases.shard_batch_case,
                                                obs, r, core)):
        dev = jax.devices()[rank]
        assert o.shape == (4, 4, 3)
        np.testing.assert_array_equal(o, shard_of(ref["obs"], dev))
        np.testing.assert_array_equal(rr, shard_of(ref["r"], dev))
        np.testing.assert_array_equal(c, shard_of(ref["core_state"][0], dev))


def test_psum_gradients_in_shard_map(world):
    mesh = jmesh.make_mesh(devices=jax.devices()[:N])
    f = jax.jit(shard_map(
        lambda g: (jmesh.psum_gradients(g), jmesh.pmean_gradients(g)),
        mesh=mesh, in_specs=P("dp"), out_specs=(P("dp"), P("dp"))))
    values = np.arange(N, dtype=np.float32) * 1.5
    jsum, jmean = f(jnp.asarray(values))
    for rank, (s, m) in enumerate(world.run(cases.psum_case, values)):
        np.testing.assert_array_equal(s, np.asarray(jsum)[rank:rank + 1])
        np.testing.assert_array_equal(m, np.asarray(jmean)[rank:rank + 1])


def test_data_parallel_train_step_grads_match_single_device(world):
    """dp-averaged gradients == the single-device gradient of the full
    batch (the reference's own test, its net and loss)."""
    net = JaxA2CNet(num_actions=3, hidden_sizes=(16,))
    T, B, F = 4, 16, 5
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((T, B, F)).astype(np.float32)
    done = np.zeros((T, B), bool)
    params = net.init(jax.random.key(0), jnp.asarray(obs[:, :1]),
                      jnp.asarray(done[:, :1]), ())

    def loss_fn(p, o, d):
        (logits, baseline), _ = net.apply(p, o, d, ())
        return jnp.mean(logits ** 2) + jnp.mean(baseline ** 2)

    ref = a2c_params_from_flax(_np(jax.grad(loss_fn)(
        params, jnp.asarray(obs), jnp.asarray(done))))
    sd = {k: v.numpy() for k, v in a2c_params_from_flax(_np(params)).items()}
    for grads in world.run(cases.a2c_dp_grads, sd, obs, done):
        assert set(grads) == set(ref)
        for k, g in grads.items():
            np.testing.assert_allclose(g, ref[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _learn_batch(seed, T=4, B=8, A=6):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((T + 1, B, 5)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.25,
        "rewards": (2.0 * rng.standard_normal((T + 1, B))).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }


def _jax_transformer(batch):
    jnet = JaxTransformerNet(num_actions=6, attention_backend="dense",
                             d_model=32, num_layers=2, num_heads=2)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(batch["obs"]),
                       jnp.asarray(batch["done"]), ())
    sd = {k: v.numpy() for k, v in transformer_params_from_flax(
        _np(params)).items()}
    return jnet, params, sd


def _jbatch(batch):
    return {**{k: jnp.asarray(v) for k, v in batch.items()},
            "core_state": ()}


def _rmsprop():
    return optax.chain(optax.clip_by_global_norm(40.0),
                       optax.rmsprop(6e-4, decay=0.99, eps=0.01))


METRICS = ("total_loss", "pg_loss", "baseline_loss", "entropy",
           "mean_baseline", "grad_norm")


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_train_step_matches_the_reference_mesh_step(world, dp):
    batch = _learn_batch(3)
    jnet, params, sd = _jax_transformer(batch)
    mesh = jmesh.make_mesh(dp=dp, devices=jax.devices()[:dp])
    opt = _rmsprop()
    step = jlearner.make_impala_train_step(jnet.apply, opt, mesh=mesh,
                                           donate=False)
    state, jm = step(jlearner.make_train_state(params, opt),
                     jmesh.shard_batch(mesh, _jbatch(batch)))
    want = transformer_params_from_flax(_np(state.params))
    outs = world.run(cases.dp_train_step, sd, batch, dp)
    for p, m in outs:
        for k in METRICS:
            _close_rel(m[k], jm[k], 1e-5, k)
        for k, v in p.items():
            np.testing.assert_allclose(v, want[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
    # Every rank applied the same reduced gradients.
    for p, _ in outs[1:]:
        for k, v in p.items():
            np.testing.assert_array_equal(v, outs[0][0][k])


def test_dp_grad_step_matches_the_reference(world):
    batch = _learn_batch(4)
    jnet, params, sd = _jax_transformer(batch)
    mesh = jmesh.make_mesh(devices=jax.devices()[:N])
    jgrads, jm = jlearner.make_grad_step(jnet.apply, mesh=mesh)(
        params, jmesh.shard_batch(mesh, _jbatch(batch)))
    want = transformer_params_from_flax(_np(jgrads))
    for grads, m in world.run(cases.dp_grad_step, sd, batch):
        for k in METRICS:
            _close_rel(m[k], jm[k], 1e-5, k)
        for k, g in grads.items():
            _close_rel(g, want[k].numpy(), 1e-4, k)


def test_dp1_mesh_step_is_the_plain_step_bit_for_bit(world):
    batch = _learn_batch(5)
    _, _, sd = _jax_transformer(batch)
    for meshed, plain in world.run(cases.dp1_bitwise, sd, batch):
        for a, b in zip(meshed, plain):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_transport_follows_the_backend_and_raises_otherwise(world):
    for out in world.run(cases.collectives_backends):
        assert out["cpu"] == "direct"
        assert "no transport for meta tensors over a gloo" in out["meta"]
