"""Port parity: moolib_tpu_torch.ops.ring_attention and TransformerNet's
ring backends against moolib_tpu's on the conftest's virtual CPU mesh.

The port runs on one world of 4 gloo ranks (sp axes of 2 and 4, the
rest of the world along dp); the reference on sp meshes of the same
size from the conftest's CPU devices, fed the same numpy inputs.

Tolerances, f32: the reference tests' own (ring vs dense 2e-5, ring
gradients 1e-4, zigzag 2e-5, zigzag gradients 5e-5, the zigzag
TransformerNet 3e-5, its training gradients 8e-5); the port against the
reference's ring functions at the same bounds. zigzag_order exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_spmd_cases as cases
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.models.transformer import segment_ids_from_done
from moolib_tpu.ops import ring_attention as jring
from moolib_tpu.ops.attention import dense_attention
from moolib_tpu.parallel.mesh import make_mesh
from moolib_tpu.utils.jaxenv import shard_map
from moolib_tpu_torch.models import transformer_params_from_flax
from moolib_tpu_torch.ops import ring_attention as tring
from moolib_tpu_torch.testing.spmd import SpmdWorld

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with SpmdWorld(N, str(tmp_path_factory.mktemp("spmd"))) as w:
        yield w


def _qkv(rng, B=2, H=3, T=64, D=16):
    return tuple(rng.standard_normal((B, H, T, D)).astype(np.float32)
                 for _ in range(3))


def _segs(rng, B=2, T=64):
    return np.cumsum(rng.random((B, T)) < 0.08, axis=1).astype(np.int32)


def _sp_mesh(n):
    return make_mesh(dp=1, sp=n, devices=jax.devices()[:n])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_segs", [False, True])
def test_ring_matches_dense(world, causal, with_segs):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    seg = _segs(rng) if with_segs else None
    jseg = None if seg is None else jnp.asarray(seg)
    o_dense = np.asarray(dense_attention(q, k, v, causal=causal,
                                         segment_ids=jseg))
    o_ref = np.asarray(jring.sequence_sharded_attention(
        _sp_mesh(N), q, k, v, causal=causal, segment_ids=jseg))
    for o, *_ in world.run(cases.ring_case, q, k, v, seg, causal, N):
        np.testing.assert_allclose(o, o_dense, atol=2e-5)
        np.testing.assert_allclose(o, o_ref, atol=2e-5)


def test_ring_gradients(world):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, T=32, B=1, H=2, D=8)
    spec = P(None, None, "sp", None)
    mesh = _sp_mesh(N)

    def ring_loss(q):
        f = shard_map(
            lambda q, k, v: jring.ring_attention(q, k, v, causal=True),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
        return jnp.sum(f(q, k, v) ** 2)

    g_dense = np.asarray(jax.grad(
        lambda q: jnp.sum(dense_attention(q, k, v, causal=True) ** 2))(q))
    g_ring = np.asarray(jax.jit(jax.grad(ring_loss))(q))
    rows = np.split(np.arange(32), N)
    for rank, dq in enumerate(world.run(cases.ring_local_grads, q, k, v, N)):
        np.testing.assert_allclose(dq, g_dense[:, :, rows[rank]], atol=1e-4)
        np.testing.assert_allclose(dq, g_ring[:, :, rows[rank]], atol=1e-4)


def test_ring_wrapper_gradients_are_global(world):
    """sequence_sharded_attention is differentiable end to end: every
    rank holds the full gradients of q, k and v."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, T=32, B=1, H=2, D=8)
    seg = _segs(rng, B=1, T=32)
    g = jax.grad(lambda q, k, v: jnp.sum(dense_attention(
        q, k, v, causal=True, segment_ids=jnp.asarray(seg)) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    for out in world.run(cases.ring_case, q, k, v, seg, True, 2):
        for got, want in zip(out[1:], g):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("n,S", [(2, 16), (4, 32), (8, 64), (3, 12),
                                 (1, 4)])
def test_zigzag_order_is_the_references(n, S):
    got = tring.zigzag_order(n, S)
    np.testing.assert_array_equal(got, jring.zigzag_order(n, S))
    assert sorted(got.tolist()) == list(range(S))
    x = np.arange(S)
    np.testing.assert_array_equal(x[got][np.argsort(got)], x)
    with pytest.raises(ValueError, match="divisible"):
        tring.zigzag_order(n, S + 1)


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_matches_dense_causal(world, n):
    rng = np.random.default_rng(3)
    B, H, S, D = 2, 2, 4 * n, 8
    q, k, v = _qkv(rng, B=B, H=H, T=S, D=D)
    ref = np.asarray(dense_attention(q, k, v, causal=True))
    jz = np.asarray(jring.zigzag_sharded_attention(_sp_mesh(n), q, k, v))
    for o, *_ in world.run(cases.ring_case, q, k, v, None, True, n, True):
        np.testing.assert_allclose(o, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(o, jz, rtol=2e-5, atol=2e-5)


def test_zigzag_matches_dense_causal_with_segments(world):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, B=2, H=2, T=32, D=8)
    seg = _segs(rng, B=2, T=32)
    ref = np.asarray(dense_attention(q, k, v, causal=True,
                                     segment_ids=jnp.asarray(seg)))
    for o, *_ in world.run(cases.ring_case, q, k, v, seg, True, N, True):
        np.testing.assert_allclose(o, ref, rtol=2e-5, atol=2e-5)


def test_zigzag_gradients_match_dense(world):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, B=1, H=2, T=16, D=4)
    g_ref = jax.grad(lambda q, k, v: jnp.sum(dense_attention(
        q, k, v, causal=True) ** 2), argnums=(0, 1, 2))(q, k, v)
    g_zig = jax.grad(lambda q, k, v: jnp.sum(jring.zigzag_sharded_attention(
        _sp_mesh(2), q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)
    for out in world.run(cases.ring_case, q, k, v, None, True, 2, True):
        for got, a, b in zip(out[1:], g_ref, g_zig):
            np.testing.assert_allclose(got, np.asarray(a), rtol=5e-5,
                                       atol=5e-5)
            np.testing.assert_allclose(got, np.asarray(b), rtol=5e-5,
                                       atol=5e-5)


def _ring_model_inputs(T, seed):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, 2, 5)).astype(np.float32)
    done = rng.random((T, 2)) < 0.1
    seg = np.asarray(segment_ids_from_done(jnp.asarray(done)))
    kw = dict(num_actions=3, d_model=16, num_layers=1, num_heads=2,
              max_len=T)
    dense = JaxTransformerNet(attention_backend="dense", **kw)
    positions = jnp.arange(T)
    params = dense.init(jax.random.PRNGKey(0), obs, done, (),
                        segment_ids=jnp.asarray(seg), positions=positions)
    sd = {k: v.numpy() for k, v in transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return obs, done, seg, dense, params, sd


@pytest.mark.parametrize("backend", ["ring", "zigzag"])
def test_transformer_ring_backends_match_dense(world, backend):
    """The ring backends on T shards reproduce the dense model on the
    whole unroll (the reference's zigzag test, and ring beside it)."""
    n, T = N, 8 * N
    obs, done, seg, dense, params, sd = _ring_model_inputs(T, 0)
    (l_ref, b_ref), _ = dense.apply(params, obs, done, (),
                                    segment_ids=jnp.asarray(seg),
                                    positions=jnp.arange(T))
    outs = world.run(cases.transformer_ring_case, sd, obs, done, seg, n,
                     backend, False)
    logits = np.zeros_like(np.asarray(l_ref))
    baseline = np.zeros_like(np.asarray(b_ref))
    for out in outs[:n]:  # one sp group
        logits[out["rows"]] = out["logits"]
        baseline[out["rows"]] = out["baseline"]
    np.testing.assert_allclose(logits, np.asarray(l_ref), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(baseline, np.asarray(b_ref), rtol=3e-5,
                               atol=3e-5)


def test_transformer_zigzag_training_keeps_sharded_layout(world):
    """Per-shard partial losses in zigzag layout, gradients summed over
    sp: the dense model's gradients (the reference's test at T=512)."""
    n, T = N, 512
    obs, done, seg, dense, params, sd = _ring_model_inputs(T, 1)

    def ref_loss(params):
        (l, b), _ = dense.apply(params, obs, done, (),
                                segment_ids=jnp.asarray(seg),
                                positions=jnp.arange(T))
        return jnp.mean(l ** 2) + jnp.mean(b ** 2)

    want = transformer_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(ref_loss))(params)))
    outs = world.run(cases.transformer_ring_case, sd, obs, done, seg, n,
                     "zigzag", True)
    for out in outs:
        for k, g in out["grads"].items():
            np.testing.assert_allclose(g, want[k].numpy(), rtol=8e-5,
                                       atol=8e-5, err_msg=k)


def test_ring_backends_need_their_mesh_positions_and_segments():
    from moolib_tpu_torch.models import TransformerNet

    with pytest.raises(ValueError, match="mesh"):
        TransformerNet(3, (5,), attention_backend="ring", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        TransformerNet(3, (5,), attention_backend="nope", device="cpu")
    import torch

    net = TransformerNet(3, (5,), attention_backend="zigzag",
                         mesh=object(), device="cpu", d_model=16,
                         num_layers=1, num_heads=2)
    obs, done = torch.zeros(4, 1, 5), torch.zeros(4, 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="positions"):
        net(obs, done, (), segment_ids=torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="segment_ids"):
        net(obs, done, (), positions=torch.arange(4))
