"""Port parity: moolib_tpu_torch.parallel.pipeline against
moolib_tpu.parallel.pipeline, tick for tick.

The port runs on one world of 4 gloo ranks (pp axes of 2 and 4, the rest
along dp), the reference on pp meshes of the conftest's CPU devices,
with the same stages and microbatches. The reference's memory tests
read XLA's compiled memory analysis; their twins are in
tests/test_torch_cuda.py (torch.cuda.max_memory_allocated on the card).

Tolerances, f32: the reference tests' own (forward 2e-5, gradients
5e-5, remat against stashing 1e-6, the 1F1B loss 2e-5 relative and
gradients 5e-5), for the port against both the sequential model and
the reference's pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_spmd_cases as cases
from moolib_tpu.parallel import pipeline as jpipe
from moolib_tpu.parallel.mesh import make_mesh
from moolib_tpu.utils.jaxenv import shard_map
from moolib_tpu_torch.parallel import pipeline as tpipe
from moolib_tpu_torch.testing.spmd import SpmdWorld

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with SpmdWorld(N, str(tmp_path_factory.mktemp("spmd"))) as w:
        yield w


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stages(rng, n_stages, F):
    return [{"w": (rng.standard_normal((F, F)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(F) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def _jax_pipe(mesh, n_stages, stacked, x, remat=False):
    return unshard(shard_map(
        lambda p, x: jpipe.pipeline_apply(_stage_fn, p, x, axis_name="pp",
                                          remat=remat),
        mesh=mesh, in_specs=(P("pp"), jpipe.MICRO_SPEC),
        out_specs=jpipe.MICRO_SPEC)(stacked, jpipe.shard_microbatches(
            x, n_stages)))


def unshard(y):
    return jpipe.unshard_microbatches(y)


def _assemble(outs, n_stages, key="y"):
    """The [n_micro, mb, F] stream from the pp ranks of dp row 0."""
    by_pp = {o["pp"]: o[key] for o in outs[:n_stages]}
    sharded = np.concatenate([by_pp[d] for d in range(n_stages)], axis=1)
    return sharded.reshape((-1,) + sharded.shape[2:])


def _sequential(stages, x):
    y = x
    for p in stages:
        y = _stage_fn(p, y)
    return np.asarray(y)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8)])
def test_matches_sequential(world, n_stages, n_micro):
    rng = np.random.default_rng(0)
    F, mb = 8, 4
    stages = _stages(rng, n_stages, F)
    x = rng.standard_normal((n_micro, mb, F)).astype(np.float32)
    mesh = make_mesh(dp=1, pp=n_stages, devices=jax.devices()[:n_stages])
    ref = np.asarray(jax.jit(lambda s, x: _jax_pipe(mesh, n_stages, s, x))(
        jpipe.stack_stage_params(stages), x))
    outs = world.run(cases.pipeline_gpipe, stages, x, n_stages, False,
                     False)
    got = _assemble(outs, n_stages)
    np.testing.assert_allclose(got, _sequential(stages, x), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def _ref_grads(stages, x, n_stages):
    mesh = make_mesh(dp=1, pp=n_stages, devices=jax.devices()[:n_stages])
    stacked = jpipe.stack_stage_params(stages)

    def seq_loss(stacked):
        y = x
        for i in range(n_stages):
            y = _stage_fn(jax.tree_util.tree_map(lambda p: p[i], stacked), y)
        return jnp.sum(y ** 2)

    def pipe_loss(stacked):
        return jnp.sum(_jax_pipe(mesh, n_stages, stacked, x) ** 2)

    return (jax.grad(seq_loss)(stacked),
            jax.jit(jax.grad(pipe_loss))(stacked))


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_sequential(world, remat):
    rng = np.random.default_rng(1)
    n_stages, n_micro, F, mb = 4, 4, 6, 3
    stages = _stages(rng, n_stages, F)
    x = rng.standard_normal((n_micro, mb, F)).astype(np.float32)
    g_seq, g_pipe = _ref_grads(stages, x, n_stages)
    outs = world.run(cases.pipeline_gpipe, stages, x, n_stages, remat, True)
    for o in outs:
        for k, g in o["grads"].items():
            for ref in (g_seq, g_pipe):
                np.testing.assert_allclose(g[0], np.asarray(ref[k])[o["pp"]],
                                           rtol=5e-5, atol=5e-5, err_msg=k)


def test_remat_gradients_match(world):
    """remat recomputes stage internals in the backward; its gradients
    are the stashing path's."""
    rng = np.random.default_rng(2)
    stages = _stages(rng, 4, 6)
    x = rng.standard_normal((4, 3, 6)).astype(np.float32)
    plain = world.run(cases.pipeline_gpipe, stages, x, 4, False, True)
    remat = world.run(cases.pipeline_gpipe, stages, x, 4, True, True)
    for a, b in zip(plain, remat):
        for k in a["grads"]:
            np.testing.assert_allclose(a["grads"][k], b["grads"][k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 6), (4, 8)])
def test_1f1b_loss_and_gradients_match_sequential(world, n_stages, n_micro):
    rng = np.random.default_rng(3)
    F, mb = 6, 3
    stages = _stages(rng, n_stages, F)
    x = rng.standard_normal((n_micro, mb, F)).astype(np.float32)
    mesh = make_mesh(dp=1, pp=n_stages, devices=jax.devices()[:n_stages])
    stacked = jpipe.stack_stage_params(stages)

    def seq_loss(stacked):
        y = x
        for i in range(n_stages):
            y = _stage_fn(jax.tree_util.tree_map(lambda p: p[i], stacked), y)
        return jnp.sum(y ** 2)

    loss_ref, g_ref = jax.value_and_grad(seq_loss)(stacked)
    loss_1f1b, g_1f1b = jax.jit(shard_map(
        lambda p, x: jpipe.pipeline_train_1f1b(
            _stage_fn, lambda y: jnp.sum(y ** 2), p, x, axis_name="pp"),
        mesh=mesh, in_specs=(P("pp"), P()), out_specs=(P(), P("pp"))))(
        stacked, x)
    for loss, grads, d in world.run(cases.pipeline_1f1b, stages, x,
                                    n_stages):
        np.testing.assert_allclose(loss, float(loss_ref), rtol=2e-5)
        np.testing.assert_allclose(loss, float(loss_1f1b), rtol=2e-5)
        for k, g in grads.items():
            for ref in (g_ref, g_1f1b):
                np.testing.assert_allclose(g[0], np.asarray(ref[k])[d],
                                           rtol=5e-5, atol=5e-5, err_msg=k)


def test_shard_microbatches_requires_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        tpipe.shard_microbatches(torch.zeros((6, 2, 4)), 4)
    x = torch.arange(48.0).reshape(8, 2, 3)
    sh = tpipe.shard_microbatches(x, 4)
    np.testing.assert_array_equal(
        sh.numpy(), np.asarray(jpipe.shard_microbatches(x.numpy(), 4)))
    np.testing.assert_array_equal(tpipe.unshard_microbatches(sh).numpy(),
                                  x.numpy())
    stacked = tpipe.stack_stage_params([{"w": torch.ones(2)},
                                        {"w": torch.zeros(2)}])
    assert stacked["w"].shape == (2, 2)
    assert tpipe.MICRO_SPEC == (None, "pp")
