"""Port parity: moolib_tpu_torch.parallel.distributed (multi-process
bring-up, global meshes, host-local batches), the psum plane of
bench_allreduce_torch.py and the multi-device dry run.

Two gloo ranks (torch_spmd_cases.py, a FileStore rendezvous in
tmp_path) play the reference's two controllers: each feeds its own
rollouts through host_local_batch_to_global into one dp train step of
a small ImpalaNet, from rank 0's parameters (replicate_state). The
reference runs the same step on the concatenated batch on a dp=2 mesh
of the conftest's CPU devices. Tolerances: the two ranks bit for bit
(they apply the same reduced gradients); against the reference the
loss metrics 1e-5 relative and the parameters after one RMSprop step
2e-5 absolute (convolution gradients of a jitted reference differ from
op-by-op ones by up to 2.6e-3 of their largest entry where max-pool
windows nearly tie, tests/test_torch_learner.py; a step scales a
gradient difference by at most 10 * lr).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_spmd_cases as cases
from moolib_tpu import learner as jlearner
from moolib_tpu.models import ImpalaNet as JaxImpalaNet
from moolib_tpu.parallel.mesh import make_mesh, shard_batch
from moolib_tpu_torch.models import impala_params_from_flax
from moolib_tpu_torch.testing.spmd import SpmdWorld

REPO_ROOT = Path(__file__).resolve().parent.parent
N = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with SpmdWorld(N, str(tmp_path_factory.mktemp("spmd"))) as w:
        yield w


def test_initialize_is_idempotent_and_needs_its_backend(world):
    for rank, out in enumerate(world.run(cases.distributed_bringup)):
        assert out["initialized"] is True
        assert (out["count"], out["index"]) == (N, rank)
        assert out["shape"] == (N, 1, 1, 1, 1)
        assert out["backend"] == "ValueError"   # not nccl or gloo
        assert out["rank"] == "RuntimeError"    # up under another rank


def _local_batch(rank, T=2, B_local=2, H=8, W=8, C=1):
    rng = np.random.default_rng(rank)
    return {
        "obs": rng.integers(0, 255, (T + 1, B_local, H, W, C),
                            dtype=np.uint8),
        "done": rng.random((T + 1, B_local)) < 0.1,
        "rewards": rng.standard_normal((T + 1, B_local)).astype(np.float32),
        "actions": rng.integers(0, 4, (T, B_local)).astype(np.int32),
        "behavior_logits": np.zeros((T, B_local, 4), np.float32),
    }


def test_two_process_distributed_train_step(world):
    locals_ = [_local_batch(r) for r in range(N)]
    net = JaxImpalaNet(num_actions=4, channels=(4,))
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((3, 1, 8, 8, 1), jnp.uint8),
                      jnp.zeros((3, 1), bool), ())
    sd = {k: v.numpy() for k, v in impala_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    glob = {k: np.concatenate([b[k] for b in locals_], axis=1)
            for k in locals_[0]}
    opt = optax.chain(optax.clip_by_global_norm(40.0),
                      optax.rmsprop(6e-4, decay=0.99, eps=0.01))
    mesh = make_mesh(dp=N, devices=jax.devices()[:N])
    step = jlearner.make_impala_train_step(net.apply, opt, mesh=mesh,
                                           donate=False)
    state, jm = step(jlearner.make_train_state(params, opt), shard_batch(
        mesh, {**{k: jnp.asarray(v) for k, v in glob.items()},
               "core_state": ()}))
    want = impala_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          state.params))
    outs = world.run(cases.distributed_train_step, sd, locals_)
    for shape, p, m, steps in outs:
        assert shape == (3, 2 * N, 8, 8, 1)  # the global batch
        assert steps == 1
        for k in ("total_loss", "pg_loss", "baseline_loss", "entropy"):
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for k, v in p.items():
            np.testing.assert_allclose(v, want[k].numpy(), rtol=0,
                                       atol=2e-5, err_msg=k)
    for k in outs[0][1]:
        np.testing.assert_array_equal(outs[0][1][k], outs[1][1][k])


def test_psum_plane_is_a_protocol_check_over_gloo(capsys):
    import bench_allreduce_torch

    rows = bench_allreduce_torch.bench_psum("gloo", 2, (1024,),
                                            timeout=120.0)
    assert [set(r) for r in rows] == [{"plane", "peers", "mb", "ms",
                                       "gbps"}]
    assert rows[0]["plane"] == "cpu_psum_protocol_check"
    assert rows[0]["peers"] == 2 and rows[0]["ms"] > 0
    note = bench_allreduce_torch.bench_psum("gloo", 1)
    assert note == [{"plane": "cpu_psum_protocol_check", "peers": 1,
                     "note": "single device: psum is a no-op, nothing to "
                             "measure"}]
    with pytest.raises(ValueError):
        bench_allreduce_torch.bench_psum("mpi")
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2  # one row, one note


def test_dryrun_multichip_runs_every_leg():
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.dryrun_multichip",
         "2"], cwd=str(REPO_ROOT), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    for leg in ("dp", "sp", "tp", "pp", "ep"):
        assert any(l.startswith(f"dryrun leg {leg} ok") for l in lines), \
            lines
    assert lines[-1] == "dryrun_multichip(2) ok on 2 cpu ranks (gloo)"
