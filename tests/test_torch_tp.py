"""Port parity: moolib_tpu_torch.parallel.tp against moolib_tpu.parallel.tp.

The port's placements are DTensor Shard/Replicate on mesh["tp"], read
off its parameter names and shapes (an nn.Linear weight is [out, in],
flax's kernel transposed: the reference's P(None, "tp") is Shard(0),
P("tp", None) is Shard(1)). Its tp forward computes on local shards
with Megatron's region operators; the reference's is GSPMD placement.
The port runs on one world of 4 gloo ranks (dp=2 x tp=2), the reference
on the same mesh of the conftest's CPU devices.

Tolerances, f32: the reference tests' own (forward 2e-5; the train
step's loss 1e-4 relative and parameters rtol 2e-4, atol 2e-5); the
ImpalaNet forward 1e-5 of the largest logit (convolution sums in other
orders). Shard shapes exactly, transposed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_spmd_cases as cases
from moolib_tpu.learner import (
    ImpalaConfig,
    make_impala_train_step,
    make_train_state,
)
from moolib_tpu.models import ImpalaNet as JaxImpalaNet
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.parallel import tp as jtp
from moolib_tpu.parallel.mesh import make_mesh, shard_batch
from moolib_tpu_torch.models import (
    ImpalaNet,
    TransformerNet,
    impala_params_from_flax,
    transformer_params_from_flax,
)
from moolib_tpu_torch.parallel import tp as ttp
from moolib_tpu_torch.testing.spmd import SpmdWorld

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with SpmdWorld(N, str(tmp_path_factory.mktemp("spmd"))) as w:
        yield w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _transformer_setup():
    net = JaxTransformerNet(num_actions=4, d_model=16, num_layers=1,
                            num_heads=2, attention_backend="dense")
    T, B, F = 6, 4, 5
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((T, B, F)).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    params = net.init(jax.random.PRNGKey(0), obs, done, ())
    sd = {k: v.numpy() for k, v in
          transformer_params_from_flax(_np(params)).items()}
    return net, params, sd, obs, done


def _port_transformer():
    return TransformerNet(4, (5,), d_model=16, num_layers=1, num_heads=2,
                          attention_backend="dense", device="cpu")


def test_transformer_tp_specs_cover_megatron_pattern():
    from torch.distributed.tensor import Shard

    specs = ttp.transformer_tp_specs(_port_transformer())
    col, row = Shard(0), Shard(1)
    assert specs["blocks.0.attn.qkv.weight"] == col
    assert specs["blocks.0.mlp_in.weight"] == col
    assert specs["blocks.0.mlp_in.bias"] == col
    assert specs["blocks.0.attn.out.weight"] == row
    assert specs["blocks.0.mlp_out.weight"] == row
    assert specs["blocks.0.mlp_out.bias"].is_replicate()
    assert specs["pos_emb.weight"].is_replicate()
    assert ttp.count_sharded_leaves(specs) == 5 * 1  # num_layers=1
    # The reference's count on the same model.
    _, params, *_ = _transformer_setup()
    assert jtp.count_sharded_leaves(jtp.transformer_tp_specs(params)) == 5


def test_tp_specs_are_rename_insensitive_and_fail_loudly():
    named = {k: v.detach() for k, v in
             _port_transformer().named_parameters()}
    ref_count = ttp.count_sharded_leaves(ttp.transformer_tp_specs(named))
    assert ref_count == 5
    renames = {"blocks.0.attn.qkv": "encoder.0.attention.fused_qkv",
               "blocks.0.attn.out": "encoder.0.attention.proj",
               "blocks.0.mlp_in": "encoder.0.up",
               "blocks.0.mlp_out": "encoder.0.down",
               "blocks.0.ln1": "encoder.0.norm_a",
               "blocks.0.ln2": "encoder.0.norm_b"}

    def rename(k):
        for a, b in renames.items():
            if k.startswith(a + "."):
                return b + k[len(a):]
        return k

    renamed = {rename(k): v for k, v in named.items()}
    assert ttp.count_sharded_leaves(
        ttp.transformer_tp_specs(renamed)) == ref_count

    # A wide action head outside any block replicates.
    import torch

    wide = dict(named)
    wide["policy.weight"] = torch.zeros(32, 16)
    wide["policy.bias"] = torch.zeros(32)
    specs = ttp.transformer_tp_specs(wide)
    assert specs["policy.weight"].is_replicate()
    assert ttp.count_sharded_leaves(specs) == ref_count

    degenerate = {"ln.weight": torch.ones(16), "ln.bias": torch.zeros(16),
                  "head.weight": torch.zeros(3, 16),
                  "head.bias": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="replicate"):
        ttp.transformer_tp_specs(degenerate)

    # ImpalaNet: the reference's count, rename-insensitive, loud.
    inet = ImpalaNet(4, (84, 84, 4), device="cpu")
    ispecs = ttp.impala_tp_specs(inet)
    assert ttp.count_sharded_leaves(ispecs) == 4
    jnet = JaxImpalaNet(num_actions=4)
    jp = jnet.init(jax.random.PRNGKey(0),
                   jnp.zeros((2, 1, 84, 84, 4), jnp.uint8),
                   jnp.zeros((2, 1), bool), ())
    assert jtp.count_sharded_leaves(jtp.impala_tp_specs(jp)) == 4
    inamed = dict(inet.named_parameters())
    moved = {k.replace("fc.", "torso_proj.").replace("policy.", "pi.")
             .replace("baseline.", "vf."): v for k, v in inamed.items()}
    assert ttp.count_sharded_leaves(ttp.impala_tp_specs(moved)) == 4
    with pytest.raises(RuntimeError, match="flatten-shaped"):
        ttp.impala_tp_specs({"d.weight": torch.zeros(16, 16),
                             "d.bias": torch.zeros(16)})


def test_transformer_tp2_matches_tp1(world):
    net, params, sd, obs, done = _transformer_setup()

    def fwd(params, obs, done):
        (logits, baseline), _ = net.apply(params, obs, done, ())
        return logits, baseline

    ref_logits, ref_baseline = jax.jit(fwd)(params, obs, done)
    mesh = make_mesh(dp=2, tp=2, sp=1, devices=jax.devices()[:N])
    tp_params = jtp.shard_params(mesh, params, jtp.transformer_tp_specs(
        params))
    qkv = tp_params["params"]["block_0"]["attn"]["qkv"]["kernel"]
    ref_shape = {s.data.shape for s in qkv.addressable_shards}
    assert ref_shape == {(16, 24)}  # [d_model, 3*d_model/tp]
    B = obs.shape[1]
    for l, b, shapes, dp in world.run(cases.tp_forward, sd, obs, done):
        rows = slice(dp * B // 2, (dp + 1) * B // 2)
        np.testing.assert_allclose(l, np.asarray(ref_logits)[:, rows],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(b, np.asarray(ref_baseline)[:, rows],
                                   rtol=2e-5, atol=2e-5)
        # The same shards as the reference's, transposed ([out, in]).
        assert {shapes["blocks.0.attn.qkv.weight"][::-1]} == ref_shape
        assert shapes["blocks.0.mlp_in.weight"] == (32, 16)
        assert shapes["blocks.0.mlp_out.weight"] == (16, 32)
        assert shapes["blocks.0.attn.out.weight"] == (16, 8)


def test_transformer_tp_train_step_parity(world):
    """dp=2 x tp=2: loss+backward+adam match the single-device step."""
    net, params, sd, obs, done = _transformer_setup()
    T, B = done.shape
    A = 4
    rng = np.random.default_rng(1)
    batch = {
        "obs": obs, "done": done,
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "actions": rng.integers(0, A, (T - 1, B)).astype(np.int32),
        "behavior_logits": np.zeros((T - 1, B, A), np.float32),
    }
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()},
              "core_state": ()}
    opt = optax.adam(1e-3)
    step = make_impala_train_step(net.apply, opt, ImpalaConfig(),
                                  donate=False)
    ref_out, ref_metrics = step(make_train_state(params, opt), jbatch)
    mesh = make_mesh(dp=2, tp=2, sp=1, devices=jax.devices()[:N])
    tp_params = jtp.shard_params(mesh, params,
                                 jtp.transformer_tp_specs(params))
    tp_state = make_train_state(tp_params, opt)._replace(
        opt_state=jtp.sharded_init_opt_state(opt, tp_params))
    tp_out, tp_metrics = step(tp_state, shard_batch(mesh, jbatch))
    want = transformer_params_from_flax(_np(ref_out.params))
    want_tp = transformer_params_from_flax(_np(tp_out.params))

    outs = world.run(cases.tp_train_step, sd, batch)
    specs = ttp.transformer_tp_specs(_port_transformer())
    for shards, metrics, _ in outs:
        np.testing.assert_allclose(metrics["total_loss"],
                                   float(ref_metrics["total_loss"]),
                                   rtol=1e-4)
    # Put every parameter together from the tp ranks of dp row 0.
    by_tp = {tp_rank: shards for shards, _, tp_rank in outs[:2]}
    for name, spec in specs.items():
        if spec.is_shard():
            got = np.concatenate([by_tp[r][name] for r in range(2)],
                                 axis=spec.dim)
        else:
            got = by_tp[0][name]
            np.testing.assert_array_equal(got, by_tp[1][name])
        for ref in (want, want_tp):
            np.testing.assert_allclose(got, ref[name].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=name)


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_tp_specs_and_sharding(world, use_lstm):
    jnet = JaxImpalaNet(num_actions=6, use_lstm=use_lstm)
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 256, (1, 2, 84, 84, 4), dtype=np.uint8)
    done = np.zeros((1, 2), bool)
    params = jnet.init(jax.random.PRNGKey(0), obs, done,
                       jnet.initial_state(2))
    mesh = make_mesh(dp=2, tp=2, sp=1, devices=jax.devices()[:N])
    sharded = jtp.shard_params(mesh, params, jtp.impala_tp_specs(params))
    hidden = sharded["params"]["Dense_0"]["kernel"]
    ref_shape = {s.data.shape for s in hidden.addressable_shards}
    assert ref_shape == {(3872, 128)}
    (l_ref, b_ref), _ = jax.jit(
        lambda p, o, d: jnet.apply(p, o, d, jnet.initial_state(2)))(
        params, obs, done)
    sd = {k: v.numpy() for k, v in impala_params_from_flax(
        _np(params)).items()}
    for l, b, shape, count in world.run(cases.impala_tp_forward, sd, obs,
                                        done, use_lstm):
        assert count == 4
        assert {shape[::-1]} == ref_shape
        scale = float(np.abs(np.asarray(l_ref)).max())
        np.testing.assert_allclose(l, np.asarray(l_ref), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(b, np.asarray(b_ref), rtol=0,
                                   atol=1e-5 * max(scale, 1.0))
