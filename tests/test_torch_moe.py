"""Port parity: the mixture-of-experts FFN (moolib_tpu_torch.parallel.moe)
and TransformerNet(mlp="moe") against the JAX reference.

The same seeded numpy inputs and parameters go through both. Tolerances:
forward f32 within 1e-5 of the output's largest entry; the routing
(dispatch) exactly; gradients within 1e-4 of each tensor's largest entry;
with compute_dtype=bfloat16 the MoE blocks see f32 on both sides, so the
f32 tolerance holds there too.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_spmd_cases as cases
from moolib_tpu import learner as jlearner
from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu.models import transformer as jtransformer
from moolib_tpu.parallel import moe as jmoe
from moolib_tpu.parallel.mesh import make_mesh
from moolib_tpu.utils.jaxenv import shard_map
from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.models import (
    TransformerNet,
    moe_aux_losses,
    transformer_params_from_flax,
)
from moolib_tpu_torch.optim import ClippedRMSprop
from moolib_tpu_torch.parallel import moe as tmoe
from moolib_tpu_torch.testing.spmd import SpmdWorld

AUX = ("load_balance_loss", "router_z_loss", "drop_fraction")
SMALL = dict(d_model=32, num_layers=2, num_heads=2, num_experts=4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """4 gloo ranks for the expert-parallel tests (torch_spmd_cases.py)."""
    with SpmdWorld(4, str(tmp_path_factory.mktemp("spmd"))) as w:
        yield w


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=0, atol=rel * scale, err_msg=err_msg)


def _params(seed, D=8, H=12, E=4):
    return jax.tree_util.tree_map(
        np.asarray, jmoe.moe_params(jax.random.PRNGKey(seed), D, H, E))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [None, 3], ids=["default", "drops"])
def test_moe_ffn_matches_reference(top_k, capacity):
    rng = np.random.default_rng(top_k)
    T, D = 32, 8
    params = _params(top_k)
    x = rng.standard_normal((T, D)).astype(np.float32)
    y1, a1 = jmoe.moe_ffn(params, jnp.asarray(x), capacity, top_k=top_k)
    y2, a2 = tmoe.moe_ffn(_t(params), torch.from_numpy(x), capacity,
                          top_k=top_k)
    _close_rel(y2, y1, 1e-5)
    for k in AUX:
        _close_rel(a2[k], a1[k], 1e-5, k)
    if capacity is not None:
        assert float(a2["drop_fraction"]) > 0.5
    # The routing itself, from each package's own probabilities.
    probs1 = jax.nn.softmax(jnp.asarray(x) @ params["router"], -1)
    probs2 = torch.softmax(torch.from_numpy(x) @ _t(params)["router"], -1)
    cap = min(capacity or math.ceil(1.25 * T * top_k / 4), T)
    d1, c1, k1, f1 = jmoe._dispatch_combine(probs1, cap, top_k, jnp.float32)
    d2, c2, k2, f2 = tmoe._dispatch_combine(probs2, cap, top_k,
                                            torch.float32)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    _close_rel(c2, c1, 1e-6)
    assert float(k2) == pytest.approx(float(k1))


@pytest.mark.parametrize("top_k", [1, 2])
def test_ties_go_to_the_lower_expert_as_in_the_reference(top_k):
    """Exactly tied probabilities: jnp.argmax and jax.lax.top_k pick the
    lower index; the port's stable sort does the same."""
    probs = np.array([[0.3, 0.3, 0.2, 0.2],
                      [0.1, 0.4, 0.4, 0.1],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.2, 0.2, 0.3, 0.3]], np.float32)
    for cap in (1, 2, 4):
        d1, c1, _, f1 = jmoe._dispatch_combine(jnp.asarray(probs), cap,
                                               top_k, jnp.float32)
        d2, c2, _, f2 = tmoe._dispatch_combine(torch.from_numpy(probs),
                                               cap, top_k, torch.float32)
        np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
        np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
        np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))


def test_seeded_router_probabilities_have_no_ties():
    """The parity tests' inputs never tie, so the tie order is not what
    they exercise (the test above does)."""
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        params = _params(seed)
        x = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
        p = torch.softmax(x @ _t(params)["router"], -1)
        top = torch.sort(p, -1, descending=True).values
        assert float((top[:, :-1] - top[:, 1:]).min()) > 0


def test_capacity_drops_pass_through_zero():
    """Mirrors the reference's test: over-capacity tokens give exactly 0
    and the drop fraction reports them."""
    rng = np.random.default_rng(0)
    T, D, E, cap = 32, 8, 2, 2
    params = _params(1, D, 12, E)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    y, aux = tmoe.moe_ffn(_t(params), x, capacity=cap)
    assert float(aux["drop_fraction"]) > 0.5
    expert = torch.argmax(x @ _t(params)["router"], -1)
    counts = {e: 0 for e in range(E)}
    kept = np.zeros(T, bool)
    for t in range(T):
        if counts[int(expert[t])] < cap:
            kept[t] = True
            counts[int(expert[t])] += 1
    assert (y.numpy()[~kept] == 0.0).all()
    assert (np.abs(y.numpy()[kept]).sum(-1) > 0).all()
    assert float(aux["drop_fraction"]) == pytest.approx(1.0 - kept.mean())


def test_capacity_default_and_rank_major_seating():
    """Mirrors the reference's test: capacity defaults to
    ceil(cf * T * k / E); adding second choices never evicts a first
    choice."""
    rng = np.random.default_rng(5)
    T = 32
    params = _t(_params(5))
    x = torch.from_numpy(rng.standard_normal((T, 8)).astype(np.float32))
    _, aux = tmoe.moe_ffn(params, x, top_k=2, capacity_factor=0.5)
    assert 0.0 < float(aux["drop_fraction"]) < 1.0
    _, aux_k1 = tmoe.moe_ffn(params, x, capacity=8, top_k=1)
    _, aux_k2 = tmoe.moe_ffn(params, x, capacity=8, top_k=2)
    drop1 = float(aux_k1["drop_fraction"])
    drop2 = float(aux_k2["drop_fraction"])
    assert drop2 >= drop1 - 1e-6
    assert (1 - drop2) * 2 * T >= (1 - drop1) * T - 1e-4
    # Rank-major: with top-2 every first choice that top-1 seats is
    # seated too, in the same slot.
    probs = torch.softmax(x @ params["router"], -1)
    d1, _, _, _ = tmoe._dispatch_combine(probs, 8, 1, torch.float32)
    d2, _, _, f2 = tmoe._dispatch_combine(probs, 8, 2, torch.float32)
    first = d2 * f2[:, :, None]
    assert torch.equal(first, d1)


def test_a_token_depends_on_the_other_tokens_of_its_call():
    """Capacity is over the call's tokens: a token routed alone is seated;
    behind three tokens of the same expert (capacity ceil(1.25 * 4 / 4) =
    2) it is dropped and its output becomes 0. A served reply therefore
    depends on the batch it was stacked into."""
    rng = np.random.default_rng(3)
    params = _t(_params(3))
    token = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    alone, aux = tmoe.moe_ffn(params, token)
    assert float(aux["drop_fraction"]) == 0.0
    assert float(alone.abs().sum()) > 0
    crowd, aux = tmoe.moe_ffn(params, token.repeat(4, 1))
    assert float(aux["drop_fraction"]) == 0.5
    torch.testing.assert_close(crowd[0], alone[0], atol=1e-6, rtol=0)
    assert float(crowd[3].abs().max()) == 0.0


@pytest.mark.parametrize("top_k", [1, 2])
def test_gradients_match_reference(top_k):
    """Gradients of a loss that uses the output and both aux losses, with
    respect to x, the router, w_up and w_down, against jax.grad; the
    router gets gradients through the gates."""
    rng = np.random.default_rng(10 + top_k)
    T = 16
    params = _params(6)
    x = rng.standard_normal((T, 8)).astype(np.float32)
    w = rng.standard_normal((T, 8)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, capacity=6, top_k=top_k)
        return (jnp.sum(y * w) + 0.01 * aux["load_balance_loss"]
                + 0.001 * aux["router_z_loss"])

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _t(params).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_ffn(tp, tx, capacity=6, top_k=top_k)
    loss = (torch.sum(y * torch.from_numpy(w))
            + 0.01 * aux["load_balance_loss"] + 0.001 * aux["router_z_loss"])
    loss.backward()
    _close_rel(tx.grad, jg_x, 1e-4, "x")
    for k in ("router", "w_up", "w_down"):
        assert float(tp[k].grad.abs().sum()) > 0, k
        _close_rel(tp[k].grad, jg_p[k], 1e-4, k)


def test_router_gets_gradients():
    """Mirrors the reference's test: the output alone trains the router."""
    rng = np.random.default_rng(3)
    tp = {k: v.requires_grad_() for k, v in _t(_params(3)).items()}
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y, aux = tmoe.moe_ffn(tp, x, capacity=16)
    (torch.sum(y ** 2) + 0.01 * aux["load_balance_loss"]).backward()
    assert float(tp["router"].grad.abs().sum()) > 0
    assert float(tp["w_up"].grad.abs().sum()) > 0


def test_moe_params_scaling_and_sharded_raises(world):
    """moe_params' scaling; moe_ffn_sharded (once a raise naming ROADMAP
    item 11) is exported and needs its mesh, and at its default,
    group-wise capacity it is moe_ffn on each rank's tokens alone, drops
    included (4 gloo ranks, ep=4)."""
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_params(64, 256, 8, device="cpu", generator=gen)
    assert p["router"].shape == (64, 8)
    assert p["w_up"].shape == (8, 64, 256)
    assert p["w_down"].shape == (8, 256, 64)
    assert float(p["w_up"].std()) == pytest.approx(64 ** -0.5, rel=0.02)
    assert float(p["w_down"].std()) == pytest.approx(256 ** -0.5, rel=0.02)
    with pytest.raises(TypeError, match="mesh"):
        tmoe.moe_ffn_sharded(p, torch.zeros(4, 64))
    from moolib_tpu_torch import parallel

    assert parallel.moe_ffn is tmoe.moe_ffn
    assert parallel.moe_ffn_sharded is tmoe.moe_ffn_sharded
    rng = np.random.default_rng(9)
    params = _params(9, D=8, H=12, E=8)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    for y, aux, _, g in world.run(cases.moe_sharded, params, x, None, 2):
        xs = x[g * 16:(g + 1) * 16]
        want, _ = jmoe.moe_ffn(params, jnp.asarray(xs), 5, top_k=2)
        _close_rel(y, want, 1e-5)
        assert 0 < aux["drop_fraction"] < 1  # ceil(1.25*16*2/8) = 5 seats


# -- TransformerNet(mlp="moe") ------------------------------------------------


def _obs(rng, T, B):
    return rng.standard_normal((T, B, 5)).astype(np.float32)


def _moe_pair(obs, done, compute_dtype=torch.float32, cf=1.0):
    jdtype = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32
    jnet = JaxTransformerNet(num_actions=6, attention_backend="dense",
                             compute_dtype=jdtype, mlp="moe", moe_top_k=2,
                             moe_capacity_factor=cf, **SMALL)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs),
                       jnp.asarray(done), ())
    net = TransformerNet(6, obs.shape[2:], attention_backend="dense",
                         compute_dtype=compute_dtype, mlp="moe",
                         moe_top_k=2, moe_capacity_factor=cf, device="cpu",
                         **SMALL)
    net.load_state_dict(transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_moe_transformer_and_aux_match_reference(compute_dtype,
                                                 monkeypatch):
    """Forward and moe_aux_losses against the reference with converted
    parameters. At compute_dtype=bfloat16 both packages' MoE layers see
    f32 (flax promotes the bf16 input with the f32 parameters): the
    recorded dtypes say so, and the outputs hold at the f32 tolerance."""
    rng = np.random.default_rng(0)
    T, B = 6, 4
    obs = _obs(rng, T, B)
    done = rng.random((T, B)) < 0.2
    jnet, params, net = _moe_pair(obs, done, compute_dtype)
    seen = []
    real = jtransformer.moe_ffn

    def recording(p, x, *a, **k):
        seen.append(x.dtype)
        return real(p, x, *a, **k)

    monkeypatch.setattr(jtransformer, "moe_ffn", recording)
    ((l1, b1), _), inter = jnet.apply(params, jnp.asarray(obs),
                                      jnp.asarray(done), (),
                                      mutable=["intermediates"])
    jaux = jtransformer.moe_aux_losses(inter)
    port_seen = []
    for blk in net.blocks:
        blk.moe.register_forward_pre_hook(
            lambda mod, args: port_seen.append(args[0].dtype))
    with torch.no_grad():
        (l2, b2), state, aux = net(torch.from_numpy(obs),
                                   torch.from_numpy(done), (),
                                   return_aux=True)
        (l3, _), state3 = net(torch.from_numpy(obs), torch.from_numpy(done))
    assert seen == [jnp.float32] * 2
    assert port_seen == [torch.float32] * 4
    assert state == state3 == ()
    _close_rel(l2, l1, 1e-5)
    _close_rel(b2, b1, 1e-5)
    assert torch.equal(l2, l3)
    assert aux["n_moe_layers"] == jaux["n_moe_layers"] == 2
    for k in AUX:
        _close_rel(aux[k], jaux[k], 1e-5, k)
    assert float(aux["drop_fraction"]) > 0  # capacity factor 1 drops


def test_moe_aux_losses_walks_nests_and_refuses_a_dense_model():
    a = {"load_balance_loss": torch.tensor(1.0),
         "router_z_loss": torch.tensor(2.0),
         "drop_fraction": torch.tensor(0.5)}
    b = {"load_balance_loss": torch.tensor(3.0),
         "router_z_loss": torch.tensor(4.0),
         "drop_fraction": torch.tensor(0.0)}
    got = moe_aux_losses([a, b])
    assert got["n_moe_layers"] == 2
    assert float(got["load_balance_loss"]) == 4.0
    assert float(got["router_z_loss"]) == 6.0
    assert float(got["drop_fraction"]) == 0.25
    net = TransformerNet(4, (5,), device="cpu", d_model=32, num_layers=1,
                         num_heads=2)
    with pytest.raises(ValueError, match="mlp='moe'"):
        net(torch.zeros(2, 1, 5), torch.zeros(2, 1, dtype=torch.bool),
            return_aux=True)


def test_moe_init_uses_each_experts_fan_in():
    gen = torch.Generator().manual_seed(0)
    net = TransformerNet(4, (5,), mlp="moe", num_experts=8, device="cpu",
                         generator=gen, d_model=64, num_layers=1,
                         num_heads=2)
    moe = net.blocks[0].moe.requires_grad_(False)
    assert float(moe.router.std()) == pytest.approx(64 ** -0.5, rel=0.05)
    assert float(moe.w_up.std()) == pytest.approx(64 ** -0.5, rel=0.02)
    assert float(moe.w_down.std()) == pytest.approx(256 ** -0.5, rel=0.02)
    assert not any(k.startswith("blocks.0.mlp_") for k in net.state_dict())


def test_converter_refuses_mixed_dense_and_moe_blocks():
    rng = np.random.default_rng(0)
    obs, done = _obs(rng, 3, 2), np.zeros((3, 2), bool)
    _, moe_params, _ = _moe_pair(obs, done)
    mp = jax.tree_util.tree_map(np.asarray, moe_params)["params"]
    d, h = 32, 128
    dense_mlp = {"Dense_0": {"kernel": np.zeros((d, h), np.float32),
                             "bias": np.zeros(h, np.float32)},
                 "Dense_1": {"kernel": np.zeros((h, d), np.float32),
                             "bias": np.zeros(d, np.float32)}}
    dense_block = {k: v for k, v in mp["block_1"].items() if k != "moe"}
    mixed = {**mp, "block_1": {**dense_block, **dense_mlp}}
    with pytest.raises(KeyError, match="mixes"):
        transformer_params_from_flax(mixed)
    both = {**mp, "block_0": {**mp["block_0"], **dense_mlp}}
    with pytest.raises(KeyError, match="both"):
        transformer_params_from_flax(both)
    # A dense tree does not load into an MoE module.
    dense = {**mp, **{f"block_{i}": {**dense_block, **dense_mlp}
                      for i in range(2)}}
    net = TransformerNet(6, (5,), mlp="moe", device="cpu", **SMALL)
    with pytest.raises(RuntimeError):
        net.load_state_dict(transformer_params_from_flax(dense))


def _batch(seed, T=4, B=2, A=6):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((T + 1, B, 5)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.25,
        "rewards": (2.0 * rng.standard_normal((T + 1, B))).astype(
            np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }


def test_vtrace_train_step_folds_the_aux_like_the_reference():
    """An IMPALA/V-trace step of the MoE TransformerNet through
    make_impala_train_step with the aux folded into the loss (the
    experiment's 3-tuple apply), with experiment.py's chain, on both
    sides: the gradients of make_grad_step, then the step's metrics (the
    MoE ones too) and the parameters after it. The reference's step is
    its jitted loss and gradients, then optax's update (what
    make_impala_train_step compiles into one step)."""
    import optax

    b = _batch(0)
    jnet, params, net = _moe_pair(b["obs"], b["done"])

    def japply(p, obs, done, core_state):
        (out, st), inter = jnet.apply(p, obs, done, core_state,
                                      mutable=["intermediates"])
        return out, st, jtransformer.moe_aux_losses(inter)

    def tapply(model, obs, done, core_state):
        return model(obs, done, core_state, return_aux=True)

    tx = optax.chain(optax.clip_by_global_norm(40.0),
                     optax.rmsprop(6e-4, decay=0.99, eps=0.01))
    opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                         max_norm=40.0)
    jcfg = jlearner.ImpalaConfig()
    jb = {**{k: jnp.asarray(v) for k, v in b.items()}, "core_state": ()}
    tb = {**{k: torch.from_numpy(np.array(v)) for k, v in b.items()},
          "core_state": ()}
    (_, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlearner.impala_loss(p, japply, jb, jcfg),
        has_aux=True))(params)
    jm = dict(jm, grad_norm=optax.global_norm(jgrads))
    updates, _ = tx.update(jgrads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    want = transformer_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jgrads))
    grads, _ = tlearner.make_grad_step(tapply)(net, tb)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        _close_rel(g, want[name], 1e-4, f"grad {name}")
    tstate, tm = tlearner.make_impala_train_step(tapply)(
        tlearner.make_train_state(net, opt), tb)
    assert {"moe_lb_loss", "moe_z_loss", "moe_drop_fraction"} <= set(tm)
    assert set(tm) == set(jm)
    for name in jm:
        _close_rel(tm[name], jm[name], 1e-5, name)
    want = transformer_params_from_flax(jax.tree_util.tree_map(
        np.asarray, new_params))
    for name, p in net.state_dict().items():
        _close_rel(p, want[name], 1e-5, name)


# -- moe_ffn_sharded: the explicit all-to-all over ep -----------------------------


def _jax_sharded(params, x, capacity, top_k, ep):
    mesh = make_mesh(dp=1, ep=ep, devices=jax.devices()[:ep])
    specs = {"router": P(), "w_up": P("ep", None, None),
             "w_down": P("ep", None, None)}

    def loss(p, x):
        y, aux = shard_map(
            lambda p, xs: jmoe.moe_ffn_sharded(
                p, xs, capacity=capacity, top_k=top_k, axis_name="ep"),
            mesh=mesh, in_specs=(specs, P("ep", None)),
            out_specs=(P("ep", None), P()))(p, x)
        return jnp.sum(y ** 2) + 0.01 * aux["load_balance_loss"], (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(loss, has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(y), aux, grads


@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_a2a_matches_replicated_and_the_reference(world, top_k):
    """With capacity T_local nothing drops: the replicated moe_ffn's
    output exactly (1e-5 of its max), and the reference's
    moe_ffn_sharded's output, aux and gradients (the dry run's loss)."""
    T, D, H, E, ep = 32, 8, 12, 4, 4
    params = _params(8, D, H, E)
    x = np.random.default_rng(8).standard_normal((T, D)).astype(np.float32)
    ref, _ = jmoe.moe_ffn(params, jnp.asarray(x), capacity=T, top_k=top_k)
    y_ref, aux_ref, g_ref = _jax_sharded(params, x, T // ep, top_k, ep)
    outs = world.run(cases.moe_sharded, params, x, T // ep, top_k)
    y = np.concatenate([o[0] for o in sorted(outs, key=lambda o: o[3])])
    _close_rel(y, ref, 1e-5)
    _close_rel(y, y_ref, 1e-5)
    for y_g, aux, grads, g in outs:
        assert aux["drop_fraction"] == 0.0
        for k in AUX:
            _close_rel(aux[k], aux_ref[k], 1e-5, k)
        _close_rel(grads["router"], g_ref["router"], 1e-4, "router")
        for k in ("w_up", "w_down"):
            _close_rel(grads[k], np.asarray(g_ref[k])[g:g + 1], 1e-4, k)
