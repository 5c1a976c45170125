"""Port parity: the A2C example (moolib_tpu_torch.examples.a2c) against the
reference's.

a2c_loss's loss, metrics and gradients against the reference's on the
same unroll (dones mid-sequence) with converted A2CNet weights (f32: the
metrics within 1e-5, the gradients within 1e-4 of each tensor's largest
entry); one clipped-Adam update of the example's chain against optax's;
a seeded update replayed bit for bit; train() on the CPU, on CartPole
and on the synthetic pixel env. The learning bar is marked slow, as the
reference's is: updates race env steps through the asynchronous
Accumulator, so host load decides it; the card runs it instead.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moolib_tpu import learner as jlearner
from moolib_tpu.examples import a2c as ref_a2c
from moolib_tpu.models import A2CNet as FlaxA2CNet
from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.examples import a2c as port_a2c
from moolib_tpu_torch.models import A2CNet, a2c_params_from_flax
from moolib_tpu_torch.optim import ClippedAdam

A = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*a, **k):
    pass


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=0, atol=rel * scale, err_msg=err_msg)


def _unroll(seed, T=6, B=3, use_lstm=False):
    rng = np.random.default_rng(seed)
    done = np.zeros((T + 1, B), bool)
    done[2, 0] = done[4, 1] = done[5, 2] = True  # episode ends mid-unroll
    b = {
        "obs": rng.standard_normal((T + 1, B, 4)).astype(np.float32),
        "done": done,
        "rewards": rng.standard_normal((T + 1, B)).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }
    state = tuple(rng.standard_normal((B, 16)).astype(np.float32)
                  for _ in range(2)) if use_lstm else ()
    return b, state


def _pair(batch, state, use_lstm):
    jnet = FlaxA2CNet(num_actions=A, hidden_sizes=(16, 16),
                      use_lstm=use_lstm, lstm_size=16)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(batch["obs"]),
                       jnp.asarray(batch["done"]),
                       tuple(jnp.asarray(s) for s in state))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.standard_normal(x.shape)).astype(
            np.float32) if path[-1].key == "bias" else np.asarray(x),
        params)
    net = A2CNet(A, 4, hidden_sizes=(16, 16), use_lstm=use_lstm,
                 lstm_size=16, device="cpu")
    net.load_state_dict(a2c_params_from_flax(params))
    return jnet, params, net


def _batches(b, state):
    jb = {**{k: jnp.asarray(v) for k, v in b.items()},
          "core_state": tuple(jnp.asarray(s) for s in state)}
    tb = {**{k: torch.from_numpy(np.array(v)) for k, v in b.items()},
          "core_state": tuple(torch.from_numpy(s) for s in state)}
    return jb, tb


def _loss_cfg(module):
    return module.ImpalaConfig(discounting=0.99, baseline_cost=0.005,
                               entropy_cost=0.0006, reward_clip=0.0)


@pytest.mark.parametrize("use_lstm", [False, True])
def test_a2c_loss_matches_reference(use_lstm):
    b, state = _unroll(0, use_lstm=use_lstm)
    jnet, params, net = _pair(b, state, use_lstm)
    jb, tb = _batches(b, state)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: ref_a2c.a2c_loss(p, jnet.apply, jb, _loss_cfg(jlearner)),
        has_aux=True)(params)
    grads, tm = tlearner.make_grad_step(
        config=_loss_cfg(tlearner), loss_fn=port_a2c.a2c_loss)(net, tb)
    assert set(tm) == set(jm) | {"grad_norm"}
    for name in jm:
        _close_rel(tm[name], jm[name], 1e-5, name)
    _close_rel(tm["grad_norm"], optax.global_norm(jgrads), 1e-5)
    want = a2c_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        _close_rel(g, want[name], 1e-4, name)


def test_a2c_loss_clips_rewards_like_the_reference():
    b, state = _unroll(1)
    b["rewards"] *= 5.0
    jnet, params, net = _pair(b, state, False)
    jb, tb = _batches(b, state)
    jcfg = jlearner.ImpalaConfig(reward_clip=1.0)
    tcfg = tlearner.ImpalaConfig(reward_clip=1.0)
    _, jm = ref_a2c.a2c_loss(params, jnet.apply, jb, jcfg)
    with torch.no_grad():
        _, tm = port_a2c.a2c_loss(net, tlearner.call_model, tb, tcfg)
    for name in jm:
        _close_rel(tm[name], jm[name], 1e-5, name)


def test_clipped_adam_update_matches_the_examples_optax_chain():
    """One update of a2c.py's chain (clip_by_global_norm(40), then adam
    with eps=3e-7) from converted weights on the same gradients."""
    b, state = _unroll(2)
    jnet, params, net = _pair(b, state, False)
    jb, tb = _batches(b, state)
    cfg = ref_a2c.A2CConfig()
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adam(cfg.learning_rate, eps=cfg.adam_eps))
    jgrads = jax.grad(lambda p: ref_a2c.a2c_loss(
        p, jnet.apply, jb, _loss_cfg(jlearner))[0])(params)
    jgrads = jax.tree_util.tree_map(lambda g: 400.0 * g, jgrads)  # clipped
    assert float(optax.global_norm(jgrads)) > cfg.grad_clip
    updates, opt_state = tx.update(jgrads, tx.init(params), params)
    jparams = optax.apply_updates(params, updates)
    opt = ClippedAdam(net.parameters(), cfg.learning_rate, eps=cfg.adam_eps,
                      max_norm=cfg.grad_clip)
    grads = a2c_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    state = tlearner.make_apply_step()(tlearner.make_train_state(net, opt),
                                       grads)
    assert state.step == 1
    want = a2c_params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in net.state_dict().items():
        _close_rel(p, want[name], 1e-6, name)
    mu = a2c_params_from_flax(jax.tree_util.tree_map(
        np.asarray, opt_state[1][0].mu))
    for name, p in net.named_parameters():
        _close_rel(opt.state[p]["mu"], mu[name], 1e-6, f"mu {name}")


def test_seeded_a2c_update_bitwise_replay():
    """One A2C update (grad step with a2c_loss, clipped-Adam apply) from a
    fixed seeded state, run twice: bit-identical parameters, optimizer
    state and metrics, and the update moved the parameters."""
    gen = torch.Generator().manual_seed(0)
    net0 = A2CNet(3, 5, hidden_sizes=(32,), device="cpu", generator=gen)
    rng = np.random.default_rng(1)
    T, B = 4, 4
    batch = {
        "obs": torch.from_numpy(rng.standard_normal(
            (T + 1, B, 5)).astype(np.float32)),
        "done": torch.from_numpy(rng.random((T + 1, B)) < 0.1),
        "rewards": torch.from_numpy(rng.standard_normal(
            (T + 1, B)).astype(np.float32)),
        "actions": torch.from_numpy(rng.integers(0, 3, (T, B))),
        "behavior_logits": torch.zeros((T, B, 3)),
        "core_state": (),
    }
    grad_step = tlearner.make_grad_step(config=_loss_cfg(tlearner),
                                        loss_fn=port_a2c.a2c_loss,
                                        grad_scale=float(B))
    apply_step = tlearner.make_apply_step()
    runs = []
    for _ in range(2):
        net = copy.deepcopy(net0)
        opt = ClippedAdam(net.parameters(), 1e-3, eps=3e-7, max_norm=40.0)
        state = tlearner.make_train_state(net, opt)
        grads, metrics = grad_step(net, batch)
        state = apply_step(state, {k: g / B for k, g in grads.items()})
        runs.append((
            {k: v.clone() for k, v in net.state_dict().items()},
            {n: {k: v.clone() for k, v in opt.state[p].items()}
             for n, p in net.named_parameters()},
            metrics))
    (p1, o1, m1), (p2, o2, m2) = runs
    assert np.isfinite(float(m1["total_loss"]))
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        for s in o1[k]:
            assert torch.equal(o1[k][s], o2[k][s]), (k, s)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert any(not torch.equal(p1[k], v)
               for k, v in net0.state_dict().items())


def test_a2c_config_mirrors_the_reference():
    ref = ref_a2c.A2CConfig()
    port = port_a2c.A2CConfig()
    ref_fields = {k: v for k, v in vars(ref).items()}
    assert vars(port) == ref_fields
    # Both derive a config from a FleetSpec (its fields are held against
    # the reference's in test_torch_fleet.py).
    assert callable(port_a2c.A2CConfig.from_fleet_spec)
    assert callable(ref_a2c.A2CConfig.from_fleet_spec)


def test_train_refuses_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_a2c.train(port_a2c.A2CConfig(total_steps=8), log_fn=_quiet)


def test_a2c_cartpole_train_runs():
    """A few thousand CartPole steps through the port's train(): rows
    with the reference's keys, updates, finite losses."""
    cfg = port_a2c.A2CConfig(seed=0, total_steps=3_000,
                             log_interval_steps=1_000)
    logs = port_a2c.train(cfg, log_fn=_quiet, device="cpu")
    assert len(logs) == 3
    assert set(logs[-1]) == {
        "env_steps", "updates", "skips", "dropped_unrolls",
        "mean_episode_return", "total_loss", "entropy", "model_version"}
    assert logs[-1]["updates"] > 0
    assert all(np.isfinite(r["total_loss"]) for r in logs if r["updates"])
    assert logs[-1]["model_version"] == logs[-1]["updates"]


def test_bench_a2c_scores_the_printed_rows_as_the_rows(tmp_path):
    """bench_a2c_torch.py's --score reads the rows the port's train()
    prints (and the reference's, whose format string is the same) into
    the bar's reading that the rows themselves give."""
    import bench_a2c_torch as bench

    lines = []
    cfg = port_a2c.A2CConfig(seed=0, total_steps=2_000,
                             log_interval_steps=500)
    logs = port_a2c.train(cfg, log_fn=lines.append, device="cpu")
    log = tmp_path / "port.log"
    log.write_text("\n".join(["some other output"] + lines) + "\n")
    got = bench.score_log(str(log))
    assert got.pop("log") == str(log)
    want = bench.score(logs)
    # The printed rows carry 2 decimals of the return, 3 of the entropy
    # (nan in a window without an update).
    np.testing.assert_array_equal(got.pop("entropy"),
                                  [round(r["entropy"], 3) for r in logs])
    want.pop("entropy")
    assert got == {**want, "tail": [round(r["mean_episode_return"], 2)
                                     for r in logs]}
    ref_rows = [dict(env_steps=4_000 * (i + 1), mean_episode_return=r,
                     total_loss=0.5, entropy=e, updates=12.0 * (i + 1))
                for i, (r, e) in enumerate(zip(
                    np.linspace(20.0, 140.0, 20), np.linspace(0.68, 0.4, 20)))]
    log.write_text("".join(
        "steps {env_steps:>8}  return {mean_episode_return:7.2f}  "
        "loss {total_loss:8.4f}  entropy {entropy:6.3f}  "
        "updates {updates:g}\n".format(**r) for r in ref_rows))
    got = bench.score_log(str(log))
    assert (got["hits"], got["windows"], got["met"], got["entropy_ok"],
            got["updates"]) == (7, 20, False, True, 240.0)


def test_a2c_pixel_smoke():
    """A2C with the ResNet torso on Atari-shaped pixels (the reference's
    test_a2c_pixel_smoke settings); the rows land in the registry."""
    from moolib_tpu_torch.models import ImpalaNet
    from moolib_tpu_torch.telemetry import global_telemetry

    cfg = port_a2c.A2CConfig(env="synthetic", num_actions=6, total_steps=600,
                             unroll_length=5, batch_size=2, num_processes=2,
                             log_interval_steps=300, seed=0)
    net = port_a2c._make_model(cfg, torch.device("cpu"),
                               torch.Generator().manual_seed(0))
    assert isinstance(net, ImpalaNet) and net.compute_dtype == torch.float32
    logs = port_a2c.train(cfg, log_fn=_quiet, device="cpu")
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])
    reg = global_telemetry().registry
    assert reg.value("train_total_loss", example="a2c") == pytest.approx(
        logs[-1]["total_loss"])
    assert reg.value("train_updates", example="a2c") == logs[-1]["updates"]


@pytest.mark.integration
@pytest.mark.slow  # the reference's own mark: the learning bar is paced
# by wall clock (updates race env steps through the asynchronous
# Accumulator), so host load decides it; the card's smoke runs it.
def test_a2c_cartpole_learns():
    cfg = port_a2c.A2CConfig(seed=0, total_steps=60_000,
                             log_interval_steps=2_000)
    logs = port_a2c.train(cfg, log_fn=_quiet, device="cpu")
    assert len(logs) >= 20
    tail = [r["mean_episode_return"] for r in logs[-10:]]
    assert sum(r > 100 for r in tail) >= 5, f"tail returns {tail}"
    entropies = [r["entropy"] for r in logs[-10:]]
    assert all(0.05 < e < 0.69 for e in entropies), entropies
    assert logs[-1]["updates"] > 100
