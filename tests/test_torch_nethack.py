"""Port parity: moolib_tpu_torch NetHackNet against the flax reference,
and the port's vtrace experiment on the NetHack-shaped env.

Reference parameters are converted with nethack_params_from_flax (flax
starts every bias at 0, so the reference's biases are drawn at random
before converting: a bias in the wrong place would pass otherwise), and
the same numpy observations go through both. Tolerances: f32 outputs and
LSTM states within 1e-5 of the largest entry; bf16 within one bf16
rounding (2^-8 of the largest entry; the trunk computes in bf16 on both
sides); gradients within 1e-4 of each tensor's largest entry, against
the reference run op by op (its jitted CPU convolutions round
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu import learner as jlearner
from moolib_tpu.models import NetHackNet as JaxNetHackNet
from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.examples.vtrace import experiment as port_exp
from moolib_tpu_torch.models import NetHackNet, nethack_params_from_flax

A = 23


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=0, atol=rel * scale, err_msg=err_msg)


def _obs(rng, T, B):
    return {"glyphs": rng.integers(0, 5976, (T, B, 21, 79)).astype(np.int16),
            "blstats": (50.0 * rng.standard_normal((T, B, 27))).astype(
                np.float32)}


def _pair(obs, done, state, compute_dtype=torch.float32, use_lstm=True):
    jdtype = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32
    jnet = JaxNetHackNet(num_actions=A, use_lstm=use_lstm,
                         compute_dtype=jdtype)
    params = jnet.init(jax.random.PRNGKey(0),
                       jax.tree_util.tree_map(jnp.asarray, obs),
                       jnp.asarray(done),
                       tuple(jnp.asarray(s) for s in state))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (0.1 * rng.standard_normal(x.shape)).astype(
            np.float32) if path[-1].key == "bias" else np.asarray(x),
        params)
    net = NetHackNet(A, use_lstm=use_lstm, compute_dtype=compute_dtype,
                     device="cpu")
    net.load_state_dict(nethack_params_from_flax(params))
    return jnet, params, net


def _t(obs):
    return {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_nethack_net_matches_reference_over_two_unrolls(compute_dtype):
    """The LSTM state threads over two unrolls with dones mid-unroll."""
    rng = np.random.default_rng(0)
    T, B = 3, 2
    unrolls = [(_obs(rng, T, B), rng.random((T, B)) < 0.3)
               for _ in range(2)]
    state = tuple(rng.standard_normal((B, 256)).astype(np.float32)
                  for _ in range(2))
    jnet, params, net = _pair(*unrolls[0], state, compute_dtype)
    jstate = tuple(jnp.asarray(s) for s in state)
    tstate = tuple(torch.from_numpy(s) for s in state)
    rel = 1e-5 if compute_dtype == torch.float32 else 2.0 ** -8
    for obs, done in unrolls:
        (l1, b1), jstate = jnet.apply(
            params, jax.tree_util.tree_map(jnp.asarray, obs),
            jnp.asarray(done), jstate)
        with torch.no_grad():
            (l2, b2), tstate = net(_t(obs), torch.from_numpy(done), tstate)
        assert l2.shape == (T, B, A) and b2.shape == (T, B)
        assert l2.dtype == b2.dtype == torch.float32
        _close_rel(l2, l1, rel, "logits")
        _close_rel(b2, b1, rel, "baseline")
        for got, want in zip(tstate, jstate):
            _close_rel(got, want, rel, "state")


def test_nethack_net_without_lstm_and_its_initial_state():
    rng = np.random.default_rng(1)
    obs, done = _obs(rng, 2, 2), np.zeros((2, 2), bool)
    jnet, params, net = _pair(obs, done, (), use_lstm=False)
    (l1, _), s1 = jnet.apply(params, jax.tree_util.tree_map(jnp.asarray, obs),
                             jnp.asarray(done), ())
    with torch.no_grad():
        (l2, _), s2 = net(_t(obs), torch.from_numpy(done), ())
    assert s1 == s2 == ()
    _close_rel(l2, l1, 1e-5)
    assert net.initial_state(3) == ()
    lstm = NetHackNet(A, device="cpu")
    c, h = lstm.initial_state(3)
    assert c.shape == h.shape == (3, 256) and not c.any() and not h.any()


def test_conv_shapes_follow_same_padding(monkeypatch):
    """21x79 -> 11x40 -> 6x20 -> 3x10: flax's "SAME" pads (0, 1) where
    the stride does not divide the input."""
    from moolib_tpu_torch.models import nethack

    net = NetHackNet(A, device="cpu")
    shapes = []
    real = nethack._conv_same

    def recording(x, conv, dtype):
        y = real(x, conv, dtype)
        shapes.append(tuple(y.shape[1:]))
        return y

    monkeypatch.setattr(nethack, "_conv_same", recording)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        net(_t(_obs(rng, 1, 2)), torch.zeros((1, 2), dtype=torch.bool),
            net.initial_state(2))
    assert shapes == [(32, 11, 40), (64, 6, 20), (64, 3, 10)]
    assert net.fc.in_features == 3 * 10 * 64 + 64


def test_glyph_features_flatten_in_hwc_order():
    """The port flattens the last conv's output in (h, w, c) order, as
    flax does on NHWC: with the reference's rows it matches, while the
    same rows read in (c, h, w) order give another function."""
    rng = np.random.default_rng(4)
    obs, done = _obs(rng, 2, 2), np.zeros((2, 2), bool)
    jnet, params, net = _pair(obs, done, (), use_lstm=False)
    (want, _), _ = jnet.apply(params,
                              jax.tree_util.tree_map(jnp.asarray, obs),
                              jnp.asarray(done), ())
    with torch.no_grad():
        (got, _), _ = net(_t(obs), torch.from_numpy(done), ())
        _close_rel(got, want, 1e-5)
        # Read the converted rows as if the features were (c, h, w).
        w = net.fc.weight[:, :1920].reshape(-1, 3, 10, 64)
        net.fc.weight[:, :1920] = w.permute(0, 3, 1, 2).reshape(-1, 1920)
        (other, _), _ = net(_t(obs), torch.from_numpy(done), ())
    assert float((other - got).abs().max()) > 1e-2 * float(got.abs().max())


def test_nethack_gradients_match_reference():
    """IMPALA-loss gradients of every parameter with the LSTM (state at
    frame 0 random, dones mid-unroll), f32, against jax.grad op by op."""
    rng = np.random.default_rng(5)
    T, B = 2, 2
    obs = _obs(rng, T + 1, B)
    done = np.zeros((T + 1, B), bool)
    done[1, 0] = done[2, 1] = True
    state = tuple(rng.standard_normal((B, 256)).astype(np.float32)
                  for _ in range(2))
    batch = {
        "obs": obs, "done": done,
        "rewards": rng.standard_normal((T + 1, B)).astype(np.float32),
        "actions": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.standard_normal((T, B, A)).astype(np.float32),
    }
    jnet, params, net = _pair(obs, done, state)
    jb = {**jax.tree_util.tree_map(jnp.asarray, batch),
          "core_state": tuple(jnp.asarray(s) for s in state)}
    tb = {"obs": _t(obs),
          **{k: torch.from_numpy(np.array(v)) for k, v in batch.items()
             if k != "obs"},
          "core_state": tuple(torch.from_numpy(s) for s in state)}
    cfg = jlearner.ImpalaConfig()
    with jax.disable_jit():
        (_, jm), jgrads = jax.value_and_grad(
            lambda p: jlearner.impala_loss(p, jnet.apply, jb, cfg),
            has_aux=True)(params)
    want = nethack_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    grads, tm = tlearner.make_grad_step()(net, tb)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        _close_rel(g, want[name], 1e-4, name)
    for name in ("total_loss", "pg_loss", "baseline_loss", "entropy"):
        _close_rel(tm[name], jm[name], 1e-5, name)


def test_make_model_builds_the_nethack_net():
    cfg = port_exp.VtraceConfig(env="nethack", num_actions=A, use_lstm=True,
                                compute_dtype="float32")
    net = port_exp._make_model(cfg, "cpu")
    assert isinstance(net, NetHackNet)
    assert net.core is not None and net.num_actions == A
    assert isinstance(port_exp._make_model(
        port_exp.VtraceConfig(env="nethack", model="auto"), "cpu"),
        NetHackNet)


def test_vtrace_nethack_smoke():
    """The reference's test_vtrace_nethack_smoke settings through the
    port's train(): dict observations (glyphs and blstats) through the
    EnvPool, EnvBatchState, both batching stages and stage_batch, the
    NetHackNet LSTM and V-trace."""
    cfg = port_exp.VtraceConfig(
        env="nethack", num_actions=A, use_lstm=True, total_steps=1_500,
        actor_batch_size=4, learn_batch_size=4, virtual_batch_size=4,
        num_actor_processes=2, unroll_length=5, log_interval_steps=500,
        stats_interval=1e9, compute_dtype="float32", seed=0)
    logs = port_exp.train(cfg, log_fn=lambda *a, **k: None, device="cpu")
    assert logs and logs[-1]["updates"] >= 1
    assert np.isfinite(logs[-1]["total_loss"])


def test_a_double_net_runs_in_f64_end_to_end():
    """Cast with .double() and compute_dtype float64, the trunk hands the
    LSTM and the heads f64 (the card check's f64 reference step relies on
    it); the f32 net's outputs stay f32."""
    rng = np.random.default_rng(6)
    obs, done = _t(_obs(rng, 2, 2)), torch.zeros((2, 2), dtype=torch.bool)
    net = NetHackNet(A, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    net64 = NetHackNet(A, device="cpu").double()
    net64.load_state_dict(net.state_dict())
    net64.compute_dtype = torch.float64
    state = net.initial_state(2)
    with torch.no_grad():
        (l32, b32), s32 = net(obs, done, state)
        obs64 = {"glyphs": obs["glyphs"], "blstats": obs["blstats"].double()}
        (l64, b64), s64 = net64(obs64, done,
                                tuple(s.double() for s in state))
    assert l32.dtype == torch.float32 and l64.dtype == torch.float64
    assert s64[0].dtype == torch.float64
    _close_rel(l32, l64.numpy(), 1e-5)
    _close_rel(b32, b64.numpy(), 1e-5)
