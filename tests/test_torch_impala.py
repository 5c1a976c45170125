"""Port parity: moolib_tpu_torch's ImpalaNet, LSTMCore, space_to_depth and
widen_impala_params against moolib_tpu.models.

The reference's parameters are converted with impala_params_from_flax
and the same seeded numpy inputs go through both: uint8 frames
[T+1=3, B=2, 84, 84, 4] with resets in the middle of the unroll, and a
random LSTM state. flax initialises every bias at zero, which would hide
a bias on the wrong side of the LSTM or a missing conv bias, so the
reference's biases are drawn at random before the conversion.

Tolerances:
- f32: logits and baseline 1e-4 of their largest entry (measured on the
  CPU: up to 9.3e-7), the LSTM state 1e-5 absolute (measured 1.1e-6);
- bf16 compute dtype: 2e-2 of the largest entry, for the state too.
  Both sides round every conv's and the dense layer's product, and then
  its bias add, to bf16, but accumulate the products in other orders, so
  now and then a rounding falls the other way (a change of 2**-8
  relative) and the flips carry through the 16 layers. Measured on the
  CPU at these inputs: 8.1e-3 (baseline), 2.2e-3 (logits) without the
  LSTM, 3.0e-3 with it, 2.7e-3 on the state; with the bias add fused
  into one rounding the logits differ by 6.7e-3, three times as much.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from moolib_tpu.models import ImpalaNet as JaxImpalaNet
from moolib_tpu.models import space_to_depth as jax_space_to_depth
from moolib_tpu.models import widen_impala_params as jax_widen
from moolib_tpu_torch.models import (
    ImpalaNet,
    LSTMCore,
    impala_params_from_flax,
    space_to_depth,
    widen_impala_params,
)
from moolib_tpu_torch.models.impala import _max_pool_same

T1, B, A = 3, 2, 6
BF16_TOL = 2e-2


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (T1, B, 84, 84, 4), dtype=np.uint8)
    done = np.array([[False, False], [True, False], [False, True]])
    state = tuple(rng.standard_normal((B, 256)).astype(np.float32)
                  for _ in range(2))
    return obs, done, state


def _random_biases(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _convert(tree):
    return impala_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def _reference(use_lstm, bf16, **kw):
    """(params with random biases, reference outputs) for the inputs."""
    obs, done, state = _inputs()
    jnet = JaxImpalaNet(num_actions=A, use_lstm=use_lstm,
                        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32,
                        **kw)
    st = tuple(jnp.asarray(s) for s in state) if use_lstm else ()
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs),
                       jnp.asarray(done), st)
    params = _random_biases(params, 1)
    out = jax.jit(jnet.apply)(params, jnp.asarray(obs), jnp.asarray(done),
                              st)
    return params, jax.tree_util.tree_map(np.asarray, out)


def _port(params, use_lstm, dtype=torch.float32, **kw):
    net = ImpalaNet(A, use_lstm=use_lstm, compute_dtype=dtype, device="cpu",
                    **kw)
    net.load_state_dict(_convert(params))
    return net


def _run(net, use_lstm):
    obs, done, state = _inputs()
    st = tuple(torch.from_numpy(s) for s in state) if use_lstm else ()
    with torch.no_grad():
        return net(torch.from_numpy(obs), torch.from_numpy(done), st)


def _close_rel(got, want, rel, err_msg=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * scale, err_msg=err_msg)


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_net_matches_reference_f32(use_lstm):
    params, ((jl, jb), jst) = _reference(use_lstm, False)
    (logits, baseline), st = _run(_port(params, use_lstm), use_lstm)
    assert logits.shape == (T1, B, A) and baseline.shape == (T1, B)
    _close_rel(logits, jl, 1e-4, "logits")
    _close_rel(baseline, jb, 1e-4, "baseline")
    if use_lstm:
        assert len(st) == 2
        for name, got, want in zip("ch", st, jst):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                       err_msg=name)
    else:
        assert st == () and jst == ()


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_net_matches_reference_bf16(use_lstm):
    params, ((jl, jb), jst) = _reference(use_lstm, True)
    net = _port(params, use_lstm, torch.bfloat16)
    (logits, baseline), st = _run(net, use_lstm)
    # The heads and the LSTM run in f32, as the reference's do.
    assert logits.dtype == baseline.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    _close_rel(logits, jl, BF16_TOL, "logits")
    _close_rel(baseline, jb, BF16_TOL, "baseline")
    for name, got, want in zip("ch", st, jst):
        _close_rel(got, want, BF16_TOL, name)


def test_space_to_depth_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 6, 5)).astype(
        np.float32)
    for s in (1, 2):
        np.testing.assert_array_equal(
            space_to_depth(torch.from_numpy(x), s).numpy(),
            np.asarray(jax_space_to_depth(jnp.asarray(x), s)))
    with pytest.raises(ValueError, match="divisible"):
        space_to_depth(torch.zeros(1, 5, 4, 1), 2)


def test_space_to_depth_variant_matches_reference():
    params, ((jl, jb), _) = _reference(False, False, space_to_depth_factor=2)
    net = _port(params, False, space_to_depth_factor=2)
    assert net.sequences[0].conv.weight.shape[1] == 16  # 4 channels x 2 x 2
    (logits, baseline), _ = _run(net, False)
    _close_rel(logits, jl, 1e-4, "logits")
    _close_rel(baseline, jb, 1e-4, "baseline")


def test_widen_matches_reference_and_computes_the_baseline():
    """The port's zero-extension of a converted state_dict equals the
    conversion of the reference's widened tree, and the widened port
    model computes the baseline port model (1e-5, the reference's own
    test's tolerance: the padded contractions sum zeros in other
    orders)."""
    params, _ = _reference(False, False)
    base = _port(params, False)
    wide_sd = widen_impala_params(base.state_dict(), 64)
    want = _convert(jax_widen(params, channel_pad_to=64))
    assert set(wide_sd) == set(want)
    for name, t in wide_sd.items():
        assert torch.equal(t, want[name]), name
    wide = ImpalaNet(A, channel_pad_to=64, device="cpu")
    wide.load_state_dict(wide_sd)
    assert wide.sequences[1].conv.weight.shape == (64, 64, 3, 3)
    (lb, bb), _ = _run(base, False)
    (lw, bw), _ = _run(wide, False)
    np.testing.assert_allclose(lw.numpy(), lb.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bw.numpy(), bb.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [84, 42, 21])
def test_max_pool_same_padding_matches_reference(size):
    """flax pads (0, 1) at 84 and 42 and (1, 1) at 21; max_pool2d's own
    padding=1 pads (1, 1) and picks other windows."""
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = _max_pool_same(nchw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    naive = F.max_pool2d(nchw, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert naive.shape == want.shape
    assert np.array_equal(naive, want) == (size == 21)


def test_lstm_core_reset_everywhere_gives_zero_state_outputs():
    """done at every position: each step starts from the zero state, so
    step t's output is that of a one-step unroll of x[t] from zeros."""
    gen = torch.Generator().manual_seed(0)
    core = LSTMCore(8, 16, device="cpu", generator=gen)
    with torch.no_grad():
        core.bias_hh.normal_(generator=gen)
    x = torch.randn((5, 3, 8), generator=gen)
    state = tuple(torch.randn((3, 16), generator=gen) for _ in range(2))
    with torch.no_grad():
        out, (c, h) = core(x, torch.ones((5, 3), dtype=torch.bool), state)
        no_reset = torch.zeros((1, 3), dtype=torch.bool)
        for t in range(5):
            want, (c1, h1) = core(x[t:t + 1], no_reset, core.initial_state(3))
            torch.testing.assert_close(out[t], want[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(h, out[-1], rtol=0, atol=0)
        torch.testing.assert_close((c, h), (c1, h1), rtol=0, atol=1e-6)


def test_initial_state():
    lstm = ImpalaNet(A, use_lstm=True, lstm_size=32, hidden_size=16,
                     device="cpu")
    c, h = lstm.initial_state(4)
    for z in (c, h):
        assert z.shape == (4, 32) and z.dtype == torch.float32
        assert z.device.type == "cpu" and not z.any()
    assert ImpalaNet(A, device="cpu").initial_state(4) == ()
