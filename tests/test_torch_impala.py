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
import re

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
from moolib_tpu_torch.models.common import same_pads
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


@pytest.mark.parametrize("size", [84, 42, 21, 11])
def test_max_pool_same_padding_matches_reference(size):
    """flax pads (0, 1) at 84 and 42 and (1, 1) at 21 and 11; max_pool2d's
    own padding=1 pads (1, 1) and picks other windows at even sizes."""
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = _max_pool_same(nchw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    naive = F.max_pool2d(nchw, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert naive.shape == want.shape
    assert np.array_equal(naive, want) == (size % 2 == 1)


@pytest.mark.parametrize("size", [84, 42, 21, 11])
def test_max_pool_same_gradient_matches_reference(size):
    """The plain pool's backward against flax's (under disable_jit: the
    jitted CPU gradients differ where windows nearly tie), on inputs with
    no tie at all (a permutation) and integer cotangents, so that every
    sum is exact and the two agree bit for bit."""
    rng = np.random.default_rng(size)
    x = rng.permutation(2 * size * size * 3).reshape(2, size, size, 3)
    x = (x / 7.0).astype(np.float32)
    ho = -(-size // 2)
    ct = rng.integers(-8, 9, (2, ho, ho, 3)).astype(np.float32)

    def pool(v):
        return fnn.max_pool(v, (3, 3), strides=(2, 2), padding="SAME")

    with jax.disable_jit():
        _, vjp = jax.vjp(pool, jnp.asarray(x))
        (want,) = vjp(jnp.asarray(ct))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    _max_pool_same(nchw).backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(nchw.grad.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def _pool_by_rule(x, cotangent):
    """The pool's rule written out, one window at a time, on a [H, W]
    array padded as flax's "SAME" pads: walk the 3x3 window in row-major
    order from its first position with the running max at -inf; an
    element takes the window when it is above the max or NaN; the
    window's gradient goes to the position that took it last (dropped
    when that is a pad). Returns (output, the input's gradient)."""
    H, W = x.shape
    (pt, pb), (pl, pr) = same_pads(H, 3, 2), same_pads(W, 3, 2)
    padded = np.pad(x, ((pt, pb), (pl, pr)), constant_values=-np.inf)
    Ho, Wo = (H + pt + pb - 3) // 2 + 1, (W + pl + pr - 3) // 2 + 1
    out = np.empty((Ho, Wo), x.dtype)
    grad = np.zeros((H + pt + pb, W + pl + pr), np.float64)
    for oh in range(Ho):
        for ow in range(Wo):
            best, at = -np.inf, (2 * oh, 2 * ow)
            for dy in range(3):
                for dx in range(3):
                    v = padded[2 * oh + dy, 2 * ow + dx]
                    if v > best or np.isnan(v):
                        best, at = v, (2 * oh + dy, 2 * ow + dx)
            out[oh, ow] = best
            grad[at] += cotangent[oh, ow]
    return out, grad[pt:pt + H, pl:pl + W]


def _rule_cases():
    rng = np.random.default_rng(3)
    ties = rng.integers(0, 3, (9, 8)).astype(np.float32)
    nan = rng.standard_normal((7, 7)).astype(np.float32)
    nan[rng.random(nan.shape) < 0.2] = np.nan
    nan[0, 0] = nan[1, 0] = np.nan  # two NaNs in one window: the later wins
    low = np.full((7, 6), -np.inf, np.float32)  # every window holds only -inf
    low[4, 3] = 1.0
    return {"ties": ties, "nan": nan, "-inf": low,
            "zeros": np.array([[-0.0, 0.0, 0.0], [0.0, -0.0, 0.0]],
                              np.float32)}


@pytest.mark.parametrize("case", ["ties", "nan", "-inf", "zeros"])
def test_max_pool_same_plain_keeps_the_rule_the_kernels_keep(case):
    """Ties go to the first maximum in row-major order (-0.0 and 0.0 tie),
    a NaN wins (the last one of its window), and a window of -inf keeps
    its first position, whose gradient is dropped where it is a pad: the
    plain version against the rule written out, values and gradients."""
    x = _rule_cases()[case]
    H, W = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    ct = (np.arange(Ho * Wo).reshape(Ho, Wo) + 1).astype(np.float32)
    want, want_grad = _pool_by_rule(x, ct)
    nchw = torch.from_numpy(x)[None, None].requires_grad_()
    got = _max_pool_same(nchw)
    got.backward(torch.from_numpy(ct)[None, None])
    np.testing.assert_array_equal(got.detach()[0, 0].numpy(), want)
    np.testing.assert_array_equal(np.signbit(got.detach()[0, 0].numpy()),
                                  np.signbit(want))
    np.testing.assert_array_equal(nchw.grad[0, 0].numpy(),
                                  want_grad.astype(np.float32))


def test_max_pool_same_takes_the_plain_version_for_a_cpu_tensor(monkeypatch):
    """A CPU tensor of any dtype takes the plain version and launches no
    kernel; a device with no kernel raises, as do the kernels' wrappers
    for a dtype or a device they do not take, before any build."""
    from moolib_tpu_torch.models import impala
    from moolib_tpu_torch.ops import _kernels

    def refuse(*args):
        raise AssertionError("a kernel wrapper was called for a CPU tensor")

    monkeypatch.setattr(_kernels, "max_pool_same_fwd", refuse)
    monkeypatch.setattr(_kernels, "max_pool_same_bwd", refuse)
    builds = _kernels.build_count()
    x = torch.randn((2, 5, 9, 9), generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        xd = x.detach().to(dtype).requires_grad_()
        y = impala._max_pool_same(xd)
        want = impala._max_pool_same_plain(xd.detach())
        assert torch.equal(y.detach(), want) and y.dtype == dtype
        y.sum().backward()
        assert xd.grad.shape == xd.shape
    with pytest.raises(ValueError, match="no kernel for meta"):
        impala._max_pool_same(torch.empty((1, 1, 4, 4), device="meta"))
    monkeypatch.undo()
    pads = ((0, 1), (0, 1))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _kernels.max_pool_same_fwd(x.half(), *pads)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _kernels.max_pool_same_bwd(x.double(), x.double(), *pads)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.max_pool_same_fwd(x, *pads)
    with pytest.raises(ValueError, match=r"\[N,C,H,W\]"):
        _kernels.max_pool_same_fwd(x[0], *pads)
    assert _kernels.build_count() == builds


def test_max_pool_kernels_are_registered_and_importing_builds_nothing():
    """The pool's library and its two kernels are in LIBRARIES and
    KERNELS (so build_all, the launch counts and the compile count see
    them), named so that a device trace classes them as the max-pool,
    and importing the kernels' module in a fresh interpreter builds no
    library."""
    import subprocess
    import sys

    from moolib_tpu_torch.ops import _kernels

    lib = _kernels.MAX_POOL_FWD.library
    assert lib is _kernels.MAX_POOL_BWD.library and lib in _kernels.LIBRARIES
    assert lib.source.name == "max_pool.cu" and lib.source.exists()
    assert {_kernels.MAX_POOL_FWD, _kernels.MAX_POOL_BWD} <= set(
        _kernels.KERNELS)
    kernel_names = re.findall(r"__global__ void __launch_bounds__\([^)]*\)"
                              r"\s+(\w+)\(", lib.source.read_text())
    assert kernel_names == ["max_pool_same_fwd_kernel",
                            "max_pool_same_bwd_kernel"]
    for name in kernel_names:
        assert not re.search(r"conv|fprop|wgrad|dgrad|gemm|cutlass|flash_|"
                             r"fft|cf32", name)
    probe = ("import moolib_tpu_torch.models.impala\n"
             "from moolib_tpu_torch.ops import _kernels\n"
             "print(_kernels.build_count(), "
             "[lib.builds for lib in _kernels.LIBRARIES])")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["0", "[0,", "0,", "0]"]


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
