"""Port parity: moolib_tpu_torch TransformerNet against the flax reference.

Reference parameters are converted with transformer_params_from_flax and
the same numpy observations go through both. The reference runs its
Pallas flash kernel in interpret mode; the port runs its flash backend,
which is the plain PyTorch flash forward on CPU tensors. Tolerances:
1e-4 in f32; 1e-3 with compute_dtype=bfloat16, where both round the
scaled pixels (or vectors) and the positional embedding to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu.models import TransformerNet as JaxTransformerNet
from moolib_tpu_torch.models import (
    TransformerNet,
    segment_ids_from_done,
    transformer_params_from_flax,
)
from moolib_tpu_torch.models.transformer import same_pads

SMALL = dict(d_model=32, num_layers=2, num_heads=2)


def _obs(rng, pixels, T, B):
    if pixels:
        return rng.integers(0, 256, (T, B, 84, 84, 4), dtype=np.uint8)
    return rng.standard_normal((T, B, 5)).astype(np.float32)


def _pair(obs, done, compute_dtype, backend="flash"):
    """(reference net, its params, port net with converted weights)."""
    jdtype = jnp.bfloat16 if compute_dtype == torch.bfloat16 else jnp.float32
    jnet = JaxTransformerNet(num_actions=6, attention_backend="flash",
                             compute_dtype=jdtype, **SMALL)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(obs),
                       jnp.asarray(done), ())
    net = TransformerNet(6, obs.shape[2:], attention_backend=backend,
                         compute_dtype=compute_dtype, device="cpu", **SMALL)
    net.load_state_dict(transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net


@pytest.mark.parametrize("pixels", [True, False])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_transformer_matches_reference(pixels, compute_dtype):
    rng = np.random.default_rng(0)
    T, B = (8, 2) if pixels else (16, 2)
    obs = _obs(rng, pixels, T, B)
    done = rng.random((T, B)) < 0.2
    jnet, params, net = _pair(obs, done, compute_dtype)
    (l1, b1), s1 = jnet.apply(params, jnp.asarray(obs), jnp.asarray(done), ())
    with torch.no_grad():
        (l2, b2), s2 = net(torch.from_numpy(obs), torch.from_numpy(done), ())
    assert l2.shape == (T, B, 6) and b2.shape == (T, B)
    assert s1 == s2 == ()
    atol = 1e-4 if compute_dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(np.asarray(l1), l2.numpy(), atol=atol)
    np.testing.assert_allclose(np.asarray(b1), b2.numpy(), atol=atol)


def test_transformer_backends_agree():
    rng = np.random.default_rng(1)
    obs = torch.from_numpy(_obs(rng, False, 12, 3))
    done = torch.from_numpy(rng.random((12, 3)) < 0.15)
    gen = torch.Generator().manual_seed(0)
    ref = TransformerNet(4, (5,), attention_backend="dense", device="cpu",
                         generator=gen, **SMALL)
    outs = []
    for backend in ("dense", "blockwise", "flash", "auto"):
        net = TransformerNet(4, (5,), attention_backend=backend,
                             device="cpu", **SMALL)
        net.load_state_dict(ref.state_dict())
        with torch.no_grad():
            outs.append(net(obs, done, ())[0])
    for logits, baseline in outs[1:]:
        torch.testing.assert_close(logits, outs[0][0], atol=2e-5, rtol=0)
        torch.testing.assert_close(baseline, outs[0][1], atol=2e-5, rtol=0)


def test_transformer_respects_episode_boundaries():
    """A query after a reset must not see pre-reset frames: changing frames
    before the reset must not change post-reset outputs."""
    rng = np.random.default_rng(2)
    T, B = 12, 3
    obs = torch.from_numpy(_obs(rng, False, T, B))
    done = torch.zeros((T, B), dtype=torch.bool)
    done[6, 0] = True
    net = TransformerNet(4, (5,), attention_backend="flash", device="cpu",
                         generator=torch.Generator().manual_seed(0), **SMALL)
    obs2 = obs.clone()
    obs2[:6, 0] += 10.0  # pre-reset frames of lane 0
    with torch.no_grad():
        (l1, _), _ = net(obs, done, ())
        (l2, _), _ = net(obs2, done, ())
    torch.testing.assert_close(l1[6:, 0], l2[6:, 0], atol=1e-5, rtol=0)
    # sanity: pre-reset outputs DID change
    assert float((l1[:6, 0] - l2[:6, 0]).abs().max()) > 1e-3


def test_segment_ids_and_same_padding_match_reference():
    from moolib_tpu.models.transformer import (
        segment_ids_from_done as jax_segment_ids,
    )

    done = np.random.default_rng(3).random((10, 4)) < 0.3
    np.testing.assert_array_equal(
        np.asarray(jax_segment_ids(jnp.asarray(done))),
        segment_ids_from_done(torch.from_numpy(done)).numpy(),
    )
    # The pixel torso's "SAME" pads, as lax.padtype_to_pads gives them.
    for size, window, stride in [(84, 8, 4), (21, 4, 2)]:
        (pads,) = jax.lax.padtype_to_pads((size,), (window,), (stride,),
                                          "SAME")
        assert same_pads(size, window, stride) == tuple(pads)
    assert same_pads(21, 4, 2) == (1, 2)


def test_conv_torso_runs_without_tf32():
    """The torso's convolutions run with cuDNN's TF32 off (full f32, as
    the reference computes them) and the caller's setting comes back."""
    net = TransformerNet(4, (84, 84, 4), device="cpu",
                         generator=torch.Generator().manual_seed(0), **SMALL)
    seen = []
    for conv in (net.conv0, net.conv1):
        conv.register_forward_pre_hook(
            lambda mod, args: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        obs = torch.zeros((2, 1, 84, 84, 4), dtype=torch.uint8)
        with torch.no_grad():
            net(obs, torch.zeros((2, 1), dtype=torch.bool), ())
        assert seen == [False, False]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_moe_and_ring_are_not_ported_yet():
    """MoE blocks are ported (tests/test_torch_moe.py); ring attention
    still raises, naming its roadmap item, and an unknown MLP is
    refused."""
    net = TransformerNet(4, (5,), mlp="moe", device="cpu", **SMALL)
    assert all(hasattr(b, "moe") for b in net.blocks)
    with pytest.raises(ValueError, match="mlp"):
        TransformerNet(4, (5,), mlp="sparse", device="cpu", **SMALL)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerNet(4, (5,), attention_backend="ring", device="cpu",
                       **SMALL)
