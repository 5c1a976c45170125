"""Port parity of the flash backward: moolib_tpu_torch against
moolib_tpu.ops.attention.

The same numpy inputs go through the JAX reference (its Pallas backward
kernels in interpret mode) and the port's plain PyTorch backward, which
the autograd Function runs for CPU tensors; the CUDA kernels are held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerance 1e-4 in f32: the two sum the same products in
different orders over rows of up to 32 keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu.ops import attention as jattn
from moolib_tpu_torch.ops import _kernels
from moolib_tpu_torch.ops import attention as tattn

ATOL = 1e-4


def _inputs(seed, B=2, H=3, T=32, D=16, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = Tk or T
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, T, D)).astype(np.float32)
    seg_q = np.cumsum(rng.random((B, T)) < 0.1, axis=1).astype(np.int32)
    seg_k = np.cumsum(rng.random((B, Tk)) < 0.1, axis=1).astype(np.int32)
    return q, k, v, do, seg_q, seg_k


def _jax_backward(q, k, v, seg_q, seg_k, do, causal, block):
    """The reference's forward and its Pallas backward (interpret)."""
    args = [jnp.asarray(x) for x in (q, k, v, seg_q, seg_k)]
    o, lse = jattn._flash_forward(*args, causal, block, block, True)
    grads = jattn._flash_backward(*args, o, lse, jnp.asarray(do), causal,
                                  block, block, True)
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _port_backward(q, k, v, seg_q, seg_k, o, lse, do, causal):
    t = [torch.from_numpy(np.array(x)) for x in (q, k, v, seg_q, seg_k, o,
                                                  lse, do)]
    grads = tattn._flash_backward_plain(*t, causal)
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_segs", [False, True])
def test_flash_backward_plain_matches_jax_kernels(causal, with_segs):
    q, k, v, do, seg, _ = _inputs(0)
    if not with_segs:
        seg = np.zeros_like(seg)
    o, lse, want = _jax_backward(q, k, v, seg, seg, do, causal, 16)
    got = _port_backward(q, k, v, seg, seg, o, lse, do, causal)
    for name, g1, g2 in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g2, g1, atol=ATOL, err_msg=name)


def test_flash_backward_plain_fully_masked_rows():
    """kv segments that some queries share with no key: those rows have
    lse = +inf, get dq = 0 exactly and add nothing to dk/dv in both (dense
    attention would give them a uniform average and a gradient)."""
    q, k, v, do, _, _ = _inputs(1, Tk=48)
    seg_q = np.zeros((2, 32), np.int32)
    seg_q[:, 20:] = 1  # no key carries segment 1
    seg_k = np.zeros((2, 48), np.int32)
    seg_k[1, 5:] = 2
    o, lse, want = _jax_backward(q, k, v, seg_q, seg_k, do, False, 16)
    masked = np.isinf(lse[:, 0]).reshape(2, 3, 32)
    assert masked.any() and (~masked).any()
    got = _port_backward(q, k, v, seg_q, seg_k, o, lse, do, False)
    assert np.all(got[0][masked] == 0.0)
    for name, g1, g2 in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g2, g1, atol=ATOL, err_msg=name)
    # Only keys of segment 0 in lane 1 (and all keys in lane 0) are seen.
    assert np.all(got[1][1, :, 5:] == 0.0) and np.all(got[2][1, :, 5:] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_matches_jax_grad(causal):
    """torch.autograd.grad through the Function against jax.grad through
    the reference's custom_vjp, with kv segments of their own."""
    q, k, v, do, seg_q, seg_k = _inputs(2, T=32, Tk=32)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal,
                                  segment_ids=jnp.asarray(seg_q),
                                  kv_segment_ids=jnp.asarray(seg_k),
                                  block_q=16, block_k=16, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv, causal=causal,
                              segment_ids=torch.from_numpy(seg_q),
                              kv_segment_ids=torch.from_numpy(seg_k),
                              block_q=16, block_k=16)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, g1, g2 in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g2.numpy(), np.asarray(g1), atol=ATOL,
                                   err_msg=name)


def test_flash_attention_gradcheck_f64():
    """Finite differences in f64 through the Function on a tiny causal
    segmented case (the plain versions compute in f64 for f64 inputs)."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 6, 4), generator=gen, dtype=torch.float64)
               .requires_grad_() for _ in range(3))
    seg = torch.tensor([[0, 0, 1, 1, 1, 2]], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tattn.flash_attention(q, k, v, causal=True,
                                              segment_ids=seg),
        (q, k, v),
    )


def test_flash_attention_grad_of_permuted_views_and_dtypes():
    """The model hands the Function permuted views and receives a
    permuted dO; gradients must equal those of contiguous inputs. bf16
    inputs get bf16 gradients."""
    gen = torch.Generator().manual_seed(1)
    T, B, H, D = 12, 2, 2, 8
    x = torch.randn((T, B, 3 * H * D), generator=gen)
    seg = torch.zeros((B, T), dtype=torch.int32)
    seg[1, 7:] = 1

    def run(x, contiguous):
        q, k, v = x.chunk(3, dim=-1)
        heads = [t.reshape(T, B, H, D).permute(1, 2, 0, 3) for t in (q, k, v)]
        if contiguous:
            heads = [t.contiguous() for t in heads]
        o = tattn.flash_attention(*heads, causal=True, segment_ids=seg)
        return o.permute(2, 0, 1, 3).reshape(T, B, H * D)

    w = torch.randn((T, B, H * D), generator=gen)
    grads = []
    for contiguous in (False, True):
        xi = x.clone().requires_grad_()
        (g,) = torch.autograd.grad((run(xi, contiguous) * w).sum(), xi)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)

    xb = x.to(torch.bfloat16).requires_grad_()
    (gb,) = torch.autograd.grad((run(xb, False).float() * w).sum(), xb)
    assert gb.dtype == torch.bfloat16
    torch.testing.assert_close(gb.float(), grads[0], atol=0.1, rtol=0.05)


def _layout_segments(layout, rng, B, T):
    """(seg_q, seg_k) int32 [B, T]: the model's cumsum of resets, ids that
    go back and forth (no tile may be skipped), or kv ids that rows 200+
    share with no key."""
    t = np.arange(T)
    if layout == "monotone":
        seg_q = np.cumsum(rng.random((B, T)) < 0.02, axis=1)
        seg_k = seg_q
    elif layout == "non-monotone":
        seg_q = np.broadcast_to((t // 37) % 2, (B, T))
        seg_k = seg_q
    else:
        seg_q = np.broadcast_to(t // 100, (B, T))
        seg_k = seg_q + 10 * (t >= 200)
    return [torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))
            for x in (seg_q, seg_k)]


def _misses(own, other):
    """The kernels' skip test: the [min, max] intervals are disjoint."""
    return bool((other.max() < own.min()) | (other.min() > own.max()))


def _fold_backward(q, k, v, seg_q, seg_k, o, lse, do, causal, side, skip,
                   tile=64):
    """The wgmma backward's tile loops on the CPU, per (batch, head) as the
    kernels' CTAs run them: "dq" owns 64 query rows and folds key tiles,
    "dkdv" owns 64 key rows and folds query tiles; with ``skip``, a
    streamed tile whose segment interval misses the own rows' is passed
    over. Returns (gradients, tiles skipped)."""
    B, H, T, D = q.shape
    Tk = k.shape[-2]
    scale = 1.0 / np.sqrt(D)
    qs = q * scale
    delta = tattn._flash_delta(o, do).reshape(B, H, T)
    lse = lse.reshape(B, H, T)
    live = torch.isfinite(lse)
    safe = torch.where(live, lse, 0.0)

    def pds(b, i0, i1, j0, j1):
        vis = seg_q[b, i0:i1, None] == seg_k[b, None, j0:j1]
        if causal:
            vis = vis & (torch.arange(i0, i1)[:, None]
                         >= torch.arange(j0, j1)[None, :])
        vis = vis & live[b, :, i0:i1, None]
        s = qs[b, :, i0:i1] @ k[b, :, j0:j1].transpose(-1, -2)
        p = torch.where(vis, torch.exp(s - safe[b, :, i0:i1, None]), 0.0)
        dp = do[b, :, i0:i1] @ v[b, :, j0:j1].transpose(-1, -2)
        return p, p * (dp - delta[b, :, i0:i1, None])

    skipped = 0
    if side == "dq":
        dq = torch.zeros_like(q)
        for b in range(B):
            for q0 in range(0, T, 64):
                q1 = min(q0 + 64, T)
                for k0 in range(0, min(Tk, q1) if causal else Tk, tile):
                    k1 = min(k0 + tile, Tk)
                    if skip and _misses(seg_q[b, q0:q1], seg_k[b, k0:k1]):
                        skipped += 1
                        continue
                    _, ds = pds(b, q0, q1, k0, k1)
                    dq[b, :, q0:q1] += ds @ k[b, :, k0:k1]
        return [dq * scale], skipped
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(B):
        for k0 in range(0, Tk, 64):
            k1 = min(k0 + 64, Tk)
            for i0 in range(k0 if causal else 0, T, tile):
                i1 = min(i0 + tile, T)
                if skip and _misses(seg_k[b, k0:k1], seg_q[b, i0:i1]):
                    skipped += 1
                    continue
                p, ds = pds(b, i0, i1, k0, k1)
                dv[b, :, k0:k1] += p.transpose(-1, -2) @ do[b, :, i0:i1]
                dk[b, :, k0:k1] += ds.transpose(-1, -2) @ qs[b, :, i0:i1]
    return [dk, dv], skipped


@pytest.mark.parametrize("side", ["dq", "dkdv"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["monotone", "non-monotone", "disjoint"])
def test_backward_segment_tile_skip_is_exact(layout, causal, side):
    """Skipping the streamed tiles whose segment interval is disjoint from
    the own rows' (key tiles in dQ, query tiles in dK/dV) gives the same
    bits as folding them: such a tile holds no visible pair, so all of its
    p and dS are 0. Ragged T = 300 with tiles of 64 (the kernels' own rows)
    and 32 streamed rows (f32 at D = 64); non-monotone ids, where no tile
    may be skipped, and fully masked rows included. The fold is the plain
    backward's arithmetic."""
    rng = np.random.default_rng(12)
    T = 300
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(12, T=T, D=32)[:4])
    seg_q, seg_k = _layout_segments(layout, rng, q.shape[0], T)
    o, lse = tattn._flash_forward_plain(q, k, v, seg_q, seg_k, causal)
    args = (q, k, v, seg_q, seg_k, o, lse, do, causal, side)
    full, n_full = _fold_backward(*args, skip=False, tile=32)
    kept, n_kept = _fold_backward(*args, skip=True, tile=32)
    assert n_full == 0
    assert (n_kept == 0) == (layout == "non-monotone")
    for a, b in zip(full, kept):
        assert torch.equal(a, b)
    want = tattn._flash_backward_plain(q, k, v, seg_q, seg_k, o, lse, do,
                                       causal)
    want = want[:1] if side == "dq" else want[1:]
    for got, ref in zip(kept, want):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    if layout == "disjoint" and side == "dq":
        assert torch.all(kept[0][..., 200:, :] == 0)


def test_tile_wrapper_checks_inputs_before_launch():
    """The one-tile backward's wrapper takes only CUDA tensors and never
    runs the plain version itself: a CPU tensor is refused before any
    build or launch. The dispatch picks it by shape alone."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(13, T=21)[:4])
    seg = torch.zeros((2, 21), dtype=torch.int32)
    lse = torch.zeros((6, 1, 21))
    launches = [kern.launches for kern in _kernels.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_bwd_tile(q, k, v, seg, seg, q, lse, do, True)
    assert [kern.launches for kern in _kernels.KERNELS] == launches
    assert [_kernels.flash_bwd_design(tq, tk) for tq, tk in
            ((1, 1), (21, 21), (64, 64), (65, 21), (21, 300), (2048, 2048))
            ] == ["tile", "tile", "tile", "wgmma", "wgmma", "wgmma"]
