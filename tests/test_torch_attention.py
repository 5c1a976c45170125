"""Port parity: moolib_tpu_torch.ops.attention against moolib_tpu.ops.attention.

The same numpy inputs go through the JAX reference (its Pallas flash
kernel in interpret mode) and the port (the plain PyTorch flash forward,
which the wrapper runs for CPU tensors; the CUDA kernel itself is held
against it on the card by chip_smoke.py and tests/test_torch_cuda.py).
Tolerance 2e-5 in f32, as tests/test_attention.py holds its own backends.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu.ops import attention as jattn
from moolib_tpu_torch.ops import _kernels
from moolib_tpu_torch.ops import attention as tattn

ATOL = 2e-5


def _qkv(rng, B=2, H=3, T=32, D=16, Tk=None):
    shapes = [(B, H, T, D), (B, H, Tk or T, D), (B, H, Tk or T, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _segs(rng, B=2, T=32):
    return np.cumsum(rng.random((B, T)) < 0.1, axis=1).astype(np.int32)


def _jax_flash(q, k, v, seg_q, seg_k, causal, block):
    o, lse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg_q),
        jnp.asarray(seg_k), causal, block, block, True,
    )
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _port_flash(q, k, v, seg_q, seg_k, causal, block, dtype=torch.float32):
    o, lse = tattn._flash_forward(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        torch.from_numpy(seg_q), torch.from_numpy(seg_k), causal, block,
        block,
    )
    return o.float().numpy(), lse.numpy()


def _assert_lse_close(l1, l2, atol):
    assert np.array_equal(np.isinf(l1), np.isinf(l2))
    fin = np.isfinite(l1)
    np.testing.assert_allclose(l1[fin], l2[fin], atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_segs", [False, True])
def test_flash_forward_plain_matches_jax_kernel(causal, with_segs):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng)
    seg = _segs(rng) if with_segs else np.zeros((2, 32), np.int32)
    o1, l1 = _jax_flash(q, k, v, seg, seg, causal, 16)
    o2, l2 = _port_flash(q, k, v, seg, seg, causal, 16)
    assert l2.shape == l1.shape == (6, 1, 32)
    np.testing.assert_allclose(o1, o2, atol=ATOL)
    _assert_lse_close(l1, l2, ATOL)


def test_flash_forward_plain_fully_masked_rows():
    """kv segments that no query of some rows shares: those rows give
    zeros and lse=+inf in both (dense would give a uniform average)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng)
    seg_q = np.zeros((2, 32), np.int32)
    seg_q[:, 20:] = 1  # no key carries segment 1
    seg_k = np.zeros((2, 32), np.int32)
    seg_k[1, 5:] = 2
    o1, l1 = _jax_flash(q, k, v, seg_q, seg_k, False, 16)
    o2, l2 = _port_flash(q, k, v, seg_q, seg_k, False, 16)
    masked = np.isinf(l2)
    assert masked.any() and (~masked).any()
    np.testing.assert_array_equal(o2.reshape(6, 32, 16)[masked[:, 0]], 0.0)
    np.testing.assert_allclose(o1, o2, atol=ATOL)
    _assert_lse_close(l1, l2, ATOL)


def test_flash_forward_plain_single_step():
    """T=1, the act step's shape: each query sees only itself."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, B=4, H=2, T=1, D=32)
    seg = np.zeros((4, 1), np.int32)
    o1, l1 = _jax_flash(q, k, v, seg, seg, True, 256)
    o2, l2 = _port_flash(q, k, v, seg, seg, True, 256)
    np.testing.assert_allclose(o1, o2, atol=ATOL)
    np.testing.assert_allclose(o2, v, atol=ATOL)
    _assert_lse_close(l1, l2, ATOL)


def test_flash_forward_plain_bf16_inputs():
    """bf16 q/k/v: both widen to f32 and round o back to bf16, so o
    agrees to one bf16 rounding (2**-7 relative) and lse to f32."""
    rng = np.random.default_rng(3)
    q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in _qkv(rng))
    seg = _segs(rng)
    o1, l1 = jattn._flash_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(seg), jnp.asarray(seg), True, 16, 16, True,
    )
    o2, l2 = _port_flash(q, k, v, seg, seg, True, 16, dtype=torch.bfloat16)
    o1 = np.asarray(o1.astype(jnp.float32))
    np.testing.assert_allclose(o1, o2, atol=2e-2)
    _assert_lse_close(np.asarray(l1), l2, ATOL)


def test_flash_attention_public_matches_jax_with_kv_segments():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, T=32, Tk=48)
    seg_q = _segs(rng, T=32)
    seg_k = _segs(rng, T=48)
    o1 = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=jnp.asarray(seg_q), kv_segment_ids=jnp.asarray(seg_k),
        block_q=16, block_k=16,
    )
    o2 = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segment_ids=torch.from_numpy(seg_q),
        kv_segment_ids=torch.from_numpy(seg_k), block_q=16, block_k=16,
    )
    np.testing.assert_allclose(np.asarray(o1), o2.numpy(), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_segs", [False, True])
def test_dense_and_blockwise_match_jax(causal, with_segs):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, T=50)
    seg = _segs(rng, T=50) if with_segs else None
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    d1 = jattn.dense_attention(jq, jk, jv, causal=causal, segment_ids=jseg)
    d2 = tattn.dense_attention(tq, tk, tv, causal=causal, segment_ids=tseg)
    np.testing.assert_allclose(np.asarray(d1), d2.numpy(), atol=ATOL)
    # block_k=16 leaves a ragged tail of 2 keys.
    b1 = jattn.blockwise_attention(jq, jk, jv, causal=causal,
                                   segment_ids=jseg, block_k=16)
    b2 = tattn.blockwise_attention(tq, tk, tv, causal=causal,
                                   segment_ids=tseg, block_k=16)
    np.testing.assert_allclose(np.asarray(b1), b2.numpy(), atol=ATOL)


def test_blockwise_kv_position_offset_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, T=16, Tk=24)
    kw = dict(causal=True, block_k=8, kv_position_offset=-8)
    b1 = jattn.blockwise_attention(*(jnp.asarray(x) for x in (q, k, v)), **kw)
    b2 = tattn.blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   **kw)
    np.testing.assert_allclose(np.asarray(b1), b2.numpy(), atol=ATOL)


def test_auto_dispatch_on_cpu_follows_the_size_rule():
    """CPU tensors never pick flash on 'auto': dense for short sequences
    (here), blockwise past 1024*1024 scores."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    out = tattn.attention(q, k, v, backend="auto", causal=True, block_q=16,
                          block_k=16)
    torch.testing.assert_close(
        out, tattn.dense_attention(q, k, v, causal=True), atol=0, rtol=0
    )
    with pytest.raises(ValueError, match="unknown attention backend"):
        tattn.attention(q, k, v, backend="ring")


def test_flash_block_contract_and_grad_refusal():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, T=20))
    with pytest.raises(ValueError, match="multiples of the block"):
        tattn.flash_attention(q, k, v, block_q=16, block_k=16)
    # Blocks larger than T shrink to T, as in the reference.
    assert tattn.flash_attention(q, k, v, block_q=256).shape == q.shape
    # Without blocks any T goes through: the kernel masks ragged tiles.
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, T=300))
    with pytest.raises(ValueError, match="multiples of the block"):
        tattn.flash_attention(q, k, v, causal=True, block_q=256,
                              block_k=256)
    torch.testing.assert_close(
        tattn.flash_attention(q, k, v, causal=True),
        tattn.dense_attention(q, k, v, causal=True), atol=2e-5, rtol=0,
    )
    # Inputs that require grad go through the autograd Function: the
    # gradients flow and match dense attention's on a causal call.
    q.requires_grad_()
    (g_flash,) = torch.autograd.grad(
        tattn.flash_attention(q, k, v, causal=True).sum(), q)
    (g_dense,) = torch.autograd.grad(
        tattn.dense_attention(q, k, v, causal=True).sum(), q)
    assert float(g_flash.abs().max()) > 0
    torch.testing.assert_close(g_flash, g_dense, atol=1e-4, rtol=0)


def test_kernel_wrapper_checks_inputs_before_launch():
    """The CUDA wrappers take only CUDA tensors and never run the plain
    version themselves; a CPU tensor is refused before any build."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng))
    seg = torch.zeros((2, 32), dtype=torch.int32)
    stat = torch.zeros((6, 1, 32))
    launches = [kern.launches for kern in _kernels.KERNELS]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_fwd(q, k, v, seg, seg, True)
    for wrapper in (_kernels.flash_bwd_dq, _kernels.flash_bwd_dkdv):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(q, k, v, seg, seg, stat, stat, q, True)
    assert [kern.launches for kern in _kernels.KERNELS] == launches
    assert all(kern.source.exists() for kern in _kernels.KERNELS)
    # The three backward kernels share one source, hence one build.
    assert _kernels.FLASH_BWD_DQ.library is _kernels.FLASH_BWD_DKDV.library
    assert _kernels.FLASH_BWD_TILE.library is _kernels.FLASH_BWD_DQ.library


def _fold_tiles(q, k, v, seg_q, seg_k, causal, skip):
    """The wgmma forward's tile loop on the CPU: for each tile of 64 query
    rows, fold key tiles of 64 through ``_online_block``; with ``skip``,
    pass over a key tile whose [min, max] of seg_k misses the query
    tile's, as the kernel does. Returns (o, lse, tiles skipped)."""
    T, Tk = q.shape[-2], k.shape[-2]
    qf, kf, vf = tattn._scale(q.float()), k.float(), v.float()
    o = torch.empty_like(qf)
    lse = torch.empty(q.shape[:-1])
    skipped = 0
    for q0 in range(0, T, 64):
        q1 = min(q0 + 64, T)
        qseg = seg_q[:, q0:q1]
        m = torch.full((*q.shape[:2], q1 - q0), -float("inf"))
        l = torch.zeros_like(m)
        acc = torch.zeros((*q.shape[:2], q1 - q0, q.shape[-1]))
        k_end = min(Tk, q1) if causal else Tk
        for k0 in range(0, k_end, 64):
            k1 = min(k0 + 64, Tk)
            kseg = seg_k[:, k0:k1]
            if skip and bool((kseg.max() < qseg.min())
                             | (kseg.min() > qseg.max())):
                skipped += 1
                continue
            vis = qseg[:, None, :, None] == kseg[:, None, None, :]
            if causal:
                vis = vis & (torch.arange(q0, q1)[:, None]
                             >= torch.arange(k0, k1)[None, :])
            bias = torch.where(vis, 0.0, tattn._NEG_INF)
            m, l, acc = tattn._online_block(qf[..., q0:q1, :],
                                            kf[..., k0:k1, :],
                                            vf[..., k0:k1, :], bias, m, l,
                                            acc)
        o[..., q0:q1, :] = tattn._finalize(l, acc, torch.float32)
        shift = torch.where(m > tattn._NEG_INF / 2, m, 0.0)
        lse[..., q0:q1] = torch.where(l > 0, shift + torch.log(
            torch.where(l > 0, l, 1.0)), float("inf"))
    return o, lse, skipped


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["monotone", "non-monotone", "disjoint"])
def test_segment_tile_skip_is_exact(layout, causal):
    """Skipping key tiles whose segment interval is disjoint from the
    query tile's gives the same bits as folding them: such a tile's
    scores all sit at the floor, which leaves m, l and acc as they were
    (scale_old is 1 for a row with a visible key, 0 either way for a row
    without one). Fully masked rows (disjoint kv ids) and non-monotone
    ids, where no tile may be skipped, included."""
    rng = np.random.default_rng(11)
    T = 300  # ragged: query and key tiles of 64 leave a 44-row tail
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, B=2, H=2, T=T, D=32))
    t = np.arange(T)
    if layout == "monotone":  # the model's cumsum of resets
        seg_q = np.cumsum(rng.random((2, T)) < 0.02, axis=1)
        seg_k = seg_q
    elif layout == "non-monotone":
        seg_q = np.broadcast_to((t // 37) % 2, (2, T))
        seg_k = seg_q
    else:
        seg_q = np.broadcast_to(t // 100, (2, T))
        seg_k = seg_q + 10 * (t >= 200)  # rows 200+ see no key
    seg_q, seg_k = (torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))
                    for x in (seg_q, seg_k))
    o1, l1, n1 = _fold_tiles(q, k, v, seg_q, seg_k, causal, skip=False)
    o2, l2, n2 = _fold_tiles(q, k, v, seg_q, seg_k, causal, skip=True)
    assert n1 == 0
    assert (n2 == 0) == (layout == "non-monotone")
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    if layout == "disjoint":
        assert torch.isinf(l2[..., 200:]).all()
        assert torch.all(o2[..., 200:, :] == 0)
    # And the folded result is the plain forward's.
    o_ref, lse_ref = tattn._flash_forward_plain(q, k, v, seg_q, seg_k, causal)
    torch.testing.assert_close(o2, o_ref, atol=ATOL, rtol=0)
    _assert_lse_close(l2.reshape(-1, 1, T).numpy(), lse_ref.numpy(), ATOL)


def test_library_hash_covers_included_headers(tmp_path):
    """A kernel library is named by its source and every csrc header it
    includes, so an edited header is rebuilt, not loaded stale."""
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n')
    lib = _kernels.CudaLibrary("k", str(tmp_path / "k.cu"))
    assert sorted(p.name for p in lib.sources()) == ["a.cuh", "b.cuh",
                                                     "k.cu"]
    before = lib.library_path()
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert lib.library_path() != before
    # Both flash sources include the shared operand header.
    for kern, src in ((_kernels.FLASH_FWD, "flash_fwd.cu"),
                      (_kernels.FLASH_BWD_DQ, "flash_bwd.cu")):
        names = {p.name for p in kern.library.sources()}
        assert names == {src, "operands.cuh", "wgmma.cuh"}


def test_cached_build_keeps_its_log(tmp_path, monkeypatch):
    """A library built by an earlier process is loaded without nvcc; its
    compiler output (registers, spills) comes from the log kept beside
    it, so a second run reports the same build."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("int k;\n")
    lib = _kernels.CudaLibrary("k", str(tmp_path / "k.cu"))
    out = lib.library_path()
    out.parent.mkdir()
    out.write_bytes(b"")
    out.with_suffix(".log").write_text("ptxas info: Used 40 registers\n")
    lib._build()
    assert lib.build_log == "ptxas info: Used 40 registers\n"
