"""Attention ops: dense oracle, memory-efficient blockwise, flash forward.

The counterpart of :mod:`moolib_tpu.ops.attention`, with its contract
``[B, H, T, D] -> [B, H, T, D]``, causal masking and ``segment_ids``
(attention is blocked across segment boundaries; the transformer agent
uses them to stop attention across episode resets inside an unroll):

- :func:`dense_attention` materializes the [Tq, Tk] score matrix; the
  oracle and the path for short sequences.
- :func:`blockwise_attention` runs the online softmax over key blocks in
  plain PyTorch, so memory is O(T * block).
- :func:`flash_attention` is the flash kernel with its backward, a
  :class:`torch.autograd.Function` (the reference's ``custom_vjp``): the
  hand-written CUDA kernels ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``
  on a CUDA tensor, and :func:`_flash_forward_plain` /
  :func:`_flash_backward_plain`, the same functions in plain PyTorch, on
  a CPU tensor. It never falls back from one to the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _kernels

__all__ = [
    "dense_attention",
    "blockwise_attention",
    "flash_attention",
    "attention",
]

_NEG_INF = -1e30


def _scale(q: torch.Tensor) -> torch.Tensor:
    return q / math.sqrt(q.shape[-1])


def _mask_bias(Tq: int, Tk: int, causal: bool, seg_q, seg_k,
               device) -> Optional[torch.Tensor]:
    """[.., Tq, Tk] additive bias: 0 where allowed, the floor where
    masked (causal and segment floors add, as in the reference)."""
    bias = None
    if causal:
        qpos = torch.arange(Tq, device=device)[:, None]
        kpos = torch.arange(Tk, device=device)[None, :]
        bias = torch.where(qpos >= kpos, 0.0, _NEG_INF)
    if seg_q is not None:
        same = seg_q[..., :, None] == seg_k[..., None, :]
        seg_bias = torch.where(same, 0.0, _NEG_INF)
        bias = seg_bias if bias is None else bias + seg_bias
    return bias


def dense_attention(q, k, v, causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None):
    """Oracle attention. q [B, H, Tq, D], k/v [B, H, Tk, D],
    segment_ids [B, Tq] / kv_segment_ids [B, Tk] (defaults to
    segment_ids). Fully masked rows come out as a uniform average, as in
    the reference."""
    qf = _scale(q.float())
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
    seg_q = seg_k = None
    if segment_ids is not None:
        kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
        seg_q = segment_ids[:, None, :]
        seg_k = kv_seg[:, None, :]
    bias = _mask_bias(q.shape[-2], k.shape[-2], causal, seg_q, seg_k,
                      q.device)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(v.dtype)


def _online_block(q, k, v, bias, m, l, acc):
    """Fold one key block's scores into the running (m, l, acc) state.
    q [.., Tq, D], k/v [.., Tk, D], m/l [.., Tq], acc [.., Tq, D], f32.
    A row whose max is still at the floor is fully masked: its
    probabilities are zero (the flash kernel's rule)."""
    s = torch.einsum("...qd,...kd->...qk", q, k)
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(dim=-1))
    masked = m_new <= _NEG_INF / 2
    shift = torch.where(masked, 0.0, m_new)
    p = torch.where(masked[..., None], 0.0, torch.exp(s - shift[..., None]))
    scale_old = torch.where(m > _NEG_INF / 2, torch.exp(m - shift), 0.0)
    l_new = l * scale_old + p.sum(dim=-1)
    acc_new = acc * scale_old[..., None] + torch.einsum(
        "...qk,...kd->...qd", p, v
    )
    return m_new, l_new, acc_new


def _finalize(l, acc, dtype):
    # Fully masked rows (l == 0) return zeros, not NaNs.
    safe_l = torch.where(l > 0, l, 1.0)
    return (acc / safe_l[..., None]).to(dtype)


def blockwise_attention(q, k, v, causal: bool = False,
                        segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        block_k: int = 512, kv_position_offset: int = 0):
    """Memory-efficient attention: a loop over key blocks.

    ``kv_position_offset``: absolute position of k row 0 relative to q
    row 0 (negative when keys precede queries)."""
    qf = _scale(q.float())
    kf = k.float()
    vf = v.float()
    B, H, Tq, D = q.shape
    Tk = k.shape[-2]
    block_k = min(block_k, Tk)
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    qpos = torch.arange(Tq, device=q.device)[:, None] - kv_position_offset

    m = torch.full((B, H, Tq), -math.inf, device=q.device)
    l = torch.zeros((B, H, Tq), device=q.device)
    acc = torch.zeros((B, H, Tq, D), device=q.device)
    # A ragged last block is simply shorter: no padded keys to mask.
    for k0 in range(0, Tk, block_k):
        k1 = min(k0 + block_k, Tk)
        bias = None
        if causal:
            kpos = torch.arange(k0, k1, device=q.device)[None, :]
            bias = torch.where(qpos >= kpos, 0.0, _NEG_INF)
        if segment_ids is not None:
            same = segment_ids[:, None, :, None] == kv_seg[:, None, None,
                                                           k0:k1]
            seg_bias = torch.where(same, 0.0, _NEG_INF)
            bias = seg_bias if bias is None else bias + seg_bias
        m, l, acc = _online_block(qf, kf[..., k0:k1, :], vf[..., k0:k1, :],
                                  bias, m, l, acc)
    return _finalize(l, acc, v.dtype)


# ---------------------------------------------------------------------------
# Flash: kernels on the card, plain PyTorch on the CPU
# ---------------------------------------------------------------------------


def _flash_forward_plain(q, k, v, seg_q, seg_k, causal: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward in plain PyTorch: q [B,H,Tq,D], k/v [B,H,Tk,D],
    seg_q [B,Tq], seg_k [B,Tk] -> (o [B,H,Tq,D] in v's dtype,
    lse [B*H,1,Tq] f32).

    The kernel's masking rules without its tiling: masked scores sit at
    the -1e30 floor, a row whose max is <= -1e30/2 is fully masked and
    gives zeros and lse = +inf."""
    B, H, Tq, D = q.shape
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc) / math.sqrt(D), k.to(acc))
    s = torch.where(_visible(seg_q, seg_k, Tq, k.shape[-2], causal), s,
                    _NEG_INF)
    m = s.amax(dim=-1)
    shift = torch.where(m > _NEG_INF / 2, m, 0.0)
    p = torch.exp(s - shift[..., None])
    l = p.sum(dim=-1)
    safe_l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc)) / safe_l[..., None]
    lse = torch.where(l > 0, shift + torch.log(safe_l), math.inf)
    return o.to(v.dtype), lse.reshape(B * H, 1, Tq)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions compute in f32, or in f64 for f64 inputs (the
    kernels take f32 and bf16 only; f64 is for gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _visible(seg_q, seg_k, Tq: int, Tk: int, causal: bool) -> torch.Tensor:
    """[B, 1, Tq, Tk] True where query i may attend to key j."""
    visible = seg_q[:, None, :, None] == seg_k[:, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=seg_q.device)[:, None]
        kpos = torch.arange(Tk, device=seg_q.device)[None, :]
        visible = visible & (qpos >= kpos)
    return visible


def _flash_forward(q, k, v, seg_q, seg_k, causal: bool,
                   block_q: Optional[int], block_k: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's block contract when blocks are given, then the
    kernel for a CUDA tensor or the plain version for a CPU tensor."""
    if block_q is not None or block_k is not None:
        Tq, Tk = q.shape[-2], k.shape[-2]
        block_q = min(block_q or Tq, Tq)
        block_k = min(block_k or Tk, Tk)
        if Tq % block_q or Tk % block_k:
            raise ValueError(
                f"sequence lengths ({Tq}, {Tk}) must be multiples of the "
                f"block sizes ({block_q}, {block_k})"
            )
    if q.is_cuda:
        return _kernels.flash_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), seg_q.contiguous(),
                                  seg_k.contiguous(), causal)
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, seg_q, seg_k, causal)
    raise ValueError(f"flash attention has no kernel for {q.device}")


def _flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * o) [B*H, 1, Tq], the softmax-jacobian term,
    taken from the forward's returned (rounded) ``o`` as the reference
    takes it."""
    B, H, Tq, _ = o.shape
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(dim=-1).reshape(B * H, 1, Tq)


def _flash_backward_plain(q, k, v, seg_q, seg_k, o, lse, do, causal: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The flash backward in plain PyTorch: the forward's inputs, its
    ``o`` and ``lse`` [B*H,1,Tq], and dO like q -> (dq, dk, dv) in q's,
    k's and v's dtypes.

    The reference's rules: P is rebuilt from ``lse`` (P = 0 where lse is
    not finite, so fully masked rows give dq = 0 and add nothing to dk/dv;
    dense attention would average them uniformly instead), masked scores
    sit at the -1e30 floor, and delta comes from ``o``."""
    B, H, Tq, D = q.shape
    acc = _acc_dtype(q)
    scale = 1.0 / math.sqrt(D)
    qs, kf, vf, dof = q.to(acc) * scale, k.to(acc), v.to(acc), do.to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qs, kf)
    s = torch.where(_visible(seg_q, seg_k, Tq, k.shape[-2], causal), s,
                    _NEG_INF)
    lse = lse.reshape(B, H, Tq).to(acc)
    live = torch.isfinite(lse)
    safe_lse = torch.where(live, lse, 0.0)
    p = torch.where(live[..., None], torch.exp(s - safe_lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - _flash_delta(o, do).reshape(B, H, Tq, 1))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward(q, k, v, seg_q, seg_k, o, lse, do, causal: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels for a CUDA tensor (contiguous inputs), chosen by shape:
    at Tq, Tk <= 64 the one fused launch (delta from o inside it), else
    delta here and the dQ and dK/dV kernels; the plain version for a CPU
    tensor."""
    if q.is_cuda:
        if _kernels.flash_bwd_design(q.shape[-2], k.shape[-2]) == "tile":
            return _kernels.flash_bwd_tile(q, k, v, seg_q, seg_k, o, lse, do,
                                           causal)
        delta = _flash_delta(o, do)
        dq = _kernels.flash_bwd_dq(q, k, v, seg_q, seg_k, lse, delta, do,
                                   causal)
        dk, dv = _kernels.flash_bwd_dkdv(q, k, v, seg_q, seg_k, lse, delta,
                                         do, causal)
        return dq, dk, dv
    if q.device.type == "cpu":
        return _flash_backward_plain(q, k, v, seg_q, seg_k, o, lse, do,
                                     causal)
    raise ValueError(f"flash attention has no kernel for {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the flash forward: saves the
    inputs, ``o`` and ``lse``, and rebuilds P from ``lse`` in the
    backward. The segment ids and the static arguments get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, block_q, block_k):
        # The model hands over permuted views; the kernels take
        # contiguous rows, and the backward reuses these copies.
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash_forward(q, k, v, seg_q, seg_k, causal, block_q,
                                block_k)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, seg_q, seg_k, o, lse,
                                     do.contiguous(), ctx.causal)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """Flash attention for any sequence lengths, differentiable in q, k
    and v: the kernels pick their own tiles and mask ragged edges. Given
    ``block_q`` or ``block_k``, the call keeps the reference's contract
    (the sequence lengths must be multiples of them) and raises
    otherwise."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[-2]

    def zeros(T):
        return torch.zeros((B, T), dtype=torch.int32, device=q.device)

    seg_q = segment_ids if segment_ids is not None else zeros(Tq)
    if kv_segment_ids is not None:
        seg_k = kv_segment_ids
    else:
        seg_k = segment_ids if segment_ids is not None else zeros(Tk)
    return _FlashAttention.apply(
        q, k, v, seg_q.to(torch.int32).contiguous(),
        seg_k.to(torch.int32).contiguous(), causal, block_q, block_k,
    )


def _flash_capable(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.get_device_capability(t.device) == (9, 0)


def attention(q, k, v, backend: str = "auto", **kw):
    """Dispatcher: 'dense' | 'blockwise' | 'flash' | 'auto'. 'auto' picks
    the flash kernel for CUDA tensors on a Hopper card (capability 9.0),
    at any sequence length (the kernel tiles ragged lengths itself, so
    the block knobs are dropped), else dense for short sequences and
    blockwise otherwise. A flash failure raises; nothing degrades to
    another backend."""
    if backend == "auto":
        Tq, Tk = q.shape[-2], k.shape[-2]
        if _flash_capable(q):
            backend = "flash"
        elif Tq * Tk <= 1024 * 1024:
            backend = "dense"
        else:
            backend = "blockwise"
        kw.pop("block_q", None)  # Pallas tiling knobs; the kernel tiles
        if backend != "blockwise":  # itself
            kw.pop("block_k", None)
    fn = {
        "dense": dense_attention,
        "blockwise": blockwise_attention,
        "flash": flash_attention,
    }.get(backend)
    if fn is None:
        raise ValueError(f"unknown attention backend {backend!r}")
    return fn(q, k, v, **kw)
