"""Ring attention: exact attention over sequences sharded across ranks;
the counterpart of :mod:`moolib_tpu.ops.ring_attention`.

Every rank of the ``sp`` axis holds one sequence shard [B, H, T_local, D].
At each of the axis' N steps it folds the key/value shard it holds into
its online-softmax state (:mod:`moolib_tpu_torch.ops.attention`'s
``_online_block``, in plain PyTorch: no kernel sits inside the ring, as
in the reference) and passes the shard on to its ring neighbour. After
N steps every query row has attended to the whole global sequence.

K and V rotate as one packed buffer (with the key segment ids, which
carry no gradient), one exchange per step, through
:func:`~moolib_tpu_torch.parallel.collectives.ppermute_many`: its
backward sends the cotangent the inverse way, as ``ppermute`` transposes
to a ``ppermute`` in the reference, so the gradient is itself a ring
and every rank posts its messages in one order.

:func:`ring_attention` and :func:`zigzag_ring_attention` take this
rank's shards (the reference calls them inside ``shard_map``);
:func:`sequence_sharded_attention` and :func:`zigzag_sharded_attention`
take the global arrays, identical on every rank, and return the global
result on every rank.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..parallel import collectives
from .attention import _NEG_INF, _finalize, _online_block, _scale

__all__ = [
    "ring_attention",
    "sequence_sharded_attention",
    "zigzag_order",
    "zigzag_ring_attention",
    "zigzag_sharded_attention",
]


def _ring(n: int):
    return [(j, (j + 1) % n) for j in range(n)]


def _seg_bias(seg_q, seg_k):
    """[B, 1, Tq, Tk]: 0 within a segment, the floor across."""
    same = seg_q[:, None, :, None] == seg_k[:, None, None, :]
    return torch.where(same, 0.0, _NEG_INF)


def _zero_state(B, H, T, D, device):
    return (torch.full((B, H, T), -torch.inf, device=device),
            torch.zeros((B, H, T), device=device),
            torch.zeros((B, H, T, D), device=device))


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = False,
                   segment_ids: Optional[torch.Tensor] = None,
                   kv_segment_ids: Optional[torch.Tensor] = None):
    """Exact global attention over this rank's sequence shards.

    ``q``, ``k``, ``v`` [B, H, T_local, D] are this rank's rows of the
    global sequence (the concatenation over ``axis_name`` of ``mesh``, a
    ``DeviceMesh`` or the axis' process group, in axis-index order);
    ``segment_ids`` [B, T_local] the query segment ids, and
    ``kv_segment_ids`` the key ones (default: ``segment_ids``).

    Returns [B, H, T_local, D], this rank's rows of the global result.
    With ``causal`` a shard from a later rank is fully masked, so its
    fold is skipped; the rotation still happens on every rank."""
    group = collectives.axis_group(mesh, axis_name)
    n = collectives.axis_size(group)
    idx = collectives.axis_index(group)
    B, H, T, D = q.shape
    qf = _scale(q.float())

    if segment_ids is None and kv_segment_ids is not None:
        raise ValueError(
            "kv_segment_ids without segment_ids: key segments would be "
            "silently ignored; pass both (or segment_ids alone)")
    use_seg = segment_ids is not None
    segb = segment_ids if kv_segment_ids is None else kv_segment_ids
    if segb is None:
        segb = torch.zeros((B, T), dtype=torch.int32, device=q.device)

    qpos = idx * T + torch.arange(T, device=q.device)
    m, l, acc = _zero_state(B, H, T, D, q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        # The shard held at step i came from rank (idx - i) mod n.
        src = (idx - i) % n
        if not causal or src <= idx:
            bias = None
            if causal:
                kpos = src * T + torch.arange(T, device=q.device)
                bias = torch.where(qpos[:, None] >= kpos[None, :], 0.0,
                                   _NEG_INF)
            if use_seg:
                sb = _seg_bias(segment_ids, segb)
                bias = sb if bias is None else bias + sb
            m, l, acc = _online_block(qf, kv[0].float(), kv[1].float(),
                                      bias, m, l, acc)
        if i < n - 1:  # the n-th rotation would only bring shards home
            kv, segb = collectives.ppermute_many([kv, segb], group,
                                                 [_ring(n)] * 2)
    if causal and (idx + 1) % n > idx:
        # The last shard came from a later rank and was skipped: tie it
        # to the result with weight 0, so that the backward still runs
        # every rotation here (its neighbours' rotations wait for them).
        acc = acc + 0.0 * kv.sum()
    return _finalize(l, acc, v.dtype)


def sequence_sharded_attention(mesh, q, k, v, axis_name: str = "sp",
                               causal: bool = False,
                               segment_ids: Optional[torch.Tensor] = None):
    """Ring attention over global [B, H, T, D] arrays, identical on every
    rank: each rank takes its T shard, runs :func:`ring_attention`, and
    the shards' results are gathered into the global result on every
    rank (differentiable: the gradients of q, k and v are global too)."""
    group = collectives.axis_group(mesh, axis_name)
    q, k, v = (collectives.scatter_to(x, group, 2) for x in (q, k, v))
    seg = None if segment_ids is None else collectives.scatter_to(segment_ids, group, 1)
    o = ring_attention(q, k, v, group, causal=causal, segment_ids=seg,
                       kv_segment_ids=seg)
    return collectives.gather_from(o, group, 2)


# -- zigzag (striped) causal ring attention -----------------------------------
#
# Plain ring attention with contiguous shards is causally imbalanced: the
# last rank folds every shard, the first only its own. The zigzag layout
# splits the sequence into 2n chunks and gives rank d chunks (d, 2n-1-d);
# every (q-chunk a, k-chunk b) pair is decided per chunk (a > b: full
# fold, a == b: triangle, a < b: skip), and every rank folds 2n+1 chunk
# pairs per ring pass.


@functools.lru_cache(maxsize=64)
def _zigzag_order_cached(n: int, seq_len: int):
    if seq_len % (2 * n) != 0:
        raise ValueError(f"seq_len {seq_len} not divisible by 2n={2 * n}")
    tc = seq_len // (2 * n)
    chunks = []
    for d in range(n):
        chunks += [d, 2 * n - 1 - d]
    perm = np.concatenate([np.arange(c * tc, (c + 1) * tc) for c in chunks])
    perm.setflags(write=False)
    inv = np.argsort(perm)
    inv.setflags(write=False)
    return perm, inv


def zigzag_order(n: int, seq_len: int) -> np.ndarray:
    """Gather indices reordering a global [.., S, ..] sequence so that a
    contiguous n-way split gives rank d chunks (d, 2n-1-d). Invert with
    argsort."""
    return _zigzag_order_cached(n, seq_len)[0]


def zigzag_ring_attention(q, k, v, mesh, axis_name: str = "sp",
                          segment_ids: Optional[torch.Tensor] = None,
                          kv_segment_ids: Optional[torch.Tensor] = None):
    """Causal attention over zigzag-laid-out shards [B, H, 2*Tc, D]: rows
    [:Tc] are global chunk ``idx`` and rows [Tc:] chunk ``2n-1-idx``
    (:func:`zigzag_order` makes the layout). Causality is the layout's;
    there is no ``causal=False``."""
    group = collectives.axis_group(mesh, axis_name)
    n = collectives.axis_size(group)
    idx = collectives.axis_index(group)
    B, H, T2, D = q.shape
    if T2 % 2 != 0:
        raise ValueError("zigzag shard length must be even (two chunks)")
    tc = T2 // 2
    qf = _scale(q.float())

    if segment_ids is None and kv_segment_ids is not None:
        raise ValueError("kv_segment_ids without segment_ids")
    use_seg = segment_ids is not None
    segb = kv_segment_ids if kv_segment_ids is not None else segment_ids
    if segb is None:
        segb = torch.zeros((B, T2), dtype=torch.int32, device=q.device)
    seg_local = segment_ids if use_seg else segb
    sq = (seg_local[:, :tc], seg_local[:, tc:])
    ar = torch.arange(tc, device=q.device)
    tri = torch.where(ar[:, None] >= ar[None, :], 0.0, _NEG_INF)

    def fold(qc, kc, vc, sqc, skc, a, b, mla):
        """Fold k-chunk ``b`` into q-chunk ``a``'s state: a < b skip,
        a == b the causal triangle, a > b in full."""
        if a < b:
            return mla
        bias = tri if a == b else None
        if use_seg:
            sb = _seg_bias(sqc, skc)
            bias = sb if bias is None else bias + sb
        return _online_block(qc, kc, vc, bias, *mla)

    qc = (qf[..., :tc, :], qf[..., tc:, :])
    a = (idx, 2 * n - 1 - idx)
    mla = [_zero_state(B, H, tc, D, q.device) for _ in range(2)]
    kv = torch.stack([k, v])
    for i in range(n):
        src = (idx - i) % n
        b = (src, 2 * n - 1 - src)
        kf, vf = kv[0].float(), kv[1].float()
        kc = (kf[..., :tc, :], kf[..., tc:, :])
        vc = (vf[..., :tc, :], vf[..., tc:, :])
        sk = (segb[:, :tc], segb[:, tc:])
        for x in range(2):
            for y in range(2):
                mla[x] = fold(qc[x], kc[y], vc[y], sq[x], sk[y], a[x], b[y],
                              mla[x])
        if i < n - 1:
            kv, segb = collectives.ppermute_many([kv, segb], group,
                                                 [_ring(n)] * 2)
    out0 = _finalize(mla[0][1], mla[0][2], v.dtype)
    out1 = _finalize(mla[1][1], mla[1][2], v.dtype)
    return torch.cat([out0, out1], dim=-2)


def zigzag_sharded_attention(mesh, q, k, v, axis_name: str = "sp",
                             segment_ids: Optional[torch.Tensor] = None):
    """Causal zigzag ring attention over global [B, H, S, D] arrays,
    identical on every rank: permutes the sequence into zigzag order,
    takes this rank's shard, runs :func:`zigzag_ring_attention`, gathers
    and un-permutes. The permutations materialize global arrays; a
    training loop at scale keeps its data in zigzag layout end to end
    and calls :func:`zigzag_ring_attention` itself."""
    group = collectives.axis_group(mesh, axis_name)
    n = collectives.axis_size(group)
    perm, inv = _zigzag_order_cached(n, q.shape[-2])
    perm_t = torch.as_tensor(perm, device=q.device)
    inv_t = torch.as_tensor(inv, device=q.device)
    q, k, v = (collectives.scatter_to(x.index_select(-2, perm_t), group, 2)
               for x in (q, k, v))
    seg = None
    if segment_ids is not None:
        seg = collectives.scatter_to(segment_ids.index_select(-1, perm_t), group, 1)
    o = zigzag_ring_attention(q, k, v, group, segment_ids=seg,
                              kv_segment_ids=seg)
    return collectives.gather_from(o, group, 2).index_select(-2, inv_t)
