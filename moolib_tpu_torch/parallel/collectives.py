"""The collectives of the port's mesh axes: what the reference's
``shard_map`` bodies call through ``jax.lax``, on ``torch.distributed``.

- ``jax.lax.ppermute`` is :func:`ppermute` (one ``batch_isend_irecv``
  per call, its backward sends the cotangent the inverse way);
- ``jax.lax.psum`` / ``pmean`` are :func:`psum` / :func:`pmean`
  (``all_reduce``);
- ``jax.lax.all_to_all`` is :func:`all_to_all` (``all_to_all_single``,
  its own inverse in the backward);
- the Megatron region operators that GSPMD inserts for the reference's
  tensor parallelism are :func:`copy_to`, :func:`reduce_from`,
  :func:`gather_from` and :func:`scatter_to`.

A mesh axis is a process group: a function takes a
``DeviceMesh`` and an axis name (or the group itself) where the
reference takes an ``axis_name`` inside ``shard_map``.

Gradients follow one convention, the reference's under ``shard_map``: a
value that is the same on every rank of the axis (replicated) carries
the same cotangent on every rank, counted once; a value that differs by
rank carries that rank's own cotangent. So ``psum``'s backward is the
identity, ``pmean``'s divides by the axis size, a gather's backward
keeps this rank's slice, and the gradients of replicated parameters are
summed over the axis after the backward (:func:`~moolib_tpu_torch.
parallel.mesh.psum_gradients`).

The transport is chosen by the group's backend and the tensor's
device, from the caller, and nothing switches it when an operation
fails: NCCL moves card tensors, gloo moves host tensors, and a gloo
group holding card tensors goes through :func:`_through_host`. Any
other pair raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "axis_group",
    "axis_size",
    "axis_index",
    "transport",
    "all_reduce_",
    "broadcast_",
    "exchange",
    "all_gather",
    "ppermute",
    "ppermute_many",
    "psum",
    "pmean",
    "all_to_all",
    "copy_to",
    "reduce_from",
    "gather_from",
    "scatter_to",
    "TRAFFIC",
]

Perm = Sequence[Tuple[int, int]]


class Traffic:
    """The bytes this process hands to its collectives (a P2P send's
    payload, an all-reduce's or a broadcast's buffer, an all-gather's own
    part, an all-to-all's rows for the other ranks), a measuring
    instrument as the kernels' launch counts are."""

    def __init__(self):
        self.sent = 0


TRAFFIC = Traffic()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def axis_group(mesh, axis_name: Optional[str] = None):
    """The process group of ``axis_name`` on ``mesh`` (a ``DeviceMesh``),
    or ``mesh`` itself when it is already a process group."""
    if isinstance(mesh, dist.ProcessGroup):
        return mesh
    if axis_name is None:
        return mesh.get_group()
    return mesh.get_group(axis_name)


def axis_size(mesh, axis_name: Optional[str] = None) -> int:
    return dist.get_world_size(axis_group(mesh, axis_name))


def axis_index(mesh, axis_name: Optional[str] = None) -> int:
    """This rank's index along the axis (``jax.lax.axis_index``)."""
    return dist.get_rank(axis_group(mesh, axis_name))


def transport(group, device: torch.device) -> str:
    """``"direct"`` where the group's backend moves tensors of
    ``device``, ``"host"`` for card tensors in a gloo group; raises for
    any other pair."""
    backend = dist.get_backend(group)
    kind = torch.device(device).type
    if (backend, kind) in (("nccl", "cuda"), ("gloo", "cpu")):
        return "direct"
    if (backend, kind) == ("gloo", "cuda"):
        return "host"
    raise RuntimeError(f"no transport for {kind} tensors over a {backend} "
                       "process group")


def _through_host(op: Callable, tensors: Sequence[torch.Tensor]) -> None:
    """The transport of card tensors in a gloo group, and not a fallback
    from another: gloo moves host memory, so ``op`` runs on host copies
    of ``tensors`` and the results are copied back into them on the
    card. Taken only where :func:`transport` says ``"host"``."""
    host = [t.detach().cpu() for t in tensors]
    op(host)
    with torch.no_grad():
        for t, h in zip(tensors, host):
            t.copy_(h)


def _run(group, tensors: Sequence[torch.Tensor], op: Callable) -> None:
    """``op(tensors)`` over ``group``, in place, on the transport the
    group and the tensors' device call for."""
    if transport(group, tensors[0].device) == "host":
        _through_host(op, tensors)
    else:
        op(list(tensors))


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over ``group``; returns ``t``."""
    TRAFFIC.sent += _nbytes(t)
    _run(group, [t], lambda ts: dist.all_reduce(ts[0], op=op, group=group))
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Broadcast ``t`` in place from global rank ``src``; returns ``t``."""
    group = group if group is not None else dist.group.WORLD
    TRAFFIC.sent += _nbytes(t)
    _run(group, [t], lambda ts: dist.broadcast(ts[0], src, group=group))
    return t


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group) -> None:
    """One ``batch_isend_irecv``: each ``(tensor, peer)`` of ``sends``
    goes to the group rank ``peer``; each of ``recvs`` is filled, in
    place, from its peer. Messages pair by their position in the two
    lists (the i-th send to a peer with the i-th receive there), tagged
    so."""
    if not sends and not recvs:
        return
    n_s = len(sends)
    peers = [p for _, p in sends] + [p for _, p in recvs]
    tensors = [t.contiguous() for t, _ in sends] + [t for t, _ in recvs]
    tags = _pair_tags(peers[:n_s]) + _pair_tags(peers[n_s:])
    TRAFFIC.sent += sum(_nbytes(t) for t in tensors[:n_s])

    def op(ts):
        ops = [dist.P2POp(dist.isend if i < n_s else dist.irecv, t,
                          dist.get_global_rank(group, p), group, tag)
               for i, (t, p, tag) in enumerate(zip(ts, peers, tags))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    if transport(group, tensors[0].device) == "host":
        host = [t.detach().cpu() for t in tensors]
        op(host)
        with torch.no_grad():
            for t, h in zip(tensors[n_s:], host[n_s:]):
                t.copy_(h)
    else:
        op(tensors)


def _pair_tags(peers: Sequence[int]) -> List[int]:
    """The i-th message to (or from) one peer gets tag i."""
    seen: dict = {}
    tags = []
    for p in peers:
        tags.append(seen.get(p, 0))
        seen[p] = tags[-1] + 1
    return tags


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """[G, *t.shape]: every rank's ``t`` in group-rank order."""
    n = dist.get_world_size(group)
    src = t.detach().reshape(-1).contiguous()
    out = src.new_empty((n * src.numel(),))
    TRAFFIC.sent += _nbytes(src)

    def op(ts):
        dist.all_gather_into_tensor(ts[0], ts[1], group=group)

    _run(group, [out, src], op)
    return out.view((n,) + tuple(t.shape))


# -- differentiable collectives ------------------------------------------------


def _moves(perm: Perm, me: int) -> Tuple[List[int], List[int]]:
    """Where this rank sends and whence it receives under ``perm``."""
    return ([d for s, d in perm if s == me], [s for s, d in perm if d == me])


def _permute(group, xs: Sequence[torch.Tensor], perms: Sequence[Perm]
             ) -> List[torch.Tensor]:
    """Every ``xs[i]`` moved along ``perms[i]`` in one exchange; a rank
    that ``perms[i]`` sends nothing to gets zeros (``ppermute``'s
    rule)."""
    me = dist.get_rank(group)
    sends, recvs, outs = [], [], []
    for x, perm in zip(xs, perms):
        dsts, srcs = _moves(perm, me)
        if len(srcs) > 1:
            raise ValueError(f"permutation {perm} sends twice to rank {me}")
        out = torch.zeros_like(x, memory_format=torch.contiguous_format)
        if dsts == [me] and srcs == [me]:
            out = x.detach().clone()
        else:
            sends += [(x.detach(), d) for d in dsts]
            recvs += [(out, s) for s in srcs]
        outs.append(out)
    exchange(sends, recvs, group)
    return outs


def _inverse(perm: Perm) -> List[Tuple[int, int]]:
    return [(d, s) for s, d in perm]


class _PPermute(torch.autograd.Function):
    """``ppermute`` of several tensors at once; the backward moves their
    cotangents along the inverse permutations, also in one exchange."""

    @staticmethod
    def forward(ctx, group, perms, *xs):
        ctx.group, ctx.perms = group, perms
        ctx.diff = [x.is_floating_point() for x in xs]
        ctx.meta = [(x.shape, x.dtype, x.device) for x in xs]
        outs = _permute(group, xs, perms)
        ctx.mark_non_differentiable(
            *[o for o, d in zip(outs, ctx.diff) if not d])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        # Integer payloads (segment ids) ride the forward only.
        idx = [i for i, d in enumerate(ctx.diff) if d]
        gs = [torch.zeros(ctx.meta[i][0], dtype=ctx.meta[i][1],
                          device=ctx.meta[i][2]) if gs[i] is None else gs[i]
              for i in idx]
        back = _permute(ctx.group, gs,
                        [_inverse(ctx.perms[i]) for i in idx])
        out = [None] * len(ctx.diff)
        for i, g in zip(idx, back):
            out[i] = g
        return (None, None, *out)


def ppermute_many(xs: Sequence[torch.Tensor], mesh, perms: Sequence[Perm],
                  axis_name: Optional[str] = None) -> List[torch.Tensor]:
    """``jax.lax.ppermute`` of each ``xs[i]`` along ``perms[i]``, all in
    one exchange (one chain of messages, so every rank posts them in the
    same order, in the forward and in the backward)."""
    group = axis_group(mesh, axis_name)
    perms = [tuple((int(s), int(d)) for s, d in p) for p in perms]
    n = dist.get_world_size(group)
    if all(len(p) == n and all(s == d for s, d in p) for p in perms):
        return list(xs)  # the identity (a size-1 axis' ring): a no-op
    return list(_PPermute.apply(group, tuple(perms), *xs))


def ppermute(x: torch.Tensor, mesh, perm: Perm,
             axis_name: Optional[str] = None) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis_name, perm)``: ``perm`` holds
    ``(source, destination)`` pairs of axis indices."""
    return ppermute_many([x], mesh, [perm], axis_name)[0]


class _Psum(torch.autograd.Function):
    """Forward: the sum over the group (divided by ``scale``). Backward:
    the cotangent (divided by ``scale``): the sum is replicated, so its
    cotangent is counted once, on every rank."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = all_reduce_(x.detach().clone(), group)
        return out / scale if scale != 1 else out

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.scale if ctx.scale != 1 else g), None, None


def psum(x: torch.Tensor, mesh, axis_name: Optional[str] = None
         ) -> torch.Tensor:
    """``jax.lax.psum`` over the axis."""
    return _Psum.apply(x, axis_group(mesh, axis_name), 1)


def pmean(x: torch.Tensor, mesh, axis_name: Optional[str] = None
          ) -> torch.Tensor:
    """``jax.lax.pmean`` over the axis."""
    group = axis_group(mesh, axis_name)
    return _Psum.apply(x, group, dist.get_world_size(group))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    TRAFFIC.sent += _nbytes(src) * (src.shape[0] - 1) // src.shape[0]

    def op(ts):
        dist.all_to_all_single(ts[0], ts[1], group=group)

    _run(group, [out, src], op)
    return out


class _AllToAll(torch.autograd.Function):
    """Row g of this rank's [G, ...] goes to rank g, whose row i becomes
    it; the exchange is its own inverse, so the backward is the same
    exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, mesh, axis_name: Optional[str] = None
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)`` for ``x`` [G, ...] with G the axis size."""
    group = axis_group(mesh, axis_name)
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all needs a leading axis of the group's "
                         f"size {dist.get_world_size(group)}, got "
                         f"{tuple(x.shape)}")
    return _AllToAll.apply(x, group)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: a replicated input entering rank-local compute;
    forward the identity, backward the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the ranks' partial sums into the replicated sum;
    backward the identity."""
    return _Psum.apply(x, group, 1)


def _local_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    return x.chunk(n, dim)[r].contiguous()


class _GatherFrom(torch.autograd.Function):
    """Concatenate every rank's slice along ``dim`` (group-rank order)
    into the replicated whole; backward keeps this rank's slice of the
    replicated cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = all_gather(x, group)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _local_slice(g, ctx.group, ctx.dim), None, None


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, group, dim % x.dim())


class _ScatterTo(torch.autograd.Function):
    """This rank's slice along ``dim`` of a replicated value; backward
    gathers the ranks' cotangents into the replicated one."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _local_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        parts = all_gather(g.contiguous(), ctx.group)
        return torch.cat(parts.unbind(0), dim=ctx.dim), None, None


def scatter_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ScatterTo.apply(x, group, dim % x.dim())


def flat_bucket(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat buffer of ``tensors`` (one dtype, one device)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_into(bucket: torch.Tensor,
                   tensors: Sequence[torch.Tensor]) -> None:
    """Copy ``bucket`` back into ``tensors`` in place."""
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(bucket[offset:offset + n].view_as(t))
            offset += n

