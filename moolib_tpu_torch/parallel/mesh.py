"""Device-mesh utilities on ``torch.distributed``: the counterpart of
:mod:`moolib_tpu.parallel.mesh`.

One process per device: a ``(dp, tp, sp, pp, ep)`` ``DeviceMesh`` over
the ranks of the default process group, whose axes are:

- ``dp``: data parallel (the gradient all-reduce rides here);
- ``tp``: tensor parallel (Megatron-sharded parameters, ``parallel/tp.py``);
- ``sp``: sequence parallel (ring/zigzag attention);
- ``pp``: pipeline parallel (``parallel/pipeline.py``);
- ``ep``: expert parallel (``moe_ffn_sharded``).

A PartitionSpec is a tuple of axis names (or ``None``) per tensor
dimension, as ``jax.sharding.PartitionSpec`` holds them: ``(None,
"dp")`` shards dimension 1 over ``dp``. :func:`shard_batch` takes this
rank's slice of a global batch by it, and :func:`placements` turns it
into ``DTensor`` placements.

The reference's ``jax.grad`` inside ``shard_map`` sums the gradients of
replicated parameters over the axis; here every rank's backward gives
its own, and :func:`psum_gradients` / :func:`dp_average_grads` reduce
them, one flat bucket per dtype per call.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils import nest
from ..utils.device import resolve_device
from . import collectives

__all__ = [
    "AXES",
    "make_mesh",
    "data_parallel_spec",
    "replicated_spec",
    "psum_gradients",
    "pmean_gradients",
    "dp_average_grads",
    "shard_batch",
    "batch_leaf_spec",
    "batch_specs",
    "placements",
    "local_value",
]

AXES = ("dp", "tp", "sp", "pp", "ep")


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, ep: int = 1, *,
              device: Optional[Union[str, torch.device]] = None):
    """Build a (dp, tp, sp, pp, ep) ``DeviceMesh`` over every rank of the
    default process group, on ``device``'s type (the card unless the
    caller asks for the CPU).

    ``dp`` defaults to "whatever is left": n // (tp * sp * pp * ep).
    Ranks fill the mesh in row-major order, as the reference reshapes
    its device list."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = resolve_device(device).type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(moolib_tpu_torch.parallel.distributed."
                           "initialize)")
    n = dist.get_world_size()
    rest = tp * sp * pp * ep
    if dp is None:
        if n % rest != 0:
            raise ValueError(
                f"{n} devices not divisible by tp*sp*pp*ep={rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(
            f"mesh {dp}x{tp}x{sp}x{pp}x{ep} needs {dp * rest} devices, "
            f"have {n}")
    ranks = torch.arange(n).reshape(dp, tp, sp, pp, ep)
    return DeviceMesh(kind, ranks, mesh_dim_names=AXES)


def data_parallel_spec() -> Tuple:
    """Batch-dim sharding over dp (time-major [T, B, ...]: axis 1)."""
    return (None, "dp")


def replicated_spec() -> Tuple:
    return ()


def batch_leaf_spec(x, batch_axis: int = 1, axis_name: str = "dp") -> Tuple:
    """The spec sharding ``batch_axis`` of one leaf over ``axis_name``;
    leaves with too few dims (scalars, per-step vectors) replicate."""
    nd = np.ndim(x) if not torch.is_tensor(x) else x.dim()
    if nd <= batch_axis:
        return ()
    spec = [None] * nd
    spec[batch_axis] = axis_name
    return tuple(spec)


def _resolve_batch_axes(batch_axes: Optional[dict], batch_axis: int) -> dict:
    """Per-key batch axes, shared by :func:`batch_specs` and
    :func:`shard_batch`: ``core_state`` leaves are [B, ...] (axis 0)."""
    axes = dict(batch_axes or {})
    axes.setdefault("core_state", 0)
    return axes


def batch_specs(batch: dict, batch_axes: Optional[dict] = None,
                axis_name: str = "dp", batch_axis: int = 1) -> dict:
    """Per-leaf specs of a learn-batch dict: ``batch_axes`` maps
    top-level keys to the axis carrying the batch dim; the default is
    ``batch_axis`` except for ``core_state`` (axis 0)."""
    axes = _resolve_batch_axes(batch_axes, batch_axis)
    return {
        k: nest.map_structure(
            lambda x, a=axes.get(k, batch_axis): batch_leaf_spec(
                x, a, axis_name), v)
        for k, v in batch.items()
    }


def placements(mesh, spec: Tuple) -> list:
    """``DTensor`` placements on ``mesh`` of a spec: ``Shard(d)`` on the
    mesh axis that dimension ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    for d, name in enumerate(spec):
        if name is not None:
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


def local_value(x):
    """A ``DTensor``'s local shard; anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _take_shard(mesh, x, spec: Tuple):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    for d, name in enumerate(spec):
        if name is None:
            continue
        n, r = mesh.size(mesh.mesh_dim_names.index(name)), \
            mesh.get_local_rank(name)
        if x.shape[d] % n:
            raise ValueError(f"batch dim {d} of {tuple(x.shape)} does not "
                             f"split {n} ways over {name!r}")
        x = x.chunk(n, d)[r]
    return x


def shard_batch(mesh, batch, batch_axis: int = 1,
                batch_axes: Optional[dict] = None, axis_name: str = "dp"):
    """This rank's slice of a global host batch along its batch axes
    over ``axis_name`` (views, no copy). For a top-level dict the
    per-key axes follow :func:`batch_specs` (``core_state`` on axis 0);
    any other tree shards every leaf on ``batch_axis``. A ``DTensor``
    leaf (:func:`~moolib_tpu_torch.parallel.distributed.
    host_local_batch_to_global`) gives its local shard."""
    if isinstance(batch, dict):
        axes = _resolve_batch_axes(batch_axes, batch_axis)
        return {
            k: nest.map_structure(
                lambda x, a=axes.get(k, batch_axis): _take_shard(
                    mesh, x, batch_leaf_spec(x, a, axis_name)), v)
            for k, v in batch.items()
        }
    return nest.map_structure(
        lambda x: _take_shard(mesh, x, batch_leaf_spec(x, batch_axis,
                                                       axis_name)), batch)


def _reduce(tree, mesh, axis_name: str, mean: bool):
    """All-reduce the leaves of ``tree`` (values, no graph) over the
    axis, one flat bucket per dtype; ``DTensor`` leaves reduce their
    local shards and keep their placements."""
    from torch.distributed.tensor import DTensor

    group = collectives.axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    leaves = nest.flatten(tree)
    local = [local_value(x).detach() for x in leaves]
    out = list(local)
    by_dtype: dict = {}
    for i, t in enumerate(local):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        bucket = collectives.flat_bucket([local[i] for i in idx])
        collectives.all_reduce_(bucket, group)
        if mean:
            bucket = bucket / n
        offset = 0
        for i in idx:
            k = local[i].numel()
            # In the gradient's own layout (strides): what is summed over
            # it later (the global norm) sums in the same order.
            out[i] = torch.empty_like(local[i]).copy_(
                bucket[offset:offset + k].view(local[i].shape))
            offset += k
    out = [DTensor.from_local(o, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())
           if isinstance(x, DTensor) else o for o, x in zip(out, leaves)]
    return nest.unflatten_as(tree, out)


def psum_gradients(grads, mesh, axis_name: str = "dp"):
    """The sum over the axis of every rank's value of each leaf
    (``jax.lax.psum`` of varying values): the gradients of replicated
    parameters from every rank's backward."""
    return _reduce(grads, mesh, axis_name, mean=False)


def pmean_gradients(grads, mesh, axis_name: str = "dp"):
    """The mean over the axis (per-rank losses and metrics)."""
    return _reduce(grads, mesh, axis_name, mean=True)


def dp_average_grads(grads, mesh, axis_name: str = "dp"):
    """Every rank's gradients of its local mean loss into the global-mean
    gradients: the sum over the axis divided by its size (with equal
    local batches, the gradient of the mean loss over the global batch).
    The canonical data-parallel step::

        loss, grads = local_mean_loss_and_grads(model, local_batch)
        grads = dp_average_grads(grads, mesh)       # global mean
        metrics = pmean_gradients(metrics, mesh)
    """
    return _reduce(grads, mesh, axis_name, mean=True)
