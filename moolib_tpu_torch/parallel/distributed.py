"""Multi-process bring-up on ``torch.distributed``: the counterpart of
:mod:`moolib_tpu.parallel.distributed`.

One process per device. :func:`initialize` joins the default process
group, :func:`global_mesh` lays a mesh over all of its ranks, and
:func:`host_local_batch_to_global` turns every process's own rollouts
into one global batch sharded over ``dp`` where it was produced (the
reference's per-host EnvPool feeding one model)::

    from moolib_tpu_torch.parallel import distributed as dist
    dist.initialize("127.0.0.1:29500", num_processes=2, process_id=rank,
                    backend="nccl")
    mesh = dist.global_mesh()
    batch = dist.host_local_batch_to_global(mesh, local_batch)
    state, metrics = train_step(state, batch)   # make_impala_train_step(mesh=mesh)

Nothing here discovers a cluster: the caller gives the address, the
world size, this process's rank and the backend (``"nccl"`` for card
tensors, ``"gloo"`` for host tensors).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as torch_dist

from ..utils import nest
from ..utils.logging import get_logger
from .mesh import _resolve_batch_axes, batch_leaf_spec, make_mesh, placements

log = get_logger("distributed")

__all__ = [
    "initialize",
    "is_initialized",
    "global_mesh",
    "host_local_batch_to_global",
    "process_count",
    "process_index",
]

BACKENDS = ("nccl", "gloo")


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str) -> None:
    """Join the default process group (idempotent: a second call with the
    same world returns). ``coordinator_address`` is ``host:port`` (rank
    0 listens there), ``tcp://host:port`` or ``file:///path``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if torch_dist.is_initialized():
        have = (torch_dist.get_world_size(), torch_dist.get_rank(),
                torch_dist.get_backend())
        if have != (num_processes, process_id, backend):
            raise RuntimeError(f"the process group is already up as "
                               f"(world, rank, backend) {have}")
        return
    torch_dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id)
    log.info("torch.distributed up: process %d/%d over %s", process_id,
             num_processes, backend)


def is_initialized() -> bool:
    return torch_dist.is_initialized()


def process_count() -> int:
    return torch_dist.get_world_size() if torch_dist.is_initialized() else 1


def process_index() -> int:
    return torch_dist.get_rank() if torch_dist.is_initialized() else 0


def global_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, *,
                device: Optional[Union[str, torch.device]] = None):
    """A mesh over every rank of the process group (every process calls
    it with the same arguments)."""
    return make_mesh(dp=dp, tp=tp, sp=sp, device=device)


def host_local_batch_to_global(mesh, batch, batch_axis: int = 1,
                               batch_axes: Optional[dict] = None):
    """Each process's LOCAL batch as one global batch: every leaf with a
    batch axis becomes a ``DTensor`` sharded over ``dp`` on that axis
    (global size = local size x dp), its shard the local tensor, where it
    was produced; leaves without one are replicated. No data moves."""
    from torch.distributed.tensor import DTensor

    axes = _resolve_batch_axes(batch_axes, batch_axis)

    def leaf(x, a):
        if not torch.is_tensor(x):
            x = torch.as_tensor(x)
        return DTensor.from_local(x, mesh,
                                  placements(mesh, batch_leaf_spec(x, a)),
                                  run_check=False)

    if isinstance(batch, dict):
        return {k: nest.map_structure(
                    lambda x, a=axes.get(k, batch_axis): leaf(x, a), v)
                for k, v in batch.items()}
    return nest.map_structure(lambda x: leaf(x, batch_axis), batch)
