"""Asynchronous device-to-host staging; the torch form of the
reference's ``stage_host_async`` (``moolib_tpu/utils/__init__.py:33-54``,
which starts jax's ``copy_to_host_async`` on every device leaf).

A card tensor's copy goes into **pinned** host memory with
``non_blocking=True`` on the tensor's current stream, followed by a CUDA
event: the training thread enqueues both and returns. A copy into
pageable memory would be synchronous, and the host buffer holds stale
bytes until the event completes, so the host side is reached only
through :meth:`HostStaged.result` (which waits for the event) and polled
through :meth:`HostStaged.is_ready` (which never waits). The copy runs
on the tensor's own stream, after the work that produced it, so the
caching allocator cannot hand the tensor's memory to later work before
the copy has read it.
"""

from __future__ import annotations

from typing import Any

import torch

from . import nest

__all__ = ["HostStaged", "stage_host_async"]


class HostStaged:
    """A card tensor's copy on its way into pinned host memory."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event: "torch.cuda.Event"):
        self.host = host
        self.event = event

    @property
    def shape(self) -> torch.Size:
        return self.host.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.host.dtype

    def is_ready(self) -> bool:
        """Whether the copy has landed; never waits."""
        return self.event.query()

    def result(self) -> torch.Tensor:
        """The host tensor, once the copy has landed (waits for it only
        while it has not)."""
        if not self.event.query():
            self.event.synchronize()
        return self.host


def _stage(x):
    if not (isinstance(x, torch.Tensor) and x.device.type == "cuda"):
        return x
    x = x.detach()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return HostStaged(host, event)


def stage_host_async(tree: Any) -> Any:
    """Start (but do not wait for) the device-to-host copy of every CUDA
    tensor leaf of ``tree``; returns a tree of the same structure in
    which each CUDA leaf is a :class:`HostStaged` and every other leaf is
    unchanged. The Accumulator stages gradient bundles with it and turns
    them into host arrays later, off the training thread."""
    return nest.map_structure(_stage, tree)
