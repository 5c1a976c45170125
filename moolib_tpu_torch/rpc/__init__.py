"""The RPC core of the port: named peers, the wire codec, the transports
(tcp, unix, the same-host shm lane), the broker, and the group
membership view with its tree allreduce; the counterpart of
:mod:`moolib_tpu.rpc`, wire-compatible with it."""

from .group import AllReduce, Group
from .rpc import Future, Queue, Rpc, RpcDeferredReturn, RpcError

__all__ = [
    "AllReduce",
    "Future",
    "Group",
    "Queue",
    "Rpc",
    "RpcDeferredReturn",
    "RpcError",
    "Broker",
]


def __getattr__(name):
    # The Broker lives in its own module (built on Rpc).
    if name == "Broker":
        from .broker import Broker

        return Broker
    raise AttributeError(
        f"module 'moolib_tpu_torch.rpc' has no attribute {name!r}"
    )
