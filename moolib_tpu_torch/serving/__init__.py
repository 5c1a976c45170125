"""Serving tier of the port: admission control, the replica (in-process
or bound to an RPC peer), health gating and the router; the counterpart
of :mod:`moolib_tpu.serving`. ``publish_from_statestore`` waits for the
port's StateStore."""

from ..rpc import RpcError
from .admission import (
    AdmissionQueue,
    DeadlineExceeded,
    Overloaded,
    ServingError,
    error_kind,
)
from .health import CircuitBreaker, ReplicaHealth
from .replica import ENDPOINT_SUFFIXES, Replica
from .router import Router, publish_from_accumulator

__all__ = [
    "AdmissionQueue",
    "CircuitBreaker",
    "DeadlineExceeded",
    "ENDPOINT_SUFFIXES",
    "Overloaded",
    "Replica",
    "ReplicaHealth",
    "Router",
    "RpcError",
    "ServingError",
    "error_kind",
    "publish_from_accumulator",
]
