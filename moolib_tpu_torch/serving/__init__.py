"""Serving tier of the port: admission control and the replica."""

from .admission import (
    AdmissionQueue,
    DeadlineExceeded,
    Overloaded,
    RpcError,
    ServingError,
    error_kind,
)
from .replica import Replica

__all__ = [
    "AdmissionQueue",
    "DeadlineExceeded",
    "Overloaded",
    "Replica",
    "RpcError",
    "ServingError",
    "error_kind",
]
