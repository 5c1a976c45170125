"""Ops of the port: attention, V-trace and batch staging."""

from . import attention, vtrace
from .batcher import stage_batch

__all__ = ["attention", "stage_batch", "vtrace"]
