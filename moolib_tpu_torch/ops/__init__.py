"""Ops of the port: attention, V-trace, the Batcher and batch staging."""

from . import attention, vtrace
from .batcher import Batcher, stage_batch

__all__ = ["Batcher", "attention", "stage_batch", "vtrace"]
