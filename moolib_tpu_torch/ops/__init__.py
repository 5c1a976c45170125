"""Ops of the port: attention, ring attention, V-trace, the Batcher and
batch staging."""

from . import attention, ring_attention, vtrace
from .batcher import Batcher, stage_batch

__all__ = ["Batcher", "attention", "ring_attention", "stage_batch", "vtrace"]
