"""Ops of the port: attention and batch staging."""

from . import attention
from .batcher import stage_batch

__all__ = ["attention", "stage_batch"]
