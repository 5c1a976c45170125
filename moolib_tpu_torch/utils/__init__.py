"""Utilities of the port."""

from . import nest
from .checkpoint import (
    CheckpointError,
    Checkpointer,
    load_checkpoint,
    save_checkpoint,
)
from .device import resolve_device
from .logging import get_logger, set_log_level, set_logging
from .quantile import RollingQuantile
from .staging import HostStaged, stage_host_async
from .stats import StatMax, StatMean, StatSum, Stats
from .timer import Ewma, Timer

__all__ = [
    "CheckpointError",
    "Checkpointer",
    "Ewma",
    "HostStaged",
    "RollingQuantile",
    "StatMax",
    "StatMean",
    "StatSum",
    "Stats",
    "Timer",
    "get_logger",
    "load_checkpoint",
    "nest",
    "resolve_device",
    "save_checkpoint",
    "set_log_level",
    "set_logging",
    "stage_host_async",
]
