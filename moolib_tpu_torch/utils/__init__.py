"""Utilities of the port."""

from . import nest
from .device import resolve_device
from .logging import get_logger, set_log_level, set_logging
from .quantile import RollingQuantile
from .timer import Ewma, Timer

__all__ = [
    "Ewma",
    "RollingQuantile",
    "Timer",
    "get_logger",
    "nest",
    "resolve_device",
    "set_log_level",
    "set_logging",
]
