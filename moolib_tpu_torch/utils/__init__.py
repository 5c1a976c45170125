"""Utilities of the port."""

from . import nest
from .device import resolve_device
from .logging import get_logger, set_log_level, set_logging
from .quantile import RollingQuantile

__all__ = [
    "RollingQuantile",
    "get_logger",
    "nest",
    "resolve_device",
    "set_log_level",
    "set_logging",
]
