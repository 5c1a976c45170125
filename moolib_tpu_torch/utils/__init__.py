"""Utilities of the port."""

from . import nest
from .device import resolve_device
from .quantile import RollingQuantile

__all__ = ["RollingQuantile", "nest", "resolve_device"]
