"""Windowed quantile estimate: a re-export of the registry's
:class:`~moolib_tpu_torch.telemetry.registry.RollingQuantile` (the
counterpart of :class:`moolib_tpu.telemetry.registry.RollingQuantile`),
kept at this path for its importers."""

from ..telemetry.registry import RollingQuantile

__all__ = ["RollingQuantile"]
