"""Utilities of the port.

Imports are lazy: an env worker of the EnvPool reads the logger from
here and must not pay for torch, which most of these modules import."""

import importlib

_EXPORTS = {
    **dict.fromkeys(("CheckpointError", "Checkpointer", "load_checkpoint",
                     "save_checkpoint"), "checkpoint"),
    "resolve_device": "device",
    **dict.fromkeys(("get_logger", "set_log_level", "set_logging"),
                    "logging"),
    "RollingQuantile": "quantile",
    **dict.fromkeys(("StepWindowProfiler", "profile_trace"), "profiling"),
    **dict.fromkeys(("HostStaged", "stage_host_async"), "staging"),
    **dict.fromkeys(("StatMax", "StatMean", "StatSum", "Stats"), "stats"),
    **dict.fromkeys(("Ewma", "Timer"), "timer"),
}

__all__ = sorted([*_EXPORTS, "nest"])


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    if name == "nest":
        return importlib.import_module(f"{__name__}.nest")
    raise AttributeError(
        f"module 'moolib_tpu_torch.utils' has no attribute {name!r}")
