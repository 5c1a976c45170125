"""Leveled logging; the counterpart of :mod:`moolib_tpu.utils.logging`
(the reference's ``set_logging``/``set_log_level``), under the
``moolib_tpu_torch`` logger namespace.
"""

from __future__ import annotations

import logging

_LOGGER = logging.getLogger("moolib_tpu_torch")

_LEVELS = {
    "none": logging.CRITICAL + 10,
    "error": logging.ERROR,
    "info": logging.INFO,
    "verbose": logging.DEBUG,
    "debug": logging.DEBUG,
}


def get_logger(name: str | None = None) -> logging.Logger:
    return _LOGGER.getChild(name) if name else _LOGGER


def set_log_level(level: str) -> None:
    """Set framework log level by name (none/error/info/verbose/debug)."""
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level!r}; one of {sorted(_LEVELS)}")
    _LOGGER.setLevel(_LEVELS[level])


def set_logging(enabled: bool = True) -> None:
    """Enable/disable emitting framework logs to the root handlers."""
    _LOGGER.propagate = bool(enabled)
    if enabled and not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        )
