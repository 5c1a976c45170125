"""Monotonic timer + simple EWMA latency tracker; the counterpart of
:mod:`moolib_tpu.utils.timer` (the RPC transport bandit's per-transport
latency estimate reads the EWMA).
"""

from __future__ import annotations

import time

__all__ = ["Timer", "Ewma"]


class Timer:
    def __init__(self):
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def elapsed_reset(self) -> float:
        now = time.monotonic()
        dt = now - self._start
        self._start = now
        return dt

    def reset(self):
        self._start = time.monotonic()


class Ewma:
    """Exponentially weighted moving average with warmup-corrected bias."""

    def __init__(self, alpha: float = 0.25):
        self.alpha = alpha
        self._value = 0.0
        self._weight = 0.0

    def add(self, x: float):
        self._value = (1 - self.alpha) * self._value + self.alpha * x
        self._weight = (1 - self.alpha) * self._weight + self.alpha

    @property
    def value(self) -> float:
        if self._weight == 0.0:
            return 0.0
        return self._value / self._weight
