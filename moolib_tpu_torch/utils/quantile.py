"""Windowed quantile estimate; the counterpart of
:class:`moolib_tpu.telemetry.registry.RollingQuantile`."""

from __future__ import annotations

import threading
from typing import List, Optional

__all__ = ["RollingQuantile"]


class RollingQuantile:
    """Quantile over the last ``window`` observations.

    A control decision (shedding on the observed p50 service time) must
    track the current regime, so this is a ring buffer rather than a
    cumulative histogram: one slow first batch does not inflate the
    estimate for the life of the process. O(1) observe, O(window log
    window) quantile on a copied snapshot, thread-safe."""

    __slots__ = ("_lock", "_ring", "_idx", "_window")

    def __init__(self, window: int = 128):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window!r}")
        self._window = int(window)
        self._lock = threading.Lock()
        self._ring: List[float] = []
        self._idx = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:  # NaN: unordered, would poison the sort
            return
        with self._lock:
            if len(self._ring) < self._window:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self._window

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile of the window; ``None`` while empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q!r}")
        with self._lock:
            vals = list(self._ring)
        if not vals:
            return None
        vals.sort()
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
