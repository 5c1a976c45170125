"""Running statistics used by the training loops; a copy of
:mod:`moolib_tpu.utils.stats` (pure Python).

Capability parity with the reference's ``StatMean``/``StatSum`` and the
cluster-wide stats machinery (reference: examples/common/__init__.py:23-121).
The cross-peer aggregation path (``GlobalStatsAccumulator``) lives in
``moolib_tpu_torch.parallel.stats`` because it depends on the group
allreduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

__all__ = ["StatMean", "StatSum", "StatMax", "Stats"]


@dataclasses.dataclass
class StatSum:
    value: float = 0.0

    def __iadd__(self, v):
        self.value += float(v)
        return self

    def result(self):
        return self.value

    def reset(self):
        # Sums are never reset on read; they accumulate for the whole run
        # (reference: examples/common/__init__.py:34-40).
        pass

    def diff(self, other: "StatSum") -> float:
        return self.value - other.value

    def merge(self, delta: float):
        self.value += delta


@dataclasses.dataclass
class StatMean:
    sum: float = 0.0
    count: float = 0.0
    cumulative: bool = False

    def __iadd__(self, v):
        self.sum += float(v)
        self.count += 1.0
        return self

    def add(self, v, count: float = 1.0):
        self.sum += float(v)
        self.count += count

    def result(self):
        if self.count == 0:
            return float("nan")
        return self.sum / self.count

    def reset(self):
        if not self.cumulative:
            self.sum = 0.0
            self.count = 0.0

    def diff(self, other: "StatMean"):
        return (self.sum - other.sum, self.count - other.count)

    def merge(self, delta):
        dsum, dcount = delta
        self.sum += dsum
        self.count += dcount


@dataclasses.dataclass
class StatMax:
    value: float = -math.inf

    def __iadd__(self, v):
        self.value = max(self.value, float(v))
        return self

    def result(self):
        return self.value if self.value != -math.inf else float("nan")

    def reset(self):
        pass

    def diff(self, other: "StatMax") -> float:
        return self.value

    def merge(self, delta: float):
        self.value = max(self.value, delta)


class Stats(dict):
    """A dict of named stat objects with convenience accessors."""

    def results(self) -> Dict[str, float]:
        return {k: v.result() for k, v in self.items()}

    def reset(self):
        for v in self.values():
            v.reset()
