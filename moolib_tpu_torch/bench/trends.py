"""perfwatch trend store + regression detector of the port: a careful copy
of :mod:`moolib_tpu.bench.trends` (pure Python), so both packages give
the same verdicts on the same rows.

The store is an append-only JSONL file (one :class:`~.harness.BenchResult`
row per line — ``bench/trends.jsonl`` by convention, uploaded as a CI
artifact so history accretes across runs). Append-only is the point: a
regression is visible as a step in the series, never hidden by an
overwrite, and null rows (``value: null``: a benchmark that could not
run) stay on the record.

The detector is deliberately noise-aware: CI hosts are noisy, and a perf
gate that cries wolf gets deleted. Each metric's latest value is compared
against the **median of a trailing window** of prior runs, and only flagged
outside a tolerance band that is the *wider* of a relative tolerance and a
robust noise estimate (MAD-derived sigma) of that window — so a metric
whose history itself jitters ±10% needs a correspondingly larger step to
flag, while a historically quiet metric is caught by the relative band.
Every flag carries the row's reproduce command.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Any, Dict, List, Tuple, Union

from .harness import BenchResult, parse_result

__all__ = [
    "Regression",
    "append_trend",
    "detect_regressions",
    "load_trends",
]

#: MAD -> sigma for normal noise; the detector's band uses
#: ``NOISE_SIGMAS * 1.4826 * MAD`` as its robust-noise arm.
_MAD_TO_SIGMA = 1.4826
NOISE_SIGMAS = 4.0


def append_trend(path: str, result: Union[BenchResult, Dict[str, Any]]) -> None:
    """Append one result row. The row is schema-validated by round-trip
    *before* the write — a malformed row must fail the producer, not every
    future reader of the store."""
    if isinstance(result, BenchResult):
        row = result
    else:
        row = parse_result(result)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(row.to_json() + "\n")


def load_trends(path: str) -> List[BenchResult]:
    """Read every row, in append order. Unparseable lines raise — the
    store is machine-written; silent skipping would turn a producer bug
    into a quietly shrinking history."""
    out: List[BenchResult] = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(parse_result(line))
            except (json.JSONDecodeError, ValueError, TypeError) as e:
                raise ValueError(f"{path}:{lineno}: bad trend row: {e}")
    return out


@dataclasses.dataclass
class Regression:
    """One flagged metric: the latest value fell outside the tolerance
    band around the trailing-window median, in the bad direction."""

    metric: str
    direction: str
    baseline: float   # median of the trailing window
    current: float
    band: float       # absolute half-width the value had to clear
    ratio: float      # current / baseline
    n_history: int
    cmd: str          # reproduce command from the offending row

    def message(self) -> str:
        verb = "dropped" if self.direction == "higher" else "rose"
        return (
            f"{self.metric}: {verb} to {self.current:.6g} vs trailing "
            f"median {self.baseline:.6g} over {self.n_history} run(s) "
            f"(ratio {self.ratio:.3f}, tolerance band ±{self.band:.6g}); "
            f"reproduce: {self.cmd or '<no cmd recorded>'}"
        )


def _series(rows: List[BenchResult]) -> Dict[Tuple[str, bool], List[BenchResult]]:
    """Group usable rows by (metric, smoke) — smoke reps/sizes differ from
    full runs, so the two must never share a baseline."""
    out: Dict[Tuple[str, bool], List[BenchResult]] = {}
    for r in rows:
        if r.error is not None or r.value is None:
            continue  # null artifacts stay on record but carry no value
        out.setdefault((r.metric, bool(r.smoke)), []).append(r)
    return out


def detect_regressions(
    rows: List[BenchResult],
    *,
    window: int = 8,
    min_history: int = 3,
    tolerance: float = 0.15,
    noise_sigmas: float = NOISE_SIGMAS,
) -> List[Regression]:
    """Compare each metric's latest row against its trailing history.

    For a series ``v[0..n]`` (append order), the baseline is
    ``median(v[n-window-1 .. n-1])`` and the band is
    ``max(tol * |baseline|, noise_sigmas * 1.4826 * MAD(window))`` where
    ``tol`` is the latest row's declared per-metric tolerance
    (:attr:`~.harness.BenchResult.tol`) or the ``tolerance`` default.
    The latest value flags only when it clears the band in the bad
    direction (below for ``direction="higher"`` throughputs, above for
    ``"lower"`` latencies). Fewer than ``min_history`` prior runs — no
    verdict (a gate must not fire off one noisy sample)."""
    found: List[Regression] = []
    for (metric, _smoke), series in sorted(_series(rows).items()):
        if len(series) < min_history + 1:
            continue
        latest = series[-1]
        hist = [float(r.value) for r in series[-(window + 1):-1]]
        baseline = statistics.median(hist)
        mad = statistics.median(abs(v - baseline) for v in hist)
        tol = latest.tol if latest.tol is not None else tolerance
        band = max(
            tol * abs(baseline), noise_sigmas * _MAD_TO_SIGMA * mad
        )
        cur = float(latest.value)
        if latest.direction == "higher":
            bad = cur < baseline - band
        else:
            bad = cur > baseline + band
        if bad:
            found.append(Regression(
                metric=metric,
                direction=latest.direction,
                baseline=baseline,
                current=cur,
                band=band,
                ratio=cur / baseline if baseline else float("inf"),
                n_history=len(hist),
                cmd=latest.cmd,
            ))
    return found
