"""perfwatch harness of the port: one timing protocol, one result schema;
the counterpart of :mod:`moolib_tpu.bench.harness`.

Every number the port's benchmarks quote goes through this module's
protocol and leaves as one machine-readable row:

- **protocol**: ``warmup`` untimed reps, then ``repeats`` timed reps on
  :data:`clock` (``time.perf_counter``), summarized by
  :func:`trimmed_stats` so one GC pause or scheduler hiccup cannot move
  the headline value;
- **schema**: :class:`BenchResult` (the reference's fields, so a row
  written by either package parses with the other's
  :func:`parse_result`), stamped with :func:`env_fingerprint`;
- **trend plumbing**: :func:`maybe_append_trend` appends rows to the
  append-only JSONL store named by ``MOOLIB_TRENDS`` (or an explicit
  path); :func:`append_device_trend` is its one-call form for the card
  benchmarks (``bench_torch.py``, ``bench_e2e_torch.py``,
  ``bench_allreduce_torch.py`` and the ``tools/`` benches).

The card-side primitives (``time_train_step``, ``time_chained`` and the
device guards ``wait_for_device``, ``install_watchdog``) live in
:mod:`moolib_tpu_torch.utils.benchmark`; this
module re-exports them, as the reference's does (one import surface for
benchmark authors), but resolves them only when first asked for:
importing this module imports no torch.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import platform
import shutil
import statistics
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "SCHEMA_VERSION",
    "BenchResult",
    "append_device_trend",
    "clock",
    "env_fingerprint",
    "install_watchdog",
    "maybe_append_trend",
    "measure",
    "parse_result",
    "time_chained",
    "time_train_step",
    "trimmed_stats",
    "wait_for_device",
]

#: Names re-exported from :mod:`moolib_tpu_torch.utils.benchmark`, which
#: imports torch: resolved on first access.
_DEVICE_PROTOCOL = ("install_watchdog", "time_chained", "time_train_step",
                    "wait_for_device")


def __getattr__(name: str):
    if name in _DEVICE_PROTOCOL:
        from ..utils import benchmark

        return getattr(benchmark, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

SCHEMA_VERSION = 1

#: THE harness timer: durations are measured with this (or the card-side
#: helpers), never ``time.time()``, whose steps corrupt short intervals.
clock: Callable[[], float] = time.perf_counter


def trimmed_stats(samples: List[float], trim: float = 0.2) -> Dict[str, Any]:
    """Order statistics over per-rep samples, with a symmetric trimmed
    mean (``trim`` total fraction dropped, split between both tails) so a
    single outlier rep cannot move the headline value. Median is the
    recommended ``value`` source; everything else is for the record."""
    if not samples:
        raise ValueError("no samples")
    if not 0.0 <= trim < 1.0:
        raise ValueError(f"trim must be in [0, 1), got {trim}")
    s = sorted(float(x) for x in samples)
    k = int(len(s) * trim / 2)
    core = s[k:len(s) - k] if k else s
    return {
        "n": len(s),
        "trim": trim,
        "mean": statistics.fmean(s),
        "trimmed_mean": statistics.fmean(core),
        "median": statistics.median(s),
        "min": s[0],
        "max": s[-1],
        "stdev": statistics.stdev(s) if len(s) > 1 else 0.0,
        "samples": [round(x, 9) for x in s],
    }


def measure(
    fn: Callable[[], Any], *, warmup: int = 1, repeats: int = 5
) -> List[float]:
    """The shared rep loop: ``warmup`` untimed calls, then ``repeats``
    calls each timed with :data:`clock`. Returns per-rep seconds (feed to
    :func:`trimmed_stats`)."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(repeats):
        t0 = clock()
        fn()
        out.append(clock() - t0)
    return out


@functools.lru_cache(maxsize=1)
def _card() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    None on a host without nvidia-smi (read once per process; no CUDA
    initialization)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


@functools.lru_cache(maxsize=1)
def _torch_version() -> Optional[str]:
    """torch's version from package metadata (read once per process):
    no import, no CUDA init."""
    try:
        from importlib.metadata import version

        return version("torch")
    except Exception:
        return None


def env_fingerprint() -> Dict[str, Any]:
    """Where a row came from: enough to tell two hosts/configs apart when
    reading a trend file, cheap enough to stamp on every row. torch's
    version comes from package metadata and its CUDA version from the
    loaded module (None when torch is not imported yet): no import of
    torch, and no CUDA initialization. ``card`` is the card's name and
    power limit where the host has one."""
    fp: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "machine": platform.machine(),
        "host": platform.node(),
        "cpus": os.cpu_count(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    }
    fp["torch"] = _torch_version()
    torch = sys.modules.get("torch")
    fp["cuda"] = getattr(getattr(torch, "version", None), "cuda", None)
    fp["card"] = _card()
    return fp


@dataclasses.dataclass
class BenchResult:
    """One benchmark outcome in the unified schema.

    ``direction`` tells the regression detector which way is bad:
    ``"higher"`` for throughputs (a drop regresses), ``"lower"`` for
    latencies (a rise regresses). ``cmd`` is the reproduce command a CI
    failure prints. ``telemetry`` is a registry snapshot taken right
    after the timed reps (histogram series carry p50/p95/p99 — the
    budget layer reads those). ``value`` is ``None`` with ``error`` set
    when the benchmark could not run."""

    metric: str
    value: Optional[float]
    unit: str
    direction: str = "higher"
    suite: str = ""
    smoke: bool = False
    cmd: str = ""
    #: Per-metric relative trend tolerance override (None -> the
    #: detector's default). Benchmarks that are inherently noisy on
    #: shared hosts declare their OBSERVED run-to-run variance here, so
    #: the trend gate catches structural slowdowns without crying wolf.
    tol: Optional[float] = None
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    env: Dict[str, Any] = dataclasses.field(default_factory=env_fingerprint)
    telemetry: Optional[Dict[str, Any]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    error: Optional[str] = None
    t: float = dataclasses.field(default_factory=time.time)  # wall stamp
    schema: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.direction not in ("higher", "lower"):
            raise ValueError(f"bad direction {self.direction!r}")
        if self.value is not None and not math.isfinite(float(self.value)):
            raise ValueError(f"{self.metric}: non-finite value {self.value}")
        if self.tol is not None and not 0.0 < self.tol < 1.0:
            raise ValueError(f"{self.metric}: tol must be in (0, 1)")

    def to_row(self) -> Dict[str, Any]:
        """Plain-JSON dict — the JSONL trend-store line."""
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        """One line, strict JSON (``allow_nan=False``: a NaN that cannot
        round-trip must fail at write time, not at the reader)."""
        return json.dumps(self.to_row(), allow_nan=False)


def parse_result(row: Any) -> BenchResult:
    """Inverse of :meth:`BenchResult.to_row`/``to_json`` — the schema
    round-trip is pinned by tests (result -> JSONL -> parse -> identical)."""
    if isinstance(row, str):
        row = json.loads(row)
    if not isinstance(row, dict):
        raise ValueError(f"not a result row: {type(row).__name__}")
    if row.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"unsupported result schema {row.get('schema')!r} "
            f"(expected {SCHEMA_VERSION})"
        )
    known = {f.name for f in dataclasses.fields(BenchResult)}
    unknown = set(row) - known
    if unknown:
        raise ValueError(f"unknown result fields: {sorted(unknown)}")
    missing = {"metric", "value", "unit"} - set(row)
    if missing:
        raise ValueError(f"result row missing fields: {sorted(missing)}")
    return BenchResult(**row)


def maybe_append_trend(
    results, path: Optional[str] = None, env_var: str = "MOOLIB_TRENDS"
) -> Optional[str]:
    """Append result rows to the JSONL trend store named by ``path`` or
    ``$MOOLIB_TRENDS``; a no-op when neither is set (so the one-line-JSON
    benchmarks cost nothing outside a perfwatch run). Returns the path
    written, if any."""
    path = path or os.environ.get(env_var)
    if not path:
        return None
    from .trends import append_trend

    for r in results:
        append_trend(path, r)
    return path


def append_device_trend(
    metric: str, value: float, unit: str, cmd: str, *,
    direction: str = "higher",
    stats: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
    tol: Optional[float] = None,
) -> Optional[str]:
    """One-call trend append for the card benchmarks: builds the harness
    row (suite ``"device"``) and hands it to :func:`maybe_append_trend` —
    a no-op unless ``$MOOLIB_TRENDS`` names a store, and then it builds
    no row either (the fingerprint reads package metadata and runs
    nvidia-smi: a benchmark's parent process must not pay that, or hold
    the interpreter lock for it, when no store takes the row)."""
    if not os.environ.get("MOOLIB_TRENDS"):
        return None
    return maybe_append_trend([BenchResult(
        metric=metric, value=value, unit=unit, direction=direction,
        suite="device", cmd=cmd, stats=stats or {}, extra=extra or {},
        tol=tol,
    )])
