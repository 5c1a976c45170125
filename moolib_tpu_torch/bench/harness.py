"""One result schema for benchmark rows; the part of
:mod:`moolib_tpu.bench.harness` that step-phase trend rows
(:func:`~moolib_tpu_torch.telemetry.stepscope.trend_rows`) need:
:class:`BenchResult`, its schema version, :func:`env_fingerprint` and
:func:`parse_result`. The timing protocol and the trend-store writers are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import platform
import time
from typing import Any, Dict, Optional

__all__ = [
    "SCHEMA_VERSION",
    "BenchResult",
    "env_fingerprint",
    "parse_result",
]

SCHEMA_VERSION = 1


def env_fingerprint() -> Dict[str, Any]:
    """Where a row came from: enough to tell two hosts/configs apart when
    reading a trend file, cheap enough to stamp on every row. Reads
    torch's version from package metadata: no import of torch, and no
    CUDA initialization."""
    fp: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "machine": platform.machine(),
        "host": platform.node(),
        "cpus": os.cpu_count(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
    }
    try:  # version metadata only — no import, no CUDA init
        from importlib.metadata import version

        fp["torch"] = version("torch")
    except Exception:
        fp["torch"] = None
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
    #: shared CI hosts (ms-scale CPU-bound throughputs) declare their
    #: OBSERVED run-to-run variance here, so the trend gate catches
    #: structural slowdowns without crying wolf — a gate that flakes
    #: gets deleted. Quiet metrics leave it unset and keep the tight
    #: default band.
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
