"""Benchmark plumbing of the port: the result schema of
:mod:`moolib_tpu.bench.harness` that step-phase trend rows use."""

from .harness import SCHEMA_VERSION, BenchResult, env_fingerprint, parse_result

__all__ = ["SCHEMA_VERSION", "BenchResult", "env_fingerprint", "parse_result"]
