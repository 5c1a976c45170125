"""Import hygiene of the port: moolib_tpu_torch, chip_smoke.py,
bench_torch.py, bench_allreduce_torch.py, bench_e2e_torch.py and
bench_a2c_torch.py import
neither JAX nor anything of the JAX package, and the entry points refuse
to run on the CPU unasked."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from moolib_tpu_torch import ImpalaNet, Replica, resolve_device

REPO_ROOT = Path(__file__).resolve().parent.parent

_CHILD = r"""
import importlib, json, pkgutil, sys
import moolib_tpu_torch
import bench_torch
import bench_allreduce_torch
import bench_e2e_torch
import bench_a2c_torch
mods = [m.name for m in pkgutil.walk_packages(
    moolib_tpu_torch.__path__, "moolib_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "optax", "ml_dtypes")
             or m.startswith(("jax.", "flax.", "optax.", "ml_dtypes."))
             or m == "moolib_tpu" or m.startswith("moolib_tpu."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    """In a fresh interpreter (this one has jax loaded by conftest)."""
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "moolib_tpu_torch.ops._kernels" in got["modules"]
    assert "moolib_tpu_torch.serving.replica" in got["modules"]
    assert "moolib_tpu_torch.ops.vtrace" in got["modules"]
    assert "moolib_tpu_torch.optim" in got["modules"]
    assert "moolib_tpu_torch.learner" in got["modules"]
    for mod in ("models.impala", "models.core", "models.common",
                "utils.flops", "utils.benchmark", "utils.logging",
                "telemetry", "telemetry.registry", "telemetry.trace",
                "telemetry.stepscope", "flightrec", "flightrec.events",
                "flightrec.recorder", "flightrec.bundle", "flightrec.capture",
                "flightrec.merge", "flightrec.crawl", "bench",
                "bench.harness", "rpc", "rpc.rpc", "rpc.serial",
                "rpc.shmring", "rpc.faults", "rpc.broker", "native",
                "broker", "serving.router", "serving.health",
                "utils.timer", "rpc.group", "parallel",
                "parallel.accumulator", "parallel.stats", "utils.stats",
                "utils.staging", "utils.diskio", "utils.checkpoint",
                "envpool", "envpool.pool", "envpool.stepper", "examples",
                "examples.envs", "examples.common",
                "examples.common.record", "examples.vtrace",
                "examples.vtrace.experiment", "models.a2c",
                "utils.profiling", "parallel.moe", "models.nethack",
                "examples.a2c", "examples.remote_actors"):
        assert f"moolib_tpu_torch.{mod}" in got["modules"], mod
    assert got["bad"] == [], got["bad"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    names = list(_imported_roots(REPO_ROOT / "chip_smoke.py"))
    assert any(n.startswith("moolib_tpu_torch") for n in names), names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "flax", "optax", "moolib_tpu")]
    assert bad == [], bad


def test_bench_torch_imports_no_jax_and_no_reference_package():
    names = list(_imported_roots(REPO_ROOT / "bench_torch.py"))
    assert any(n.startswith("moolib_tpu_torch") for n in names), names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "flax", "optax", "moolib_tpu")]
    assert bad == [], bad


def test_bench_allreduce_torch_imports_no_jax_and_no_reference_package():
    names = list(_imported_roots(REPO_ROOT / "bench_allreduce_torch.py"))
    assert any(n.startswith("moolib_tpu_torch") for n in names), names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "flax", "optax", "moolib_tpu",
                                  "ml_dtypes")]
    assert bad == [], bad


def test_bench_e2e_torch_imports_no_jax_and_no_reference_package():
    names = list(_imported_roots(REPO_ROOT / "bench_e2e_torch.py"))
    assert any(n.startswith("moolib_tpu_torch") for n in names), names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "flax", "optax", "moolib_tpu",
                                  "ml_dtypes")]
    assert bad == [], bad


def test_bench_a2c_torch_imports_no_jax_and_no_reference_package():
    names = list(_imported_roots(REPO_ROOT / "bench_a2c_torch.py"))
    assert any(n.startswith("moolib_tpu_torch") for n in names), names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "flax", "optax", "moolib_tpu",
                                  "ml_dtypes")]
    assert bad == [], bad


_LIGHT_CHILD = r"""
import json, sys
import moolib_tpu_torch
from moolib_tpu_torch.envpool import pool
from moolib_tpu_torch.examples import envs
print(json.dumps(sorted(m for m in ("torch", "jax", "moolib_tpu")
                        if m in sys.modules)))
"""


def test_an_env_worker_imports_no_torch():
    """What an EnvPool worker imports (the package, the pool module and
    the examples' envs) pulls in neither torch nor JAX: the package's
    imports are lazy."""
    proc = subprocess.run(
        [sys.executable, "-c", _LIGHT_CHILD], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_lazy_exports_resolve():
    import moolib_tpu_torch

    for name in moolib_tpu_torch.__all__:
        assert getattr(moolib_tpu_torch, name) is not None, name
    assert moolib_tpu_torch.EnvStepper is moolib_tpu_torch.EnvPool
    with pytest.raises(AttributeError):
        moolib_tpu_torch.no_such_name


def test_entry_points_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        import bench_torch

        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_torch.main(batch=2, iters=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImpalaNet(6)
        import bench_e2e_torch

        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_e2e_torch.main(duration=1.0)


def test_replica_has_no_rpc_binding_yet():
    # The binding exists now: Replica(rpc, ...) needs an Rpc, and a
    # stand-in without the Rpc surface is refused before anything runs.
    with pytest.raises(AttributeError, match="defined"):
        Replica(object(), lambda p, x: x, device="cpu")
