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
                "examples.a2c", "examples.remote_actors", "statestore",
                "statestore.bundle", "statestore.store", "testing",
                "testing.chaos", "testing.scenarios", "fleet", "fleet.spec",
                "fleet.rollout", "fleet.controller", "fleet.runner", "tools",
                "tools.statestore_smoke", "tools.fleet_smoke",
                "testing.chaos_env", "testing.restrack",
                "testing.paritywatch", "tools.chaos_soak",
                "tools.serving_load", "parallel.mesh",
                "parallel.distributed", "parallel.collectives",
                "parallel.tp", "parallel.pipeline", "ops.ring_attention",
                "testing.spmd", "tools.dryrun_multichip", "bench.trends",
                "bench.budgets", "bench.suite", "testing.hotwatch",
                "ops.batchsizefinder", "tools.perf", "tools.telemetry_smoke",
                "tools.attn_bench", "tools.perf_sweep", "tools.roofline",
                "tools.envpool_bench", "tools.chip_session",
                "examples.launch", "examples.plot", "tools.learning_curve",
                "tools.env_packages_report", "tools.config_matrix",
                "tools.elastic_soak", "tools.allreduce_decomp",
                "tools.allreduce_latency_ab", "tools.telemetry_dump",
                "tools.incident_report", "tools.stepscope_report",
                "tools.gen_api_docs", "analysis", "analysis.engine",
                "analysis.rules_race", "testing.locktrace",
                "tools.locktrace_cost", "analysis.recompile_guard",
                "analysis.rules_async", "analysis.rules_bench",
                "analysis.rules_hot", "analysis.rules_jax",
                "analysis.rules_lifecycle", "analysis.rules_num",
                "analysis.rules_protocol", "analysis.rules_sharding",
                "analysis.rules_wire", "tools.moolint",
                "parallel.local_dp"):
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
from moolib_tpu_torch.telemetry import StepScope, Telemetry
scope = StepScope("worker", telemetry=Telemetry("worker"))
with scope.step(), scope.phase("env_wait"), scope.span("step"):
    pass
print(json.dumps(sorted(m for m in ("torch", "jax", "moolib_tpu")
                        if m in sys.modules)))
"""


def test_an_env_worker_imports_no_torch():
    """What an EnvPool worker imports (the package, the pool module and
    the examples' envs) pulls in neither torch nor JAX: the package's
    imports are lazy, and a StepScope's phases and spans (which open
    profiler ranges only while torch's profiler records) import none."""
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


_ONE_MODULE = r"""
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "flax", "optax", "ml_dtypes", "moolib_tpu"))))
"""


@pytest.mark.parametrize("module", [
    "moolib_tpu_torch.statestore", "moolib_tpu_torch.testing",
    "moolib_tpu_torch.testing.scenarios", "moolib_tpu_torch.fleet",
    "moolib_tpu_torch.fleet.runner", "moolib_tpu_torch.tools.statestore_smoke",
    "moolib_tpu_torch.tools.fleet_smoke", "moolib_tpu_torch.testing.restrack",
    "moolib_tpu_torch.testing.paritywatch",
    "moolib_tpu_torch.testing.chaos_env",
    "moolib_tpu_torch.tools.chaos_soak",
    "moolib_tpu_torch.tools.serving_load", "moolib_tpu_torch.bench",
    "moolib_tpu_torch.bench.suite", "moolib_tpu_torch.testing.hotwatch",
    "moolib_tpu_torch.ops.batchsizefinder", "moolib_tpu_torch.tools.perf",
    "moolib_tpu_torch.tools.telemetry_smoke",
    "moolib_tpu_torch.tools.attn_bench", "moolib_tpu_torch.tools.perf_sweep",
    "moolib_tpu_torch.tools.roofline", "moolib_tpu_torch.tools.envpool_bench",
    "moolib_tpu_torch.tools.chip_session",
    "moolib_tpu_torch.examples.launch", "moolib_tpu_torch.examples.plot",
    "moolib_tpu_torch.tools.learning_curve",
    "moolib_tpu_torch.tools.env_packages_report",
    "moolib_tpu_torch.tools.config_matrix",
    "moolib_tpu_torch.tools.elastic_soak",
    "moolib_tpu_torch.tools.allreduce_decomp",
    "moolib_tpu_torch.tools.allreduce_latency_ab",
    "moolib_tpu_torch.tools.telemetry_dump",
    "moolib_tpu_torch.tools.incident_report",
    "moolib_tpu_torch.tools.stepscope_report",
    "moolib_tpu_torch.tools.gen_api_docs", "moolib_tpu_torch.analysis",
    "moolib_tpu_torch.testing.locktrace",
    "moolib_tpu_torch.analysis.recompile_guard",
    "moolib_tpu_torch.tools.moolint"])
def test_durable_state_fault_engine_and_fleet_import_alone_cleanly(module):
    """Each of this slice's sub-packages and smokes, imported alone in a
    fresh interpreter, pulls in no JAX, no ml_dtypes and nothing of the
    reference package."""
    proc = subprocess.run(
        [sys.executable, "-c", _ONE_MODULE, module], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_ENV_MODULE = r"""
import json, sys
import moolib_tpu_torch.testing.chaos_env
import moolib_tpu_torch.tools.chaos_soak
print(json.dumps(sorted(m for m in ("torch", "jax", "moolib_tpu")
                        if m in sys.modules)))
"""


def test_chaos_step_env_module_imports_no_torch():
    """The env-tier scenarios' env module, the testing package it sits
    in, and the soak runner pull in neither torch nor JAX nor the
    reference package: a spawn worker imports the first two to unpickle
    its env factory, and the soak's module as its main module."""
    proc = subprocess.run(
        [sys.executable, "-c", _ENV_MODULE], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_LIGHT_PERF = r"""
import json, sys
import moolib_tpu_torch.bench
import moolib_tpu_torch.bench.suite
import moolib_tpu_torch.tools.perf
import moolib_tpu_torch.tools.envpool_bench
print(json.dumps(sorted(m for m in ("torch", "jax", "moolib_tpu")
                        if m in sys.modules)))
"""


def test_perfwatch_modules_that_spawn_env_workers_import_no_torch():
    """The bench package (an EnvPool worker unpickles the suite's
    TrivialEnv from it), the perf CLI and envpool_bench (their workers
    import them again as the main module) pull in no torch at import."""
    proc = subprocess.run(
        [sys.executable, "-c", _LIGHT_PERF], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


_LIGHT_TOOLS = r"""
import json, sys
import moolib_tpu_torch.tools.config_matrix
import moolib_tpu_torch.tools.elastic_soak
import moolib_tpu_torch.tools.learning_curve
import moolib_tpu_torch.tools.env_packages_report
import moolib_tpu_torch.examples.launch
import moolib_tpu_torch.examples.plot
import moolib_tpu_torch.analysis
import moolib_tpu_torch.analysis.recompile_guard
import moolib_tpu_torch.analysis.rules_async
import moolib_tpu_torch.analysis.rules_bench
import moolib_tpu_torch.analysis.rules_hot
import moolib_tpu_torch.analysis.rules_jax
import moolib_tpu_torch.analysis.rules_lifecycle
import moolib_tpu_torch.analysis.rules_num
import moolib_tpu_torch.analysis.rules_protocol
import moolib_tpu_torch.analysis.rules_sharding
import moolib_tpu_torch.analysis.rules_wire
import moolib_tpu_torch.tools.moolint
import moolib_tpu_torch.testing.locktrace
from moolib_tpu_torch.analysis import all_rules
all_rules()
print(json.dumps(sorted(m for m in ("torch", "jax", "moolib_tpu")
                        if m in sys.modules)))
"""


def test_operator_tools_whose_workers_import_them_import_no_torch():
    """config_matrix (its EnvPools' spawn workers and its spawn peers
    import it as their main module), elastic_soak and learning_curve
    import torch only inside their functions; the launcher, the plotter,
    the lint engine and locktrace import none at all."""
    proc = subprocess.run(
        [sys.executable, "-c", _LIGHT_TOOLS], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_lazy_testing_exports_resolve():
    from moolib_tpu_torch import testing
    from moolib_tpu_torch.testing import chaos, paritywatch, restrack

    assert testing.FaultPlan is chaos.FaultPlan
    assert testing.ParityWatch is paritywatch.ParityWatch
    assert testing.ResourceTracker is restrack.ResourceTracker
    from moolib_tpu_torch.testing import hotwatch, locktrace

    assert testing.Hotwatch is hotwatch.Hotwatch
    assert testing.LockTrace is locktrace.LockTrace
    for name in testing.__all__:
        assert getattr(testing, name) is not None, name
    with pytest.raises(AttributeError):
        testing.no_such_name


def test_lazy_exports_resolve_the_durable_state_names():
    import moolib_tpu_torch
    from moolib_tpu_torch.statestore import store

    assert moolib_tpu_torch.StateStore is store.StateStore
    assert moolib_tpu_torch.Replicator is store.Replicator
    assert issubclass(moolib_tpu_torch.StateStoreError, RuntimeError)
    assert {"StateStore", "Replicator", "StateStoreError"} <= set(
        moolib_tpu_torch.__all__)


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


def test_replica_refuses_a_stand_in_without_the_rpc_surface():
    # Replica(rpc, ...) needs an Rpc: a stand-in without the Rpc surface
    # is refused before anything runs.
    with pytest.raises(AttributeError, match="defined"):
        Replica(object(), lambda p, x: x, device="cpu")


def test_every_reference_layout_name_resolves():
    """No name of the reference's parallel package or ring attention is
    left unported (they raised "not ported", naming ROADMAP item 11,
    before the multi-device slice)."""
    import moolib_tpu.ops.ring_attention as jring
    import moolib_tpu.parallel as jparallel
    from moolib_tpu_torch import parallel
    from moolib_tpu_torch.ops import ring_attention

    assert set(jparallel.__all__) <= set(parallel.__all__)
    for name in jparallel.__all__:
        assert getattr(parallel, name) is not None, name
    for name in jring.__all__:
        assert callable(getattr(ring_attention, name)), name
    with pytest.raises(AttributeError):
        parallel.no_such_name


def test_every_top_level_name_of_the_reference_resolves():
    """The port's top level holds every name of the reference's, the
    version string among them (the lazy ``__getattr__`` refuses dunder
    names, so ``__version__`` is a plain attribute)."""
    import moolib_tpu
    import moolib_tpu_torch

    assert set(moolib_tpu.__all__) <= set(moolib_tpu_torch.__all__)
    for name in moolib_tpu.__all__:
        assert getattr(moolib_tpu_torch, name) is not None, name
    assert moolib_tpu_torch.__version__ == moolib_tpu.__version__ == "0.1.0"


def test_ops_exports_every_name_of_the_reference():
    import moolib_tpu.ops as jops
    import moolib_tpu_torch.ops as ops

    assert set(jops.__all__) <= set(ops.__all__)
    for name in jops.__all__:
        assert getattr(ops, name) is not None, name
    assert callable(ops.ring_attention.ring_attention)


_RING_CHILD = r"""
import moolib_tpu_torch.ops as o
print(o.ring_attention.__name__)
"""


def test_ops_ring_attention_resolves_in_a_fresh_interpreter():
    """Without an earlier ``from moolib_tpu_torch.ops import
    ring_attention`` having imported the submodule."""
    proc = subprocess.run(
        [sys.executable, "-c", _RING_CHILD], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["moolib_tpu_torch.ops.ring_attention"]


def test_bench_harness_exports_every_ported_name_of_the_reference():
    """Every name of the reference's ``__all__``, the device guards
    included."""
    import moolib_tpu.bench.harness as jharness
    from moolib_tpu_torch.bench import harness
    from moolib_tpu_torch.bench.harness import (
        install_watchdog,
        time_chained,
        time_train_step,
        wait_for_device,
    )
    from moolib_tpu_torch.utils import benchmark

    assert set(jharness.__all__) <= set(harness.__all__)
    for name in jharness.__all__:
        assert getattr(harness, name) is not None, name
    assert time_chained is benchmark.time_chained
    assert time_train_step is benchmark.time_train_step
    assert wait_for_device is benchmark.wait_for_device
    assert install_watchdog is benchmark.install_watchdog
    with pytest.raises(AttributeError):
        harness.no_such_name


_HARNESS_CHILD = r"""
import json, sys
import moolib_tpu_torch.bench.harness
print(json.dumps(sorted(m for m in ("torch", "jax", "moolib_tpu")
                        if m in sys.modules)))
"""


def test_bench_harness_imports_no_torch_until_asked_for_the_timers():
    proc = subprocess.run(
        [sys.executable, "-c", _HARNESS_CHILD], cwd=str(REPO_ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
