"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``moolib_tpu_torch`` begins with ``moolib_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "moolib_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


REFERENCE = sorted((HERE / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "moolib_tpu_torch" not in names
    assert names <= {"torch", "math", "contextlib", "importlib"}


def test_the_run_refuses_a_process_that_loaded_a_forbidden_module():
    sys.path.insert(0, str(HERE.parent))
    from cellbench import run

    sys.modules["jax_fake_probe"] = object()  # not forbidden: another name
    sys.modules["moolib_tpu_torch_probe"] = object()
    try:
        assert "jax_fake_probe" not in run.forbidden_modules()
        assert "moolib_tpu_torch_probe" not in run.forbidden_modules()
        sys.modules["moolib_tpu.fake"] = object()
        assert run.forbidden_modules() == ["moolib_tpu.fake"]
    finally:
        for k in ("jax_fake_probe", "moolib_tpu_torch_probe",
                  "moolib_tpu.fake"):
            sys.modules.pop(k, None)


def test_a_cells_modules_load_without_jax():
    """Import every module a run imports in a fresh process and list what
    it loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from cellbench.lookup import Cell, reader\n"
        "from cellbench import run, calibrate\n"
        "import moolib_tpu_torch\n"
        "from moolib_tpu_torch import ImpalaNet, TransformerNet, ClippedAdam,"
        " make_grad_step, make_apply_step\n"
        "from moolib_tpu_torch.telemetry import StepScope\n"
        "from moolib_tpu_torch.utils import stage_host_async\n"
        "from cellbench.lookup import load_benchmark\n"
        "from cellbench.tests.pending import PendingCell\n"
        "cells = [Cell(w['name']) for w in load_benchmark()['workloads']]\n"
        "for cell in cells + [PendingCell()]:\n"
        "    cell.loop(); cell.family()\n"
        "    [reader(m['name']) for m in cell.end_to_end + cell.per_layer]\n"
        "print(run.forbidden_modules())\n" % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
