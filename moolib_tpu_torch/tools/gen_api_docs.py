"""Dependency-free API documentation generator of the port; the twin of
the reference's ``tools/gen_api_docs.py``.

Walks every module of :mod:`moolib_tpu_torch` with ``inspect`` and writes
GitHub-renderable markdown under ``docs/torch/api/`` plus a
``docs/torch/index.md`` module inventory (each module's role is the first
sentence of its docstring). The reference's own ``docs/api/`` and
``docs/index.md`` are never touched. ``--check`` exits 1 when the
committed docs drift from the code.

Importing a module for ``inspect`` builds and loads nothing: the CUDA
kernels build at their first launch (:mod:`moolib_tpu_torch.ops._kernels`)
and the native codec at its first use.

Usage::

    python -m moolib_tpu_torch.tools.gen_api_docs            # (re)write docs/torch/
    python -m moolib_tpu_torch.tools.gen_api_docs --check    # exit 1 if stale
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import pkgutil
import re
import sys

PACKAGE = "moolib_tpu_torch"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOCS = os.path.join(ROOT, "docs", "torch")

_ADDRESS = re.compile(r" at 0x[0-9a-fA-F]+")


def modules() -> list:
    """Every module of the package, the package itself first, in walk
    order (sorted by dotted name)."""
    pkg = importlib.import_module(PACKAGE)
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   PACKAGE + ".")]
    return [PACKAGE] + sorted(names)


def _role(mod) -> str:
    """The first sentence of the module's docstring."""
    para = " ".join((mod.__doc__ or "").strip().split("\n\n")[0].split())
    return para.split(". ")[0].rstrip(".")


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Default values whose repr embeds a memory address would make the
    # output differ between runs.
    return _ADDRESS.sub("", sig)


def _first_para(doc: str) -> str:
    return _ADDRESS.sub("", (doc or "").strip())


def _doc_module(path: str) -> str:
    mod = importlib.import_module(path)
    lines = [f"# `{path}`", "", f"*{_role(mod)}*", ""]
    if mod.__doc__:
        lines += [_first_para(mod.__doc__), ""]
    members = []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != path:
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            members.append((name, obj))
    for name, obj in members:
        if inspect.isclass(obj):
            lines += [f"## class `{name}{_signature(obj)}`", ""]
            if obj.__doc__:
                lines += [_first_para(obj.__doc__), ""]
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("_") or not callable(meth):
                    continue
                doc = inspect.getdoc(meth)
                lines += [f"### `{name}.{mname}{_signature(meth)}`", ""]
                if doc:
                    lines += [_first_para(doc), ""]
        else:
            lines += [f"## `{name}{_signature(obj)}`", ""]
            doc = inspect.getdoc(obj)
            if doc:
                lines += [_first_para(doc), ""]
    return "\n".join(lines) + "\n"


def _fname(path: str) -> str:
    return path.replace(".", "_") + ".md"


def _index(paths) -> str:
    lines = [
        "# moolib_tpu_torch — API documentation",
        "",
        "The PyTorch/CUDA port of moolib_tpu for one NVIDIA H100. "
        "Generated by `python -m moolib_tpu_torch.tools.gen_api_docs` "
        "from the live docstrings; regenerate after changing public APIs.",
        "",
        "| module | role |",
        "|---|---|",
    ]
    for path in paths:
        role = _role(importlib.import_module(path)).replace("|", "\\|")
        lines.append(f"| [`{path}`](api/{_fname(path)}) | {role} |")
    lines += [
        "",
        "Entry points:",
        "",
        "- `python -m moolib_tpu_torch.examples.launch local --peers N -- "
        "[--device cpu] key=value...` — a broker and N elastic experiment "
        "peers on this host; `sbatch` writes a slurm array script.",
        "- `python -m moolib_tpu_torch.examples.vtrace.experiment` — the "
        "elastic IMPALA/V-trace experiment (the card unless `--device "
        "cpu`).",
        "- `python -m moolib_tpu_torch.broker` — standalone membership "
        "broker.",
        "- `python -m moolib_tpu_torch.tools.<name>` — the tools: "
        "smokes, soaks, benchmarks, cohort crawls (`telemetry_dump`, "
        "`incident_report`, `stepscope_report`) and this generator.",
        "- `chip_smoke.py`, `bench_torch.py`, `bench_e2e_torch.py`, "
        "`bench_allreduce_torch.py`, `bench_a2c_torch.py` (repo root) — "
        "the card's smoke and benchmarks.",
        "",
    ]
    return "\n".join(lines)


def generate() -> dict:
    paths = modules()
    out = {os.path.join(DOCS, "index.md"): _index(paths)}
    for path in paths:
        out[os.path.join(DOCS, "api", _fname(path))] = _doc_module(path)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="verify committed docs match the code")
    args = ap.parse_args(argv)
    files = generate()
    if args.check:
        stale = []
        for fpath, content in files.items():
            try:
                with open(fpath) as f:
                    if f.read() != content:
                        stale.append(fpath)
            except FileNotFoundError:
                stale.append(fpath)
        api = os.path.join(DOCS, "api")
        extra = sorted(
            os.path.join(api, f) for f in os.listdir(api)
            if os.path.join(api, f) not in files
        ) if os.path.isdir(api) else []
        if stale or extra:
            print("STALE docs (rerun python -m "
                  "moolib_tpu_torch.tools.gen_api_docs):")
            for s in stale + extra:
                print(f"  {os.path.relpath(s, ROOT)}")
            return 1
        print(f"docs up to date ({len(files)} files)")
        return 0
    os.makedirs(os.path.join(DOCS, "api"), exist_ok=True)
    for fpath, content in files.items():
        with open(fpath, "w") as f:
            f.write(content)
    print(f"wrote {len(files)} files under {os.path.relpath(DOCS, ROOT)}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
