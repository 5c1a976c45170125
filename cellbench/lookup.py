"""Finds every part of a cell by its name in ``BENCHMARK.json``: the
configuration file it names, ``traffic/<traffic>.json``,
``limits/<workload>.json``, ``metrics/<metric>.py``,
``families/<family>.py`` and ``loops/<loop>.py``. A later cell, mix
or metric is new files and entries; nothing here changes for it."""

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    def __init__(self, name: str, root: Path = ROOT, bench_dir: Path = HERE):
        self.root, self.dir = root, bench_dir
        bench = load_benchmark(root)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[check_name(name)]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[check_name(self.workload["config"])]
        self.config = _json(root / self.config_entry["file"])
        self.traffic = _json(bench_dir / "traffic"
                             / f"{check_name(self.workload['traffic'])}.json")
        limits = bench_dir / "limits" / f"{name}.json"
        self.limits = _json(limits) if limits.exists() else {}
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def loop(self):
        return _module("loops", self.traffic["loop"])

    def family(self):
        return _module("families", self.config["family"])


def _module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module of the package ``cellbench.<kind>``
    (a name may hold "." and "-", which a module name may not)."""
    return load_file_module(HERE / kind / f"{check_name(name)}.py", kind,
                            name)


def load_file_module(path: Path, kind: str, name: str):
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    importlib.import_module(f"cellbench.{kind}")
    mod_name = f"cellbench.{kind}.{re.sub(r'[.-]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read
