"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output:

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (the same window, then a few profiled steps). Every run
checks what its steps produced against the plain reference
(``check.py``) and prints each compared number beside its limit, last on
standard error and last in the result line. Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Kernel caches at fixed paths inside the checkout: only a cell's first
# run there builds. (The program builds its own kernels into
# build/moolib_tpu_torch/ beside the package.)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "cellbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "cellbench"
                                         / "torch_extensions")
sys.path.insert(0, str(ROOT))

#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "moolib_tpu")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result(cell, rec, found, memory_peak, trace: bool, device_name: str):
    from cellbench.check import judge
    from cellbench.lookup import reader

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = _finite(reader(m["name"])(rec))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(memory_peak)}
    line = {"correct": None, "attempted": rec.steps,
            "failed": int(found.get("nonfinite_losses", 0)),
            "metrics": metrics, "device": device}
    if trace and rec.trace is not None and rec.trace.device:
        busy, window, _ = rec.trace.busy_and_gaps()
        device["busy_s"], device["window_s"] = busy, window
        line["breakdown"] = rec.trace.breakdown()
    correct, table = judge(found, cell.limits)
    line["correct"] = correct
    line["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in table.items()}
    return line, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cellbench.lookup import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("cellbench: no CUDA device; this benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cellbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    rec, found, memory_peak = cell.loop().run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line, table = result(cell, rec, found, memory_peak, bool(args.trace),
                         rec.device_name)
    peak = rec.peaks[cell.config["peak"]] / 1e12 if rec.peaks else None
    print(f"card: {_power_limit()}; peak {cell.config['peak']} "
          f"{peak} TFLOP/s", file=sys.stderr)
    max_norm = cell.config["optimizer"]["max_norm"]
    print(f"clip: grad_norm of the checked steps {rec.grad_norms}, "
          f"max_norm {max_norm}, fired on "
          f"{sum(g > max_norm for g in rec.grad_norms)}", file=sys.stderr)
    for name, v in table.items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
