"""Tab-separated run logs + run metadata; the counterpart of
:mod:`moolib_tpu.examples.common.record` (same bytes for the same rows):
a per-run logs.tsv with a header row, and metadata.json beside it,
appended so concurrent peers and plotting tools can tail them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

__all__ = ["TsvLogger", "write_metadata"]


class TsvLogger:
    """Append dict rows to a .tsv file; the header is written on first log
    and the field set is frozen then (late keys are dropped, missing keys
    logged as empty)."""

    def __init__(self, path: str):
        self.path = path
        self._fields: Optional[list] = None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if os.path.exists(path):  # resume: adopt the existing header
            with open(path, "r") as f:
                first = f.readline().strip()
            if first:
                self._fields = first.split("\t")

    def log(self, row: Dict) -> None:
        if self._fields is None:
            self._fields = ["_time"] + sorted(row)
            with open(self.path, "a") as f:
                f.write("\t".join(self._fields) + "\n")
        values = dict(row, _time=f"{time.time():.3f}")
        line = "\t".join(_fmt(values.get(k, "")) for k in self._fields)
        with open(self.path, "a") as f:
            f.write(line + "\n")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def write_metadata(path: str, **fields) -> None:
    """Write run metadata (argv, env, user fields) next to the logs."""
    meta = {
        "time": time.time(),
        "argv": __import__("sys").argv,
        "cwd": os.getcwd(),
        **fields,
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2, default=str)
