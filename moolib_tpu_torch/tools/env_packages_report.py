"""Evidence artifact for the real-environment gap; the twin of the
reference's ``tools/env_packages_report.py``.

The reference's flagship benchmark is Atari via ale_py (reference:
README.md:99-105, examples/atari/environment.py); configs 4/5 in
BASELINE.md additionally name procgen and nle. This tool records which of
them this host has, as a machine-checkable artifact with the reference's
keys: per-package import probes (the same packages, plus the near-miss
gym/gymnasium) and the package-index probe.

The index probe is a bounded TCP connect (5 s timeout), never an install
attempt. It dials an outside host, so it runs only when asked
(``--probe-index``, optionally ``HOST:PORT``); otherwise the artifact's
``pypi_probe`` records that it was skipped.

Usage::

    python -m moolib_tpu_torch.tools.env_packages_report [--json OUT] \\
        [--probe-index [HOST:PORT]]
"""

from __future__ import annotations

import argparse
import importlib
import json
import socket
import time
from typing import Optional

WANTED = ["ale_py", "procgen", "nle", "atari_py", "gym", "gymnasium"]
INDEX = "pypi.org:443"


def probe_import(name: str) -> dict:
    t0 = time.monotonic()
    try:
        mod = importlib.import_module(name)
        return {
            "installed": True,
            "version": getattr(mod, "__version__", None),
            "import_s": round(time.monotonic() - t0, 3),
        }
    except Exception as e:
        return {
            "installed": False,
            "error": f"{type(e).__name__}: {e}"[:200],
        }


def probe_index(host: str = "pypi.org", port: int = 443,
                timeout: float = 5.0) -> dict:
    """Bounded TCP connect to the package index — NOT an install attempt;
    shows whether one could even have reached the index."""
    t0 = time.monotonic()
    try:
        addr = socket.getaddrinfo(host, port, proto=socket.IPPROTO_TCP)
        with socket.create_connection(addr[0][4], timeout=timeout):
            return {"reachable": True,
                    "connect_s": round(time.monotonic() - t0, 3)}
    except Exception as e:
        return {
            "reachable": False,
            "error": f"{type(e).__name__}: {e}"[:200],
            "elapsed_s": round(time.monotonic() - t0, 3),
        }


def report(probe: Optional[str] = None) -> dict:
    """The artifact; ``probe`` is the index's ``HOST:PORT`` to dial, or
    None to skip the network probe."""
    if probe is None:
        index = {"reachable": None,
                 "skipped": "not asked (--probe-index dials an outside host)"}
    else:
        host, _, port = probe.rpartition(":")
        index = probe_index(host, int(port))
    return {
        "artifact": "env_packages_report",
        "policy": (
            "nothing is installed at run time; this records which env "
            "packages the host has instead of assuming it"
        ),
        "packages": {name: probe_import(name) for name in WANTED},
        "pypi_probe": index,
        "consequence": (
            "configs 1/4/5 of BASELINE.md run on the synthetic "
            "Atari-shaped stand-in envs (moolib_tpu_torch/examples/envs.py) "
            "where ale_py/procgen/nle are missing"
        ),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--probe-index", nargs="?", const=INDEX, default=None,
                    metavar="HOST:PORT",
                    help=f"also dial the package index (default {INDEX})")
    args = ap.parse_args(argv)

    art = report(args.probe_index)
    print(json.dumps({k: v for k, v in art.items() if k != "packages"}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
    return 0


if __name__ == "__main__":
    main()
