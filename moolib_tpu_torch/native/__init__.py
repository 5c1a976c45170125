"""Native runtime loader: builds and loads the port's C++ extension on
demand; the counterpart of :mod:`moolib_tpu.native`.

The extension (``_native.cpp``: the wire codec's hot path and the
process-shared semaphores of the shm lane) is one C++ translation unit,
compiled with the system toolchain on first use into
``build/moolib_tpu_torch/`` at the repository root, under a name keyed by
the hash of its source and flags, so an edited source never loads a stale
build. Everything it accelerates has a pure-Python path, so the package
works (slower) without a compiler.

Set ``MOOLIB_TPU_NO_NATIVE=1`` to force the pure-Python paths.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path
from typing import Optional

from ..utils import get_logger

log = get_logger("native")

__all__ = ["get_native", "build_native", "native_path"]

_SRC = Path(__file__).resolve().parent / "_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moolib_tpu_torch"
_MODNAME = "moolib_tpu_torch.native._native"

_lock = threading.Lock()
_cached = False
_module = None
_path: Optional[str] = None


def _compile_cmd(out: str):
    cxx = os.environ.get("CXX", "g++")
    include = sysconfig.get_paths()["include"]
    return [cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
            f"-I{include}", str(_SRC), "-o", out, "-pthread"]


def _so_path() -> Path:
    tag = sysconfig.get_config_var("SOABI") or "unknown"
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_compile_cmd("")[:-2]).encode())
    return BUILD_DIR / f"_native-{h.hexdigest()[:16]}.{tag}.so"


def build_native(force: bool = False) -> Optional[str]:
    """Compile the extension if needed; returns the .so path or None."""
    out = _so_path()
    if not force and out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a process-unique temp path and os.replace() into place:
    # concurrent first use across processes (several peers launched at
    # once) must never dlopen a half-written .so.
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        proc = subprocess.run(
            _compile_cmd(tmp), capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        log.info("native build unavailable (%s); using pure-Python paths", e)
        return None
    if proc.returncode != 0:
        log.info(
            "native build failed; using pure-Python paths:\n%s",
            proc.stderr[-2000:],
        )
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, out)
    return str(out)


def _load(so: str):
    spec = importlib.util.spec_from_file_location(_MODNAME, so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[_MODNAME] = mod
    return mod


def get_native():
    """The loaded extension module, or None (pure-Python fallback)."""
    global _cached, _module, _path
    if _cached:
        return _module
    with _lock:
        if _cached:
            return _module
        if os.environ.get("MOOLIB_TPU_NO_NATIVE"):
            _cached = True
            return None
        so = build_native()
        if so is not None:
            try:
                _module = _load(so)
            except (asyncio.CancelledError,
                    concurrent.futures.CancelledError):
                raise  # never swallow task cancellation
            except Exception as e:  # corrupt cache, ABI mismatch, ...
                log.info("native load failed (%s); rebuilding once", e)
                so = build_native(force=True)
                if so is not None:
                    try:
                        _module = _load(so)
                    except (asyncio.CancelledError,
                            concurrent.futures.CancelledError):
                        raise
                    except Exception:
                        _module = None
        _cached = True
        if _module is not None:
            _path = so
            log.info("native runtime loaded from %s", so)
        return _module


def native_path() -> Optional[str]:
    """The path of the loaded extension, or None when none is loaded."""
    get_native()
    return _path
