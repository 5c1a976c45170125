"""The port's hand-written CUDA kernels: build, load, check and launch.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled with ``nvcc`` for ``sm_90a`` at first use, from the sources in the
checkout, into ``build/moolib_tpu_torch/`` beside the package (the library
name carries a hash of the source, so an edited source is rebuilt), and is
loaded with :mod:`ctypes`. Nothing here runs when the module is imported:
the CPU-only test host has no ``nvcc`` and no card.

A kernel launches on PyTorch's current stream, does not synchronise and
allocates nothing; its wrapper checks the tensors, allocates the outputs,
launches, raises if ``cudaGetLastError`` is not 0, and then adds one to
the kernel's ``launches`` count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

__all__ = ["CudaKernel", "FLASH_FWD", "flash_fwd"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moolib_tpu_torch"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


class CudaKernel:
    """One kernel source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: List[type]):
        self.name = name
        self.source = _CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._lock = threading.Lock()
        self._lib = None
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _build(self) -> None:
        """Run ``nvcc`` unless the library is already built."""
        out = self.library_path()
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} "
                f"(exit {proc.returncode}):\n{proc.stdout}"
            )
        os.replace(tmp, out)

    def _load(self):
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.symbol}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def ensure_built(self) -> None:
        with self._lock:
            if self._fn is not None:
                return
            self._build()
            self._load()

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch reported an
        error, else count it."""
        if self._fn is None:
            self.ensure_built()
        rc = self._fn(*args)
        if rc != 0:
            msg = getattr(self._lib, f"{self.symbol}_error_string")(rc)
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {rc} "
                f"({msg.decode(errors='replace')})"
            )
        with self._lock:
            self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int

#: Flash-attention forward; replaces moolib_tpu/ops/attention.py
#: ``_flash_kernel``.
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd.cu", "flash_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)

_FLASH_D = (32, 64, 128)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              seg_q: torch.Tensor, seg_k: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward: q [B,H,Tq,D], k/v [B,H,Tk,D] (f32 or
    bf16, one dtype, contiguous, D in 32/64/128), seg_q [B,Tq] and seg_k
    [B,Tk] int32 -> (o [B,H,Tq,D] in v's dtype, lse [B*H,1,Tq] f32)."""
    tensors = (q, k, v, seg_q, seg_k)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_fwd needs every input on one CUDA device")
    if q.dtype not in _FLASH_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(
            f"flash_fwd takes q/k/v of one dtype, float32 or bfloat16; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_fwd wants q [B,H,Tq,D] and k/v [B,H,Tk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree"
        )
    if D not in _FLASH_D:
        raise ValueError(f"flash_fwd supports head dims {_FLASH_D}, got {D}")
    if seg_q.dtype != torch.int32 or seg_k.dtype != torch.int32:
        raise ValueError("segment ids must be int32")
    if tuple(seg_q.shape) != (B, Tq) or tuple(seg_k.shape) != (B, Tk):
        raise ValueError(
            f"segment ids must be [B,Tq]={(B, Tq)} and [B,Tk]={(B, Tk)}; "
            f"got {tuple(seg_q.shape)}, {tuple(seg_k.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_fwd needs contiguous inputs")
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_FWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
            seg_k.data_ptr(), o.data_ptr(), lse.data_ptr(), B * H, H, Tq,
            Tk, D, int(bool(causal)), _FLASH_DTYPES[q.dtype], stream,
        )
    return o, lse
