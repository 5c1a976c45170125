"""The port's hand-written CUDA kernels: build, load, check and launch.

Each ``csrc/*.cu`` file is one :class:`CudaLibrary` with a plain C entry
point per kernel. It is compiled with ``nvcc`` for ``sm_90a`` at first use,
from the sources in the checkout, into ``build/moolib_tpu_torch/`` beside
the package (the library name carries a hash of the source and of every
``csrc/`` header it includes, so an edit to either is rebuilt), and is
loaded with :mod:`ctypes`; kernels of one source share its one build.
Nothing here runs when the module is imported: the CPU-only test host has
no ``nvcc`` and no card.

A kernel launches on PyTorch's current stream, does not synchronise and
allocates nothing; its wrapper checks the tensors, allocates the outputs,
launches, raises if ``cudaGetLastError`` is not 0, and then adds one to
the kernel's ``launches`` count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import torch

__all__ = [
    "CudaKernel",
    "CudaLibrary",
    "FLASH_BWD_DKDV",
    "FLASH_BWD_DQ",
    "FLASH_BWD_TILE",
    "FLASH_FWD",
    "KERNELS",
    "MAX_POOL_BWD",
    "MAX_POOL_FWD",
    "TILE_MAX",
    "build_all",
    "build_count",
    "flash_bwd_design",
    "flash_bwd_dkdv",
    "flash_bwd_dq",
    "flash_bwd_tile",
    "flash_fwd",
    "flash_fwd_design",
    "max_pool_same_bwd",
    "max_pool_same_fwd",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
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


class CudaLibrary:
    """One kernel source, built once into one shared library that
    exports ``<name>_error_string`` beside its kernels' entry points."""

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = _CSRC / source
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        #: First-use builds in this process (nvcc, or the kept library):
        #: the port's counterpart of a jit's compile count.
        self.builds = 0
        self._lock = threading.Lock()
        self._lib = None

    def sources(self) -> List[Path]:
        """The ``.cu`` file and every header under ``csrc/`` that it
        includes with ``#include "..."``, directly or through another."""
        found, todo = [], [self.source]
        while todo:
            path = todo.pop()
            if path in found:
                continue
            found.append(path)
            for name in _INCLUDE.findall(path.read_text()):
                header = path.parent / name
                if header.exists():
                    todo.append(header)
        return found

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for path in self.sources():
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _build(self) -> None:
        """Run ``nvcc`` unless the library is already built; either way
        ``build_log`` holds the compiler's output (kept beside the
        library as ``.log``). Each call counts in ``builds``."""
        self.builds += 1
        out = self.library_path()
        if out.exists():
            log = out.with_suffix(".log")
            self.build_log = log.read_text() if log.exists() else ""
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
        out.with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, out)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if it is not yet."""
        with self._lock:
            if self._lib is None:
                self._build()
                lib = ctypes.CDLL(str(self.library_path()))
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def error_string(self, rc: int) -> str:
        msg = getattr(self.load(), f"{self.name}_error_string")(rc)
        return msg.decode(errors="replace")


class CudaKernel:
    """One C entry point of a :class:`CudaLibrary` (the symbol is the
    kernel's name) and its launch count."""

    def __init__(self, name: str, library: CudaLibrary,
                 argtypes: List[type]):
        self.name = name
        self.library = library
        self.argtypes = argtypes
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None

    @property
    def source(self) -> Path:
        return self.library.source

    def ensure_built(self) -> None:
        with self._lock:
            if self._fn is not None:
                return
            fn = getattr(self.library.load(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch reported an
        error, else count it."""
        if self._fn is None:
            self.ensure_built()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {rc} "
                f"({self.library.error_string(rc)})"
            )
        with self._lock:
            self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int

_FLASH_FWD_LIB = CudaLibrary("flash_fwd", "flash_fwd.cu")
_FLASH_BWD_LIB = CudaLibrary("flash_bwd", "flash_bwd.cu")
_MAX_POOL_LIB = CudaLibrary("max_pool", "max_pool.cu")
LIBRARIES = (_FLASH_FWD_LIB, _FLASH_BWD_LIB, _MAX_POOL_LIB)

#: Flash-attention forward; replaces moolib_tpu/ops/attention.py
#: ``_flash_kernel``.
FLASH_FWD = CudaKernel(
    "flash_fwd", _FLASH_FWD_LIB,
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
#: Flash-attention dQ; replaces ``_flash_bwd_dq_kernel``.
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", _FLASH_BWD_LIB,
    [_P] * 9 + [_I] * 7 + [_P],
)
#: Flash-attention dK/dV; replaces ``_flash_bwd_dkdv_kernel``.
FLASH_BWD_DKDV = CudaKernel(
    "flash_bwd_dkdv", _FLASH_BWD_LIB,
    [_P] * 10 + [_I] * 7 + [_P],
)
#: The whole flash backward (delta, dQ, dK, dV) in one launch at
#: Tq, Tk <= TILE_MAX; replaces both backward kernels there.
FLASH_BWD_TILE = CudaKernel(
    "flash_bwd_tile", _FLASH_BWD_LIB,
    [_P] * 11 + [_I] * 7 + [_P],
)
#: ImpalaNet's 3x3 stride-2 "SAME" max-pool over channels-last tensors,
#: padding inside the kernel; replaces no TPU kernel (the reference pools
#: with flax's ``nn.max_pool``, an XLA op).
MAX_POOL_FWD = CudaKernel("max_pool_same_fwd", _MAX_POOL_LIB,
                          [_P, _P] + [_I] * 9 + [_P])
#: Its backward, the window's argmax found again from the input.
MAX_POOL_BWD = CudaKernel("max_pool_same_bwd", _MAX_POOL_LIB,
                          [_P, _P, _P] + [_I] * 9 + [_P])
KERNELS = (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKDV, FLASH_BWD_TILE,
           MAX_POOL_FWD, MAX_POOL_BWD)
#: The longest Tq and Tk the fused backward kernel takes.
TILE_MAX = 64

_FLASH_D = (32, 64, 128)
#: The dtype codes every kernel's C entry point takes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build_all() -> None:
    """Build every kernel source at once (one ``nvcc`` per source, run
    side by side) and bind every kernel."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for fut in [pool.submit(lib.load) for lib in LIBRARIES]:
            fut.result()
    for kern in KERNELS:
        kern.ensure_built()


def build_count() -> int:
    """First-use builds of every kernel library in this process so far
    (:class:`~moolib_tpu_torch.testing.hotwatch.Hotwatch` counts them as
    its compiles)."""
    return sum(lib.builds for lib in LIBRARIES)


def _check_attention(name: str, q, k, v, seg_q, seg_k, *more):
    """The checks every flash kernel makes of its inputs; returns
    (B, H, Tq, Tk, D)."""
    tensors = (q, k, v, seg_q, seg_k, *more)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name} needs every input on one CUDA device")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(
            f"{name} takes q/k/v of one dtype, float32 or bfloat16; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name} wants q [B,H,Tq,D] and k/v [B,H,Tk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree"
        )
    if D not in _FLASH_D:
        raise ValueError(f"{name} supports head dims {_FLASH_D}, got {D}")
    if seg_q.dtype != torch.int32 or seg_k.dtype != torch.int32:
        raise ValueError("segment ids must be int32")
    if tuple(seg_q.shape) != (B, Tq) or tuple(seg_k.shape) != (B, Tk):
        raise ValueError(
            f"segment ids must be [B,Tq]={(B, Tq)} and [B,Tk]={(B, Tk)}; "
            f"got {tuple(seg_q.shape)}, {tuple(seg_k.shape)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return B, H, Tq, Tk, D


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              seg_q: torch.Tensor, seg_k: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash forward: q [B,H,Tq,D], k/v [B,H,Tk,D] (f32 or
    bf16, one dtype, contiguous and 16-byte aligned, D in 32/64/128),
    seg_q [B,Tq] and seg_k [B,Tk] int32 -> (o [B,H,Tq,D] in v's dtype,
    lse [B*H,1,Tq] f32)."""
    B, H, Tq, Tk, D = _check_attention("flash_fwd", q, k, v, seg_q, seg_k)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        # The kernel copies K and V rows in bulk, 16 bytes at a time.
        raise ValueError("flash_fwd needs q, k and v 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, Tq), dtype=torch.float32, device=q.device)
    _on_device(q.device, FLASH_FWD, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               seg_q.data_ptr(), seg_k.data_ptr(), o.data_ptr(),
               lse.data_ptr(), B * H, H, Tq, Tk, D, int(bool(causal)),
               _DTYPES[q.dtype])
    return o, lse


def _on_device(device: torch.device, kernel: CudaKernel, *args) -> None:
    """Launch ``kernel(*args, stream)`` on ``device``'s current stream,
    switching the current device only when it is another one."""
    if device.index == torch.cuda.current_device():
        kernel.launch(*args, torch.cuda.current_stream(device).cuda_stream)
        return
    with torch.cuda.device(device):
        kernel.launch(*args, torch.cuda.current_stream(device).cuda_stream)


def flash_fwd_design(tq: int, tk: int) -> str:
    """Which design the forward kernel runs at these sequence lengths:
    "wgmma" (tensor cores, TMA-fed key tiles, segment tile skipping) or
    "simt" (one tile of queries and keys, CUDA cores)."""
    fn = _FLASH_FWD_LIB.load().flash_fwd_uses_wgmma
    fn.argtypes = [_I, _I]
    fn.restype = ctypes.c_int
    return "wgmma" if fn(tq, tk) else "simt"


def _check_backward(name: str, q, k, v, seg_q, seg_k, lse, do, delta=None,
                    o=None):
    """The forward's checks, plus dO (and the forward's ``o``) like q,
    lse (and ``delta``) [B*H,1,Tq] f32, and the rows 16-byte aligned;
    returns (B, H, Tq, Tk, D)."""
    more = [t for t in (delta, o) if t is not None]
    B, H, Tq, Tk, D = _check_attention(name, q, k, v, seg_q, seg_k, lse, do,
                                       *more)
    for label, t in (("dO", do), ("o", o)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype):
            raise ValueError(
                f"{name} wants {label} like q {tuple(q.shape)} {q.dtype}; "
                f"got {tuple(t.shape)} {t.dtype}"
            )
    for label, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (B * H, 1, Tq)):
            raise ValueError(
                f"{name} wants {label} [B*H,1,Tq]={(B * H, 1, Tq)} float32; "
                f"got {tuple(t.shape)} {t.dtype}"
            )
    rows = (q, k, v, do) + (() if o is None else (o,))
    if any(t.data_ptr() % 16 for t in rows):
        # Rows come by 16-byte bulk copies (or float4 loads at one tile).
        raise ValueError(f"{name} needs q, k, v, o and dO 16-byte aligned")
    return B, H, Tq, Tk, D


def flash_bwd_design(tq: int, tk: int) -> str:
    """Which backward runs at these sequence lengths: "tile" (one fused
    launch, :func:`flash_bwd_tile`) at Tq, Tk <= TILE_MAX, else "wgmma"
    (:func:`flash_bwd_dq` and :func:`flash_bwd_dkdv` on the tensor
    cores)."""
    return "tile" if tq <= TILE_MAX and tk <= TILE_MAX else "wgmma"


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 seg_q: torch.Tensor, seg_k: torch.Tensor, lse: torch.Tensor,
                 delta: torch.Tensor, do: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """Launch the flash dQ kernel: the forward's inputs, its ``lse``,
    ``delta`` = rowsum(dO * o) [B*H,1,Tq] f32 and dO like q (all
    contiguous, q, k, v and dO 16-byte aligned) -> dq in q's dtype."""
    B, H, Tq, Tk, D = _check_backward("flash_bwd_dq", q, k, v, seg_q, seg_k,
                                      lse, do, delta=delta)
    dq = torch.empty_like(q)
    _on_device(q.device, FLASH_BWD_DQ, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), seg_q.data_ptr(), seg_k.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(),
               B * H, H, Tq, Tk, D, int(bool(causal)), _DTYPES[q.dtype])
    return dq


def flash_bwd_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seg_q: torch.Tensor, seg_k: torch.Tensor,
                   lse: torch.Tensor, delta: torch.Tensor, do: torch.Tensor,
                   causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the flash dK/dV kernel: the arguments of
    :func:`flash_bwd_dq` -> (dk, dv) in k's and v's dtype."""
    B, H, Tq, Tk, D = _check_backward("flash_bwd_dkdv", q, k, v, seg_q,
                                      seg_k, lse, do, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _on_device(q.device, FLASH_BWD_DKDV, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), seg_q.data_ptr(), seg_k.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), B * H, H, Tq, Tk, D, int(bool(causal)),
               _DTYPES[q.dtype])
    return dk, dv


def flash_bwd_tile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seg_q: torch.Tensor, seg_k: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the one-tile flash backward (Tq, Tk <= TILE_MAX): the
    forward's inputs, its ``o`` (like q) and ``lse``, and dO like q (all
    contiguous, q, k, v, o and dO 16-byte aligned) -> (dq, dk, dv) in the
    inputs' dtype. delta comes from o inside the kernel."""
    B, H, Tq, Tk, D = _check_backward("flash_bwd_tile", q, k, v, seg_q,
                                      seg_k, lse, do, o=o)
    if flash_bwd_design(Tq, Tk) != "tile":
        raise ValueError(f"flash_bwd_tile takes Tq, Tk <= {TILE_MAX}; got "
                         f"{Tq}, {Tk}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _on_device(q.device, FLASH_BWD_TILE, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), seg_q.data_ptr(), seg_k.data_ptr(), o.data_ptr(),
               lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
               dv.data_ptr(), B * H, H, Tq, Tk, D, int(bool(causal)),
               _DTYPES[q.dtype])
    return dq, dk, dv


def _check_pool(name: str, x: torch.Tensor, pads_h: Tuple[int, int],
                pads_w: Tuple[int, int]) -> Tuple[int, int]:
    """The checks both max-pool kernels make of the input and the pads;
    returns the output's (Ho, Wo)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16; got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} wants x [N,C,H,W]; got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor; got {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} needs a channels-last contiguous x")
    if not all(0 <= p < 3 for p in (*pads_h, *pads_w)):
        # A window must hold at least one pixel of the input.
        raise ValueError(f"{name} takes pads of 0 to 2; got {pads_h}, "
                         f"{pads_w}")
    H, W = x.shape[2:]
    return (H + sum(pads_h) - 3) // 2 + 1, (W + sum(pads_w) - 3) // 2 + 1


def max_pool_same_fwd(x: torch.Tensor, pads_h: Tuple[int, int],
                      pads_w: Tuple[int, int]) -> torch.Tensor:
    """Launch the 3x3 stride-2 max-pool forward: x [N,C,H,W]
    channels-last contiguous (f32 or bf16), padded (top, bottom) by
    ``pads_h`` and (left, right) by ``pads_w`` with -inf -> [N,C,Ho,Wo]
    channels-last, in x's dtype."""
    Ho, Wo = _check_pool("max_pool_same_fwd", x, pads_h, pads_w)
    N, C, H, W = x.shape
    y = torch.empty((N, C, Ho, Wo), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel():
        _on_device(x.device, MAX_POOL_FWD, x.data_ptr(), y.data_ptr(), N, H,
                   W, C, Ho, Wo, pads_h[0], pads_w[0], _DTYPES[x.dtype])
    return y


def max_pool_same_bwd(x: torch.Tensor, gy: torch.Tensor,
                      pads_h: Tuple[int, int],
                      pads_w: Tuple[int, int]) -> torch.Tensor:
    """Launch the max-pool backward: the forward's x and pads and the
    output's gradient gy (like the output, channels-last contiguous) ->
    x's gradient, like x."""
    Ho, Wo = _check_pool("max_pool_same_bwd", x, pads_h, pads_w)
    N, C, H, W = x.shape
    if (tuple(gy.shape) != (N, C, Ho, Wo) or gy.dtype != x.dtype
            or gy.device != x.device):
        raise ValueError(
            f"max_pool_same_bwd wants gy {(N, C, Ho, Wo)} {x.dtype} on "
            f"{x.device}; got {tuple(gy.shape)} {gy.dtype} on {gy.device}"
        )
    if not gy.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max_pool_same_bwd needs a channels-last "
                         "contiguous gy")
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    if gx.numel():
        _on_device(x.device, MAX_POOL_BWD, x.data_ptr(), gy.data_ptr(),
                   gx.data_ptr(), N, H, W, C, Ho, Wo, pads_h[0], pads_w[0],
                   _DTYPES[x.dtype])
    return gx
