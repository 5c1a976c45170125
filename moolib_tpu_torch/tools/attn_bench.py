"""Attention backend benchmark of the port: dense vs blockwise vs flash as
steps/s and attention TFLOP/s at long context; the twin of the
reference's ``tools/attn_bench.py``.

1. validates the flash forward and backward on ``--device`` against the
   dense oracle (on the card: the hand-written kernels; on the CPU their
   plain versions), with the reference's tolerances, recorded in the
   artifact;
2. times a training-shaped step (attention, then the backward of a sum
   of squares) per backend with
   :func:`~moolib_tpu_torch.utils.benchmark.time_chained` at the
   reference's ``(B, H, D) = (1, 8, 128)``, T in {2048, 8192}, causal:
   dense only at T <= 4096, bf16 on the card and f32 on the CPU, with
   steps/s and attention TFLOP/s against the card's peak
   (:func:`~moolib_tpu_torch.utils.flops.device_peak_flops`).

``zigzag`` needs a sequence-parallel axis of more than one device; with
one device it gets a skip note, as the reference skips it with one
device. A flash failure raises; a dense or blockwise row that fails (out
of memory) is recorded with its error, as in the reference.

Usage::

    python -m moolib_tpu_torch.tools.attn_bench [--json OUT] [--quick]
        [--budget SECONDS] [--device cpu]

Per-(backend, T) rows also land as perfwatch trend rows when
``MOOLIB_TRENDS`` names a store. Exits 1 when the validation fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..bench.harness import append_device_trend
from ..ops import attention as attn_mod
from ..utils.benchmark import time_chained
from ..utils.device import resolve_device
from ..utils.flops import device_peak_flops

CMD = "python -m moolib_tpu_torch.tools.attn_bench"
#: The reference's validation tolerances (its tools/attn_bench.py:172-173):
#: the forward's max error against the dense oracle, bf16 and f32, and the
#: gradients' (which scale with T).
FWD_TOL = {torch.bfloat16: 0.05, torch.float32: 2e-2}
BWD_TOL = 1.0
#: The reference's shapes: (B, H, D) and the sequence lengths, full and
#: ``--quick``.
SHAPE, QUICK_SHAPE = (1, 8, 128), (1, 4, 64)
SEQ_LENS, QUICK_SEQ_LENS = (2048, 8192), (512,)


def attention_flops(B, H, T, D, causal=True):
    """Model FLOPs for one attention forward: QK^T + PV, 2 MACs each;
    causal halves the realized score work. Train step = 3.5x fwd (bwd
    recomputes + two matmul-shaped products per einsum)."""
    full = 2 * 2 * B * H * T * T * D
    return full // 2 if causal else full


BACKENDS = {
    "dense": attn_mod.dense_attention,
    "blockwise": attn_mod.blockwise_attention,
    "flash": attn_mod.flash_attention,
}


def _grad_fn(backend):
    inner = BACKENDS[backend]

    def grad_fn(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = inner(q, k, v, causal=True)
        loss = (o.float() ** 2).sum()
        return torch.autograd.grad(loss, (q, k, v))

    return grad_fn


def _time_grad_step(grad_fn, q, k, v, iters=5):
    """Chained timing: iteration i+1's q depends on iteration i's dq (a
    1e-30-scaled nudge keeps the data dependency real without changing
    the numerics), so no application can be skipped or reordered."""

    def step(c):
        q, k, v = c
        dq, _dk, _dv = grad_fn(q, k, v)
        return (q + (dq * 1e-30).to(q.dtype), k, v)

    _, dt, _first_s = time_chained(step, (q, k, v), iters=iters)
    return dt / iters


def _inputs(B, H, T, D, dtype, device, seed=0, scale=0.1):
    gen = torch.Generator().manual_seed(seed)
    return tuple((torch.randn((B, H, T, D), generator=gen) * scale)
                 .to(device=device, dtype=dtype) for _ in range(3))


def bench_backend(backend, B, H, T, D, dtype, iters, device):
    """Seconds per training-shaped step of ``backend`` at [B, H, T, D]."""
    q, k, v = _inputs(B, H, T, D, dtype, device)
    return _time_grad_step(_grad_fn(backend), q, k, v, iters=iters)


def validate_flash(dtype, device, D=128):
    """Flash fwd+bwd against the dense oracle at [2, 2, 512, D], causal:
    ``(ok, max_err_fwd, max_err_bwd)``."""
    q, k, v = _inputs(2, 2, 512, D, dtype, device, seed=1, scale=0.2)

    def run(fn):
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o = fn(qg, kg, vg, causal=True)
        grads = torch.autograd.grad((o.float() ** 2).sum(), (qg, kg, vg))
        return o, grads

    fo, fg = run(attn_mod.flash_attention)
    do, dg = run(attn_mod.dense_attention)
    err_fwd = float((fo.detach().float() - do.detach().float()).abs().max())
    err_bwd = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(fg, dg))
    ok = err_fwd < FWD_TOL[dtype] and err_bwd < BWD_TOL
    return ok, err_fwd, err_bwd


def run(quick=False, budget=600.0, device=None, log=print) -> dict:
    """The benchmark; returns the artifact (``rows`` and the validation)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    peak = device_peak_flops(kind) if cuda else None
    B, H, D = QUICK_SHAPE if quick else SHAPE
    iters = 2 if quick else 5
    Ts = QUICK_SEQ_LENS if quick else SEQ_LENS

    t_start = time.monotonic()
    ok, ef, eb = validate_flash(dtype, device, D)
    art = {
        "cmd": CMD,
        "platform": device.type,
        "device_kind": kind,
        "dtype": str(dtype).replace("torch.", ""),
        "flash_validation": {
            "ok": ok, "max_err_fwd": ef, "max_err_bwd": eb,
            "tol_fwd": FWD_TOL[dtype], "tol_bwd": BWD_TOL,
            "shape": [2, 2, 512, D],
            "note": ("the hand-written kernels vs the dense oracle"
                     if cuda else "the kernels' plain versions (CPU) vs "
                     "the dense oracle"),
        },
        "rows": [],
    }
    log(json.dumps({"flash_validation": art["flash_validation"]}))

    for T in Ts:
        for backend in ("dense", "blockwise", "flash", "zigzag"):
            if time.monotonic() - t_start > budget:
                art["rows"].append({"note": "budget exhausted", "T": T})
                break
            if backend == "zigzag":
                art["rows"].append({
                    "backend": "zigzag", "T": T,
                    "note": "skipped: zigzag needs sp > 1 (one device)"})
                continue
            if backend == "dense" and T > 4096:
                continue  # O(T^2) materialized scores: skip
            try:
                dt = bench_backend(backend, B, H, T, D, dtype, iters, device)
            except Exception as e:
                if backend == "flash":
                    raise  # a kernel failure is a failure
                art["rows"].append({
                    "backend": backend, "T": T,
                    "error": f"{type(e).__name__}: {e}"[:300],
                })
                continue
            fl = 3.5 * attention_flops(B, H, T, D)  # fwd+bwd
            row = {
                "backend": backend, "T": T, "B": B, "H": H, "D": D,
                "ms_per_step": round(dt * 1e3, 4),
                "steps_per_sec": round(1.0 / dt, 2),
                "attn_tflops": round(fl / dt / 1e12, 3),
            }
            if peak:
                row["attn_mfu"] = round(fl / dt / peak, 4)
            art["rows"].append(row)
            log(json.dumps(row))
            append_device_trend(
                f"attn_{backend}_T{T}_steps_per_sec",
                row["steps_per_sec"], "steps/s", CMD + (
                    " --quick" if quick else ""),
                extra={"backend": backend, "T": T, "D": D,
                       "attn_tflops": row["attn_tflops"]},
            )

    # Headline comparison: flash vs blockwise at the longest measured T.
    timed = {(r["backend"], r["T"]): r for r in art["rows"]
             if "ms_per_step" in r}
    common = [T for T in Ts if ("flash", T) in timed
              and ("blockwise", T) in timed]
    if common:
        T = max(common)
        art["flash_vs_blockwise"] = {
            "T": T,
            "speedup": round(timed[("blockwise", T)]["ms_per_step"]
                             / timed[("flash", T)]["ms_per_step"], 2),
        }
    art["seconds"] = round(time.monotonic() - t_start, 1)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="small shapes / fewer iters (smoke)")
    ap.add_argument("--budget", type=float, default=600.0,
                    help="soft wall-clock budget in seconds")
    ap.add_argument("--device", default=None,
                    help="default: the card")
    args = ap.parse_args(argv)
    art = run(args.quick, args.budget, args.device)
    print(json.dumps({k: v for k, v in art.items() if k != "rows"}),
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
    return 0 if art["flash_validation"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
