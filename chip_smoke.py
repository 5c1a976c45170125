#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name, capability and power limit; needs sm_90.
2. Build: every hand-written kernel from the sources in the checkout, one
   nvcc per source, all started together; registers and spills of every
   instantiation, and the tensor-core and bulk-copy instructions in the
   SASS (every wgmma instantiation must contain HGMMA).
3. Forward kernel vs plain: the flash forward's wrapper on the card, held
   against its plain PyTorch version on the same inputs (the main paths'
   shapes included, the context window with and without episode resets),
   with the kernel's, the plain version's and a library call's times
   (CUDA events and profiler device time), the card's least time for the
   same work, and the wrapper's host time per call by part.
4. Backward vs plain: the flash backward on o and lse from the forward
   kernel and a seeded dO, each case through the design its shape picks
   (the fused one-tile kernel at Tq, Tk <= 64, the dQ and dK/dV kernels
   past it), over the forward's segment layouts; times as in phase 3,
   with SDPA's backward as the library call.
5. Serve: the full-width TransformerNet behind two Replicas (the act
   step at T=1 and a 2048-step context window), a few requests each,
   replies held against the same forward with plain dense attention
   on the CPU; the forward kernel's launch count must rise during each
   service. Telemetry (the phase's own Telemetry): each replica's
   serving_admitted_total == serving_completed_total == the requests
   sent, no rejection, shed or failure, serving_batch_rows_total equal
   to the fill histogram's sum times the batch size, one replica step a
   batch. Those first requests warm the replica; then STEADY_WAVES more
   waves of 4 requests each, two waves in flight, every reply held as
   above, give the steady {service}_replica ledger (queue_wait, linger,
   infer, other): the difference of the scope's cumulative counters
   from the warm-up's, and per-batch medians, beside the requests a
   second and the batch forward's CUDA-event time. The registry's
   Prometheus text parsed by the port's parse_prometheus into the
   values of snapshot().
6. Train: 3 IMPALA/V-trace steps of the full-width TransformerNet on
   learn batches [T+1=21, B=32], held against the same steps with dense
   attention on the CPU; each step must launch the forward and the fused
   backward kernel twice (once per layer), the dQ and dK/dV kernels and
   the two-kernel design's delta ops never; the grad-step / apply-step
   split must give the same result; steady-state step time and one step
   under torch.profiler, with the CUDA API calls (cuda* and cu*) the
   host made in it (those that can block it counted apart: synchronizes,
   allocations, frees). Then the StepScope ledgers (the phase's own
   Telemetry): 8 steps of the fused step built with stepscope= (staging
   the learn batch from the host, fwd_bwd, host_sync reading the metrics
   back), still two forward and two fused backward launches a step, and
   8 of the grad/apply split (fwd_bwd, optimizer), every scoped call
   under CUDA's sync debug mode "error" (a scoped step must not wait
   for the device); each phase's median, other and the host-blocked
   fraction beside the profiler's device-busy time; every ledger must
   close (overrun gauge 0, phases summing to the wall time); and
   telemetry's cost, stepscope=None against a live scope in (plain,
   scoped, scoped, plain) turns, reported, not gated.
7. Context backward: autograd through attention(backend="auto") at the
   context shape with the repo's resets, held against dense attention's
   autograd on the card; the dQ and dK/dV kernels launch once each.
8. Impala learner: the full-width ImpalaNet (experiment.py's default
   model on pixel envs) trained 3 steps on learn batches [T+1=21, B=32]
   with experiment.py's RMSprop chain, in f32 and in bf16, held against
   the same steps on the CPU; the grad-step / apply-step split; the
   steady step's time and one step profiled (device time by kernel
   class, the forward's, V-trace's and the optimizer's spans); the LSTM
   variant's act step for 32 envs, its state threaded over 4 steps,
   against the CPU; then bench_torch.py at B=256 (its JSON line) and one
   of its steps profiled. No flash kernel runs on this path. The f32
   and bf16 train steps get phase 6's ledgers and cost, and the act
   step its own (act, then host_sync reading the actions and logits
   back).
9. Flight bundles: one incident bundle per phase's Telemetry (serve,
   train, impala), captured through the api trigger into
   build/flightrec/; each must load and validate, record only MOOLIB,
   TORCH, PYTORCH, CUDA and NCCL environment keys, and (train and
   impala) carry a step_phases event of every scoped loop.
10. The kernels line (with the ledgers and the bundles' summaries), the
    card line, and the result line.

Lines tagged [telemetry], [stepscope] and [flightrec] carry the
observability checks and readings.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
# f32 on the CUDA cores, bf16 and TF32 on the tensor cores.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}

ACT_ENVS = 32          # environments per act request
CONTEXT_T = 2048       # steps per context request (the model's max_len)
BATCH = 4              # Replica batch_size for both services
# Replies vs the same forward with dense attention on the CPU: f32
# summation order only (the model keeps cuDNN's TF32 off).
SERVE_TOL = 1e-4
# The repo's traffic: experiment.py's synthetic env ends every episode
# after exactly 200 steps (VtraceConfig.episode_length at
# moolib_tpu/examples/vtrace/experiment.py:56, SyntheticAtari.step in
# moolib_tpu/examples/envs.py), so each env resets once every 200 steps,
# at a phase of its own.
EPISODE_LENGTH = 200
ACT_SHAPE = (BATCH * ACT_ENVS, 4, 1, 32)     # [B, H, T, D] of the act step
CONTEXT_SHAPE = (BATCH, 4, CONTEXT_T, 32)    # [B, H, T, D] of a context batch
# The learn batch of moolib_tpu/examples/vtrace/experiment.py:61-63:
# learn_batch_size 32 envs, unroll_length 20 (+1 bootstrap frame).
LEARN_B, UNROLL = 32, 20
TRAIN_SHAPE = (LEARN_B, 4, UNROLL + 1, 32)   # [B, H, T, D] of a train step
TRAIN_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters: int = 20):
    """Mean device time of the CUDA kernels whose name holds ``kernel``
    (every kernel when ``kernel`` is None) over ``iters`` calls of ``fn``,
    from a torch.profiler trace (host gaps between launches excluded);
    None if the trace has no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A trace now and then comes back without the kernels' records; such a
    # trace is taken again (three tries).
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if kernel is None or kernel in e.key)
        if us:
            return us / iters / 1e3
    return None


def episode_segments(gen: torch.Generator, B: int, T: int,
                     every: int = EPISODE_LENGTH) -> torch.Tensor:
    """[B, T] int32 segment ids of lanes that reset every ``every`` steps
    (EPISODE_LENGTH, the repo's traffic, unless given), each at a random
    phase."""
    phase = torch.randint(0, every, (B, 1), generator=gen, device="cuda")
    done = (torch.arange(T, device="cuda") + phase) % every == 0
    return torch.cumsum(done.int(), dim=1, dtype=torch.int32)


def visible_pairs(seg_q, seg_k, H: int, causal: bool) -> int:
    """(query, key) pairs the function must compute: same segment and,
    when causal, key <= query; counted from this run's segment ids."""
    total = 0
    Tq, Tk = seg_q.shape[1], seg_k.shape[1]
    for b in range(seg_q.shape[0]):
        vis = seg_q[b][:, None] == seg_k[b][None, :]
        if causal:
            vis &= (torch.arange(Tq, device=vis.device)[:, None]
                    >= torch.arange(Tk, device=vis.device)[None, :])
        total += int(vis.sum())
    return total * H


def flash_bound_ms(q, k, seg_q, seg_k, causal: bool):
    """Least time for the flash forward on this card: bytes (q, k, v, o
    and segment ids read or written once, lse written once) over HBM
    bandwidth, against 4*D FLOPs per visible pair at the fastest rate
    that keeps the input type's accuracy: bf16 on the tensor cores; f32
    either on the CUDA cores or as 3xTF32 (three TF32 products for each)
    on the tensor cores, whichever is faster. Returns
    (ms, "bytes" | "operations")."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    item = q.element_size()
    nbytes = (2 * B * H * Tq * D + 2 * B * H * Tk * D) * item
    nbytes += B * H * Tq * 4 + (B * Tq + B * Tk) * 4
    flops = 4 * D * visible_pairs(seg_q, seg_k, H, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    if q.dtype == torch.float32:
        t_ops = min(t_ops, 3 * flops / PEAK_FLOPS["tf32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_bounds_ms(q, k, seg_q, seg_k, causal: bool):
    """Least times of the backward kernels on this card: bytes (each input
    read once: q, k, v, dO, lse and segment ids, with delta for the dQ and
    dK/dV kernels or o for the fused one; the outputs written once) over
    HBM bandwidth, against FLOPs per visible pair (dQ 6*D: s, dp, dQ; dK/dV
    8*D: s, dp, dV, dK; the fused kernel 10*D: s and dp once, then dQ, dK
    and dV, plus 2*D a row for delta) at the fastest rate that keeps the
    input type's accuracy, as for the forward: bf16 on the tensor cores;
    f32 the faster of the CUDA cores and 3xTF32. Returns {kernel: (ms,
    by)}."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    item = q.element_size()
    rows_q, rows_k = B * H * Tq * D * item, B * H * Tk * D * item
    ins = 2 * rows_q + 2 * rows_k + B * H * Tq * 4 + (B * Tq + B * Tk) * 4
    pairs = visible_pairs(seg_q, seg_k, H, causal)
    out = {}
    for name, nbytes, flops in (
        ("flash_bwd_dq", ins + B * H * Tq * 4 + rows_q, 6 * D * pairs),
        ("flash_bwd_dkdv", ins + B * H * Tq * 4 + 2 * rows_k, 8 * D * pairs),
        ("flash_bwd_tile", ins + rows_q + rows_q + 2 * rows_k,
         10 * D * pairs + 2 * D * B * H * Tq),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[q.dtype]
        if q.dtype == torch.float32:
            t_ops = min(t_ops, 3 * flops / PEAK_FLOPS["tf32"])
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def layout_segments(layout: str, gen: torch.Generator, B: int, Tq: int,
                    Tk: int):
    """(seg_q, seg_k) int32 of a segment layout: "episodes" (a reset every
    EPISODE_LENGTH steps), "none" (no reset in the window), "kv masked"
    (the second half of the queries has a segment no key has),
    "alternating" (ids that go back and forth: no tile can be skipped),
    "boundaries" (at a multiple of 64 and one step either side of one),
    "disjoint" (kv ids no query shares: every row fully masked) and
    "tq_ne_tk" (resets every 70 steps, Tq != Tk)."""
    t = torch.arange(Tq, device="cuda")
    if layout == "episodes":
        seg_q = episode_segments(gen, B, Tq)
    elif layout == "none":
        seg_q = torch.zeros((B, Tq), dtype=torch.int32, device="cuda")
    elif layout == "kv masked":
        seg_q = episode_segments(gen, B, Tq)
        seg_q[:, Tq // 2:] = 7
        return seg_q, torch.zeros((B, Tk), dtype=torch.int32, device="cuda")
    elif layout == "alternating":
        seg_q = ((t // 37) % 2).int().expand(B, Tq).contiguous()
    elif layout == "boundaries":
        seg_q = ((t >= 128).int() + (t >= 191).int() + (t >= 257).int())
        seg_q = seg_q.expand(B, Tq).contiguous()
    elif layout == "disjoint":
        return (episode_segments(gen, B, Tq, 40),
                episode_segments(gen, B, Tk, 40) + 1000)
    elif layout == "tq_ne_tk":
        return (episode_segments(gen, B, Tq, 70),
                episode_segments(gen, B, Tk, 70))
    else:
        raise ValueError(layout)
    return seg_q, seg_q


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} capability {cap} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card (H100); got {cap}")
    return name, smi


def _ptxas_lines(log: str):
    """(kernel, line) for each register, spill, warning or performance
    line of ptxas -v (C7515-C7520 say that the wgmmas were serialized)."""
    name = "?"
    for line in log.splitlines():
        m = re.search(r"(flash_[a-z_]+_kernel)ILi(\d+)E(f|13__nv_bfloat16)",
                      line)
        if m and ("Compiling entry" in line or "Function properties" in line):
            dtype = "f32" if m.group(3) == "f" else "bf16"
            name = f"{m.group(1)}<D={m.group(2)},{dtype}>"
        elif any(w in line for w in ("registers", "spill", "warning",
                                     "Performance Loss")):
            yield name, line.strip()


def _sass_counts(library) -> dict:
    """{kernel<D,dtype>: {instruction: count}} of the tensor-core and
    bulk-copy instructions in each kernel of a built library, from
    cuobjdump -sass (the toolkit's)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_[a-z_]+_kernel)ILi(\d+)E(f|13__nv_bfloat16)",
                          line)
            name = None
            if m:
                dtype = "f32" if m.group(3) == "f" else "bf16"
                name = f"{m.group(1)}<D={m.group(2)},{dtype}>"
                counts[name] = {}
        elif name is not None:
            for ins in ("HGMMA", "HMMA", "UBLKCP"):
                if re.search(rf"\b{ins}\b", line):
                    counts[name][ins] = counts[name].get(ins, 0) + 1
    return counts


def phase_build():
    from moolib_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build_all()
    log(f"[build] {len(_kernels.KERNELS)} kernels from "
        f"{len(_kernels.LIBRARIES)} sources ready in "
        f"{time.perf_counter() - t0:.1f}s (nvcc in parallel: "
        + ", ".join(f"{lib.source.name} {lib.build_seconds}s"
                    for lib in _kernels.LIBRARIES) + ")")
    for lib in _kernels.LIBRARIES:
        lines = list(_ptxas_lines(lib.build_log))
        for name, line in lines:
            log(f"[build] {lib.source.name} {name}: {line}")
        entries = set(re.findall(
            r"Compiling entry function '\S*?(flash_\w+_kernelILi\d+E\w+?)E",
            lib.build_log))
        with_regs = {name for name, line in lines if "registers" in line}
        if not entries or len(with_regs) < len(entries):
            raise RuntimeError(f"{lib.source.name}: ptxas register lines "
                               f"for {len(with_regs)} of {len(entries)} "
                               f"kernels")
    counts = {}
    for lib in _kernels.LIBRARIES:
        lib_counts = _sass_counts(lib.library_path())
        for name, c in sorted(lib_counts.items()):
            log(f"[build] {lib.source.name} {name} SASS: {c.get('HGMMA', 0)} "
                f"HGMMA, {c.get('HMMA', 0)} HMMA, {c.get('UBLKCP', 0)} UBLKCP")
        counts.update(lib_counts)
    # Every wgmma design's instantiation (3 head dims x 2 dtypes) must
    # contain tensor-core instructions.
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkdv_kernel"):
        found = [n for n in counts if n.startswith(kernel + "<")]
        if len(found) != 6 or any(not counts[n].get("HGMMA") for n in found):
            raise RuntimeError(f"{kernel}'s instantiations lack tensor-core "
                               f"instructions: "
                               f"{ {n: counts[n] for n in found} }")
    return counts


def _compare(o, lse, o_ref, lse_ref, o_tol_fn):
    if not torch.equal(torch.isinf(lse), torch.isinf(lse_ref)):
        raise RuntimeError("kernel and plain disagree on fully masked rows")
    fin = torch.isfinite(lse_ref)
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() else 0.0
    o_err_t = (o.float() - o_ref.float()).abs()
    ok = bool((o_err_t <= o_tol_fn(o_ref.float().abs())).all())
    return float(o_err_t.max()), lse_err, ok


def wrapper_host_us(q, k, v, sq, sk, causal, iters: int = 200) -> dict:
    """Host time per call of the forward's wrapper (no synchronize in the
    loop, the launches queue) and of its parts: the input checks, the two
    output allocations, the stream lookup and the ctypes call with the
    launch itself."""
    from moolib_tpu_torch.ops import _kernels

    B, H, Tq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, Tq), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sq.data_ptr(),
            sk.data_ptr(), o.data_ptr(), lse.data_ptr(), B * H, H, Tq,
            k.shape[2], D, int(causal), 0 if q.dtype == torch.float32 else 1,
            stream)
    def switch():
        with torch.cuda.device(q.device):
            pass

    parts = {
        "wrapper": lambda: _kernels.flash_fwd(q, k, v, sq, sk, causal),
        "checks": lambda: _kernels._check_attention("flash_fwd", q, k, v, sq,
                                                    sk),
        "allocations": lambda: (torch.empty_like(q), torch.empty(
            (B * H, 1, Tq), dtype=torch.float32, device="cuda")),
        "stream": lambda: torch.cuda.current_stream(q.device).cuda_stream,
        "ctypes call + launch": lambda: _kernels.FLASH_FWD._fn(*args),
        # What the wrapper no longer pays when the card is already the
        # current device: entering and leaving torch.cuda.device.
        "device switch (skipped)": switch,
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
    return out


def phase_kernel_vs_plain():
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import _flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32_tol = lambda ref: 1e-4  # noqa: E731  summation order only
    # bf16 output: one rounding of the f32 result, 2**-7 relative.
    bf16_tol = lambda ref: 2.0 ** -7 * ref + 1e-5  # noqa: E731
    cases = [
        # name, (B, H, Tq, D), Tk, dtype, causal, segment ids: "episodes"
        # (resets every EPISODE_LENGTH steps), "none" (no reset in the
        # window) or "kv masked" (some query rows see no key)
        ("context (main path)", CONTEXT_SHAPE, CONTEXT_T, torch.float32,
         True, "episodes"),
        ("context (no resets)", CONTEXT_SHAPE, CONTEXT_T, torch.float32,
         True, "none"),
        ("act (main path)", ACT_SHAPE, 1, torch.float32, True, "episodes"),
        ("train (main path)", TRAIN_SHAPE, UNROLL + 1, torch.float32, True,
         "episodes"),
        ("B*H=32 T=2048 f32", (8, 4, 2048, 32), 2048, torch.float32, True,
         "episodes"),
        ("B*H=32 T=2048 bf16", (8, 4, 2048, 32), 2048, torch.bfloat16,
         True, "episodes"),
        ("T=20 unroll", (32, 4, 20, 32), 20, torch.float32, True,
         "episodes"),
        ("non-causal masked rows D=64", (2, 4, 256, 64), 384,
         torch.float32, False, "kv masked"),
        ("causal D=128 bf16", (2, 2, 512, 128), 512, torch.bfloat16, True,
         "episodes"),
        ("causal D=128 f32 ragged", (2, 2, 300, 128), 300, torch.float32,
         True, "episodes"),
    ]
    results = {}
    for name, (B, H, Tq, D), Tk, dtype, causal, segs in cases:
        q = torch.randn((B, H, Tq, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, H, Tk, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, H, Tk, D), generator=gen, device="cuda").to(dtype)
        seg_q = episode_segments(gen, B, Tq)
        if segs == "none":
            seg_q = torch.zeros_like(seg_q)
        if segs == "kv masked":
            # Keys carry segments no query of the second half has.
            seg_k = torch.zeros((B, Tk), dtype=torch.int32, device="cuda")
            seg_q[:, Tq // 2:] = 7
        else:
            seg_k = seg_q
        o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = _flash_forward_plain(q, k, v, seg_q, seg_k, causal)
        tol = bf16_tol if dtype == torch.bfloat16 else f32_tol
        o_err, lse_err, ok = _compare(o, lse, o_ref, lse_ref, tol)
        if segs == "kv masked" and not torch.isinf(lse).any():
            raise RuntimeError("masked-rows case produced no masked row")
        if lse_err > 1e-4:
            ok = False
        tol_txt = ("2^-7*|o|+1e-5" if dtype == torch.bfloat16 else "1e-4")
        design = _kernels.flash_fwd_design(Tq, Tk)
        log(f"[kernel] flash_fwd {name}: q {tuple(q.shape)} Tk {Tk} "
            f"{str(dtype)[6:]} causal={causal} design {design} | "
            f"max|o-plain| {o_err:.3e} (tol {tol_txt}) max|lse-plain| "
            f"{lse_err:.3e} (tol 1e-4) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_fwd disagrees with plain on {name}")
        results[name] = dict(q=q, k=k, v=v, seg_q=seg_q, seg_k=seg_k,
                             causal=causal, o_err=o_err, lse_err=lse_err,
                             design=design)

    timings = {}
    for name in ("context (main path)", "context (no resets)",
                 "act (main path)", "train (main path)", "B*H=32 T=2048 f32",
                 "B*H=32 T=2048 bf16"):
        r = results[name]
        q, k, v, sq, sk, causal = (r["q"], r["k"], r["v"], r["seg_q"],
                                   r["seg_k"], r["causal"])

        def kernel():
            return _kernels.flash_fwd(q, k, v, sq, sk, causal)

        ms = cuda_ms(kernel, 20)
        dev_ms = device_ms(kernel, "flash_fwd_")
        plain_ms = cuda_ms(
            lambda: _flash_forward_plain(q, k, v, sq, sk, causal), 5)
        Tq, Tk = q.shape[2], k.shape[2]
        mask = sq[:, None, :, None] == sk[:, None, None, :]
        if causal:
            mask = mask & torch.ones((Tq, Tk), dtype=torch.bool,
                                     device="cuda").tril()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)

        lib_ms = cuda_ms(library, 20)
        lib_dev_ms = device_ms(library, None)
        if dev_ms is None or lib_dev_ms is None:
            raise RuntimeError(f"no profiler device time for {name}: kernel "
                               f"{dev_ms}, sdpa {lib_dev_ms}")
        bound_ms, bound_by = flash_bound_ms(q, k, sq, sk, causal)
        # The same work with no episode reset in the window: the whole
        # causal triangle is visible.
        no_reset_ms, _ = flash_bound_ms(q, k, torch.zeros_like(sq),
                                        torch.zeros_like(sk), causal)
        timings[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library_device_ms=lib_dev_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_ms_no_resets=no_reset_ms,
                             design=r["design"])
        log(f"[kernel] flash_fwd {name} timing ({r['design']}): kernel "
            f"{ms:.4f} ms (profiler device time {dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device {lib_dev_ms:.4f}"
            f" ms), bound {bound_ms:.4f} ms ({bound_by}), bound with no "
            f"resets {no_reset_ms:.4f} ms; device/bound "
            f"{dev_ms / bound_ms:.1f}x")
    r = results["train (main path)"]
    host = wrapper_host_us(r["q"], r["k"], r["v"], r["seg_q"], r["seg_k"],
                           r["causal"])
    timings["train (main path)"]["host_us"] = host
    log("[kernel] flash_fwd wrapper host time per call at the train shape "
        "(us): " + ", ".join(f"{n} {us:.2f}" for n, us in host.items()))
    return results, timings


def phase_backward_vs_plain():
    """The backward against the plain backward on the same inputs, each
    case through the design its shape picks (one fused launch at Tq, Tk
    <= 64, the dQ and dK/dV kernels past it): o and lse from the forward
    kernel, dO from a seeded generator, the forward's segment layouts.
    Tolerance: f32, 1e-4 of the gradient's largest entry (summation order
    over up to 2048 terms); bf16 gradients, one rounding of the f32 result
    on top (2**-7 relative); dq exactly 0 on fully masked rows."""
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import (
        _flash_backward,
        _flash_backward_plain,
        _flash_delta,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, H, Tq, D), Tk, dtype, causal, segment layout
        ("train (main path)", TRAIN_SHAPE, UNROLL + 1, f32, True, "episodes"),
        ("train bf16", TRAIN_SHAPE, UNROLL + 1, bf16, True, "episodes"),
        ("one tile T=64 D=128 masked rows", (2, 4, 64, 128), 64, f32, False,
         "kv masked"),
        ("context (main path)", CONTEXT_SHAPE, CONTEXT_T, f32, True,
         "episodes"),
        ("context (no resets)", CONTEXT_SHAPE, CONTEXT_T, f32, True, "none"),
        ("B*H=32 T=2048 bf16", (8, 4, 2048, 32), 2048, bf16, True,
         "episodes"),
        ("ragged T=100 D=64", (2, 4, 100, 64), 100, f32, True, "episodes"),
        ("ragged T=100 D=128", (2, 4, 100, 128), 100, f32, True, "episodes"),
        ("ragged T=100 D=128 bf16", (2, 4, 100, 128), 100, bf16, True,
         "episodes"),
        ("non-causal masked rows D=64", (2, 4, 256, 64), 384, f32, False,
         "kv masked"),
        ("alternating T=300", (2, 4, 300, 32), 300, f32, True, "alternating"),
        ("boundaries T=320", (2, 4, 320, 32), 320, f32, True, "boundaries"),
        ("disjoint T=100", (2, 4, 100, 32), 100, f32, False, "disjoint"),
        ("tq_ne_tk 200/333", (2, 4, 200, 32), 333, f32, False, "tq_ne_tk"),
    ]
    design_kernels = {
        "tile": (_kernels.FLASH_BWD_TILE,),
        "wgmma": (_kernels.FLASH_BWD_DQ, _kernels.FLASH_BWD_DKDV),
    }
    results = {}
    for name, (B, H, Tq, D), Tk, dtype, causal, layout in cases:
        q, do = (torch.randn((B, H, Tq, D), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((B, H, Tk, D), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        seg_q, seg_k = layout_segments(layout, gen, B, Tq, Tk)
        o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
        design = _kernels.flash_bwd_design(Tq, Tk)
        before = [kern.launches for kern in design_kernels[design]]
        got = _flash_backward(q, k, v, seg_q, seg_k, o, lse, do, causal)
        torch.cuda.synchronize()
        if [kern.launches - n for kern, n in
                zip(design_kernels[design], before)] != [1] * len(before):
            raise RuntimeError(f"{name}: the {design} design's kernels did "
                               f"not launch once each")
        want = _flash_backward_plain(q, k, v, seg_q, seg_k, o, lse, do,
                                     causal)
        errs, ok = {}, True
        rel = 2.0 ** -7 if dtype == bf16 else 0.0
        for gname, g, ref in zip(("dq", "dk", "dv"), got, want):
            ref = ref.float()
            tol = 1e-4 * float(ref.abs().max()) + rel * ref.abs()
            err = (g.float() - ref).abs()
            ok &= bool((err <= tol).all())
            errs[gname] = (float(err.max()), float(tol.max()))
        masked = torch.isinf(lse).reshape(B, H, Tq)
        if layout in ("kv masked", "disjoint") and not masked.any():
            raise RuntimeError(f"{name} produced no fully masked row")
        if masked.any():
            ok &= bool((got[0][masked] == 0).all())
            errs["dq on masked rows"] = (float(got[0][masked].abs().max()),
                                         0.0)
        log(f"[backward] {name}: q {tuple(q.shape)} Tk {Tk} "
            f"{str(dtype)[6:]} causal={causal} {layout} design {design} | "
            + " ".join(f"max|{g}-plain| {e:.3e} (tol {t:.3e})"
                       for g, (e, t) in errs.items())
            + f" | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the backward disagrees with plain on {name}")
        results[name] = dict(q=q, k=k, v=v, do=do, seg_q=seg_q, seg_k=seg_k,
                             causal=causal, o=o, lse=lse, errs=errs,
                             design=design)

    timings = {}
    for name in ("train (main path)", "context (main path)",
                 "context (no resets)", "B*H=32 T=2048 bf16"):
        r = results[name]
        q, k, v, do, sq, sk, causal = (r["q"], r["k"], r["v"], r["do"],
                                       r["seg_q"], r["seg_k"], r["causal"])
        o, lse = r["o"], r["lse"]
        if r["design"] == "tile":
            fns = {"flash_bwd_tile": lambda: _kernels.flash_bwd_tile(
                q, k, v, sq, sk, o, lse, do, causal)}
        else:
            delta = _flash_delta(o, do)
            fns = {
                "flash_bwd_dq": lambda: _kernels.flash_bwd_dq(
                    q, k, v, sq, sk, lse, delta, do, causal),
                "flash_bwd_dkdv": lambda: _kernels.flash_bwd_dkdv(
                    q, k, v, sq, sk, lse, delta, do, causal),
            }
        ms = {kname: cuda_ms(fn, 20) for kname, fn in fns.items()}
        dev = {kname: device_ms(fn, kname + "_kernel")
               for kname, fn in fns.items()}
        plain_ms = cuda_ms(lambda: _flash_backward_plain(
            q, k, v, sq, sk, o, lse, do, causal), 5)
        # Yardstick: SDPA's backward with the same boolean mask, on CUDA
        # events and as profiler device time (all of its kernels).
        Tq, Tk = q.shape[2], k.shape[2]
        mask = sq[:, None, :, None] == sk[:, None, None, :]
        if causal:
            mask = mask & torch.ones((Tq, Tk), dtype=torch.bool,
                                     device="cuda").tril()
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask)

        def library():
            return torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)

        lib_ms = cuda_ms(library, 20)
        lib_dev_ms = device_ms(library, None)
        if None in dev.values() or lib_dev_ms is None:
            raise RuntimeError(f"no profiler device time for {name}: {dev}, "
                               f"sdpa {lib_dev_ms}")
        bounds = flash_bwd_bounds_ms(q, k, sq, sk, causal)
        no_resets = flash_bwd_bounds_ms(q, k, torch.zeros_like(sq),
                                        torch.zeros_like(sk), causal)
        timings[name] = {}
        for kname in fns:
            timings[name][kname] = dict(
                ms=ms[kname], device_ms=dev[kname], plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                bound_ms=bounds[kname][0], bound_by=bounds[kname][1],
                bound_ms_no_resets=no_resets[kname][0], design=r["design"])
            log(f"[backward] {kname} {name} timing: kernel {ms[kname]:.4f} "
                f"ms (profiler device time {dev[kname]:.4f} ms), bound "
                f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]}), bound with "
                f"no resets {no_resets[kname][0]:.4f} ms; device/bound "
                f"{dev[kname] / bounds[kname][0]:.1f}x")
        log(f"[backward] {name} timing ({r['design']}): kernels "
            f"{sum(dev.values()):.4f} ms device ({sum(ms.values()):.4f} ms "
            f"events), plain backward (dq, dk, dv together) {plain_ms:.4f} "
            f"ms, sdpa backward {lib_dev_ms:.4f} ms device ({lib_ms:.4f} ms "
            f"events)")
    return results, timings


def phase_context_backward():
    """The long-T backward on its path: autograd through
    attention(backend="auto") at the context shape with the repo's resets,
    launch counts from 0, gradients held against dense attention's
    autograd on the card (no row is fully masked, so the two agree)."""
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.ops.attention import attention, dense_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(CONTEXT_SHAPE, generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    w = torch.randn(CONTEXT_SHAPE, generator=gen, device="cuda")
    seg = episode_segments(gen, CONTEXT_SHAPE[0], CONTEXT_T)
    for kern in KERNELS:
        kern.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = attention(q, k, v, backend="auto", causal=True, segment_ids=seg)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    end.record()
    end.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    ref = dense_attention(q, k, v, causal=True, segment_ids=seg)
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    errs = {n: float((g - r).abs().max()) / float(r.abs().max())
            for n, g, r in zip(("dq", "dk", "dv"), got, want)}
    log(f"[context backward] attention(auto) + autograd at "
        f"{CONTEXT_SHAPE} f32, resets every {EPISODE_LENGTH}: "
        f"{start.elapsed_time(end):.3f} ms (CUDA events, forward and "
        f"backward) | max error vs dense autograd, relative to each "
        f"gradient's max: "
        + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol 1e-4) | launches {launches}")
    if max(errs.values()) > 1e-4:
        raise RuntimeError(f"context backward differs from dense: {errs}")
    want_launches = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1,
                     "flash_bwd_tile": 0}
    if launches != want_launches:
        raise RuntimeError(f"context backward launches {launches}, want "
                           f"{want_launches}")
    return launches


def _serve(rep, reqs, waves):
    """Submit the requests in waves (lists of indices), each wave at once;
    returns replies and per-request host and CUDA-event latencies (ms)."""
    replies = [None] * len(reqs)
    host_ms, event_ms = [], []
    for wave in waves:
        started = []
        for i in wave:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            started.append((i, time.perf_counter(), ev, rep.submit(reqs[i])))
        for i, t0, ev, fut in started:
            replies[i] = fut.result(timeout=300)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            event_ms.append(ev.elapsed_time(end))
    return replies, host_ms, event_ms


def _check(name, got, want, shape):
    """Shape and finiteness of a reply; returns its max error."""
    got = np.asarray(got)
    if got.shape != shape:
        raise RuntimeError(f"{name}: shape {got.shape}, want {shape}")
    if not np.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    return float(np.abs(got - want).max())


def _serve_steady(rep, reqs, order):
    """Submit ``reqs[i]`` for ``i`` in ``order`` in waves of BATCH,
    keeping two waves in flight so the replica always has a full batch
    queued; returns (index, reply) pairs, each request's latency on the
    host clock (submit to reply, ms) and the requests served a second."""
    out, host_ms, in_flight = [], [], []

    def stamp(t0):
        return lambda fut: host_ms.append(1e3 * (time.perf_counter() - t0))

    def collect(wave):
        for i, fut in wave:
            out.append((i, fut.result(timeout=300)))

    t_start = time.perf_counter()
    for w in range(0, len(order), BATCH):
        wave = []
        for i in order[w:w + BATCH]:
            fut = rep.submit(reqs[i])
            fut.add_done_callback(stamp(time.perf_counter()))
            wave.append((i, fut))
        in_flight.append(wave)
        if len(in_flight) == 2:
            collect(in_flight.pop(0))
    for wave in in_flight:
        collect(wave)
    rate = len(order) / (time.perf_counter() - t_start)
    return out, host_ms, rate


def _settle(tel, kind: str, sent: int, timeout: float = 30.0) -> None:
    """Wait until the replica's worker has recorded every batch served so
    far: its rows add up to ``sent`` and its scope holds one step a
    batch (the worker records the step after the replies go out)."""
    reg, t_end = tel.registry, time.monotonic() + timeout
    while not (reg.value("serving_batch_rows_total", service=kind) == sent
               and reg.value("stepscope_steps_total", loop=f"{kind}_replica")
               == reg.value("serving_batches_total", service=kind)):
        if time.monotonic() > t_end:
            raise RuntimeError(f"{kind}: the replica did not record its "
                               f"{sent} requests within {timeout} s")
        time.sleep(0.001)


def _replica_ledger(tel, kind: str) -> dict:
    from moolib_tpu_torch.telemetry import summarize_stepscope

    return summarize_stepscope(tel.snapshot())[f"{kind}_replica"]


# Steady serving after the warm-up: STEADY_WAVES[kind] waves of BATCH
# requests, two in flight, cycling over the checked requests.
STEADY_WAVES = {"act": 64, "context": 32}
REPLICA_PHASES = ("queue_wait", "linger", "infer", "other")


def phase_serve(tel):
    from moolib_tpu_torch import Replica, TransformerNet, make_act_step
    from moolib_tpu_torch.ops._kernels import FLASH_FWD, KERNELS

    gen = torch.Generator(device="cuda").manual_seed(0)
    # experiment.py's transformer at full width: d_model 128, 2 layers,
    # 4 heads, mlp_ratio 4, max_len 2048, 6 actions, bf16 compute dtype.
    net = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                         attention_backend="auto", device="cuda",
                         generator=gen).eval()
    # The reference for every reply: the same weights, plain dense
    # attention, on the CPU (no kernel, no cuDNN).
    dense = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                           attention_backend="dense", device="cpu").eval()
    dense.load_state_dict(net.state_dict())
    rng = np.random.default_rng(0)
    batch_ms = {"act": [], "context": []}

    def timed(kind, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        batch_ms[kind].append(start.elapsed_time(end))
        return out

    act_gen = torch.Generator(device="cuda").manual_seed(1)

    def act_fn(model, batch):
        n = batch["done"].shape[0]

        def run():
            a, logits, _ = make_act_step(model)(batch["obs"].reshape(n * ACT_ENVS, 84, 84, 4),
                               batch["done"].reshape(n * ACT_ENVS), (),
                               act_gen)
            return {"action": a.reshape(n, ACT_ENVS),
                    "logits": logits.reshape(n, ACT_ENVS, 6)}

        return timed("act", run)

    def context_fn(model, batch):
        def run():
            (logits, baseline), _ = model(batch["obs"].transpose(0, 1),
                                          batch["done"].transpose(0, 1), ())
            return {"logits": logits.transpose(0, 1),
                    "baseline": baseline.transpose(0, 1)}

        return timed("context", run)

    def dense_ref(kind, req):
        """The dense-attention forward of one request on the CPU."""
        obs = torch.from_numpy(req["obs"])
        done = torch.from_numpy(req["done"])
        with torch.no_grad():
            if kind == "act":
                (logits, _), _ = dense(obs[None], done[None], ())
                return {"logits": logits[0].numpy()}
            (logits, baseline), _ = dense(obs[:, None], done[:, None], ())
            return {"logits": logits[:, 0].numpy(),
                    "baseline": baseline[:, 0].numpy()}

    def reply_err(kind, out, ref):
        """A reply's shape, finiteness and actions; its max error."""
        if kind == "act":
            a = np.asarray(out["action"])
            if a.shape != (ACT_ENVS,) or not ((a >= 0) & (a < 6)).all():
                raise RuntimeError(f"bad actions {a}")
            return _check("act logits", out["logits"], ref["logits"],
                          (ACT_ENVS, 6))
        return max(_check("context logits", out["logits"], ref["logits"],
                          (CONTEXT_T, 6)),
                   _check("context baseline", out["baseline"],
                          ref["baseline"], (CONTEXT_T,)))

    # Act request r is step r of 32 envs; a context request is a window
    # of one env. Resets follow EPISODE_LENGTH, each env at its phase.
    act_phase = rng.integers(0, EPISODE_LENGTH, ACT_ENVS)
    act_reqs = [{"obs": rng.integers(0, 256, (ACT_ENVS, 84, 84, 4), np.uint8),
                 "done": (r + act_phase) % EPISODE_LENGTH == 0}
                for r in range(7)]
    ctx_reqs = [{"obs": rng.integers(0, 256, (CONTEXT_T, 84, 84, 4),
                                     np.uint8),
                 "done": (np.arange(CONTEXT_T) + rng.integers(EPISODE_LENGTH))
                 % EPISODE_LENGTH == 0} for _ in range(6)]
    launches = {}
    for kind, fn, reqs, waves in (
        ("act", act_fn, act_reqs, [[0, 1, 2], [3, 4, 5, 6]]),
        ("context", context_fn, ctx_reqs, [[0, 1], [2, 3, 4, 5]]),
    ):
        rep = Replica(None, fn, net, service=kind, batch_size=BATCH,
                      pad=True, linger_s=0.05, device="cuda", telemetry=tel)
        # Each served batch's ledger row, as the replica's worker hands
        # it to its {service}_replica scope.
        rows, observe = [], rep._scope.observe_step

        def tap(wall_s, phases, ts_us=None, rows=rows, observe=observe):
            rows.append(dict(phases, wall=wall_s))
            observe(wall_s, phases, ts_us)

        rep._scope.observe_step = tap
        order = [j % len(reqs) for j in range(STEADY_WAVES[kind] * BATCH)]
        try:
            for kern in KERNELS:
                kern.launches = 0
            replies, host_ms, event_ms = _serve(rep, reqs, waves)
            launches[kind] = {kern.name: kern.launches for kern in KERNELS}
            # Hold every reply against the dense-attention forward on
            # the CPU.
            refs = [dense_ref(kind, req) for req in reqs]
            errs = [reply_err(kind, out, ref)
                    for out, ref in zip(replies, refs)]
            # The requests above warm the replica (its first batch is
            # cold); the steady ledger counts from here.
            _settle(tel, kind, len(reqs))
            warm, n_warm = _replica_ledger(tel, kind), len(rows)
            n_cold_fwd = len(batch_ms[kind])
            steady, steady_ms, rate = _serve_steady(rep, reqs, order)
            steady_errs = [reply_err(kind, out, refs[i])
                           for i, out in steady]
        finally:
            rep.close()
        log(f"[serve] {kind}: {len(reqs)} requests in waves "
            f"{[len(w) for w in waves]} | max|reply-dense on CPU| "
            f"{max(errs):.3e} (tol {SERVE_TOL}) | launches {launches[kind]}")
        if max(errs + steady_errs) > SERVE_TOL:
            raise RuntimeError(f"{kind} replies differ from the CPU forward "
                               f"by {max(errs + steady_errs):.3e} > "
                               f"{SERVE_TOL}")
        log(f"[serve] {kind}: request latency ms (host clock) "
            f"{[round(x, 3) for x in host_ms]}")
        log(f"[serve] {kind}: request latency ms (CUDA events) "
            f"{[round(x, 3) for x in event_ms]}")
        log(f"[serve] {kind}: batch forward ms (CUDA events) "
            f"{[round(x, 3) for x in batch_ms[kind][:n_cold_fwd]]}")
        if launches[kind][FLASH_FWD.name] == 0:
            raise RuntimeError(f"{FLASH_FWD.name} was never launched by the "
                               f"{kind} service")
        fwd = batch_ms[kind][n_cold_fwd:]
        log(f"[serve] {kind} steady: {len(order)} more requests in waves of "
            f"{BATCH}, two waves in flight | max|reply-dense on CPU| "
            f"{max(steady_errs):.3e} | {rate:.3f} requests/s | request "
            f"latency ms (host clock) median {np.median(steady_ms):.3f}, p90 "
            f"{np.percentile(steady_ms, 90):.3f} | batch forward ms (CUDA "
            f"events) median {np.median(fwd):.3f} of {len(fwd)}")
        _serve_telemetry(tel, kind, len(reqs) + len(order), warm,
                         rows[:n_warm], rows[n_warm:])
    _check_prometheus(tel, "serve")
    return launches


def _serve_telemetry(tel, kind: str, sent: int, warm: dict, warm_rows,
                     steady_rows) -> None:
    """The serving series of one closed replica (its worker joined, so
    every count is in): every request admitted and completed, nothing
    rejected or shed, the batch rows equal to the fill histogram's sum
    times the batch size, one replica step a batch; then the
    {service}_replica ledger: the warm-up's (``warm``, the scope's
    cumulative summary when the steady run began) and the steady run's,
    as the difference of the cumulative counters and as per-batch
    medians."""
    reg = tel.registry
    counts = {name: reg.value(f"serving_{name}_total", service=kind)
              for name in ("admitted", "completed", "shed", "failed",
                           "batches", "batch_rows")}
    counts.update({f"rejected_{r}": reg.value("serving_rejected_total",
                                              service=kind, reason=r)
                   for r in ("capacity", "draining")})
    snap = tel.snapshot()
    fill = snap[f'serving_batch_fill_fraction{{service="{kind}"}}']
    led = _replica_ledger(tel, kind)
    log(f"[telemetry] {kind}: sent {sent} | " + " ".join(
        f"{k} {v:g}" for k, v in counts.items())
        + f" | fill histogram count {fill['count']} sum {fill['sum']:g} "
        f"(x batch {BATCH} = {fill['sum'] * BATCH:g} rows)")

    def ledger_txt(steps, wall, phases):
        return (f"{steps} steps, wall {1e3 * wall:.3f} ms | " + ", ".join(
            f"{ph} {1e3 * phases.get(ph, 0.0):.3f} ms "
            f"({phases.get(ph, 0.0) / wall:.3f})" for ph in REPLICA_PHASES))

    log(f"[stepscope] {kind}_replica warm-up (its first batch cold): "
        + ledger_txt(warm["steps"], warm["wall_s"], warm["phases"])
        + " | per batch ms " + str([
            {k: round(1e3 * v, 3) for k, v in r.items()} for r in warm_rows]))
    phases = {ph: led["phases"].get(ph, 0.0) - warm["phases"].get(ph, 0.0)
              for ph in REPLICA_PHASES}
    median = {ph: 1e3 * float(np.median([r.get(ph, 0.0)
                                         for r in steady_rows]))
              for ph in REPLICA_PHASES[:-1] + ("wall",)}
    median["other"] = 1e3 * float(np.median(
        [r["wall"] - sum(r.get(ph, 0.0) for ph in REPLICA_PHASES[:-1])
         for r in steady_rows]))
    log(f"[stepscope] {kind}_replica steady: "
        + ledger_txt(led["steps"] - warm["steps"],
                     led["wall_s"] - warm["wall_s"], phases)
        + " | per batch median ms " + ", ".join(
            f"{ph} {median[ph]:.3f}" for ph in REPLICA_PHASES + ("wall",)))
    bad = []
    if not counts["admitted"] == counts["completed"] == sent:
        bad.append("admitted == completed == sent")
    if counts["rejected_capacity"] or counts["rejected_draining"] or \
            counts["shed"] or counts["failed"]:
        bad.append("no rejection, shed or failure")
    if counts["batch_rows"] != fill["sum"] * BATCH or \
            counts["batches"] != fill["count"]:
        bad.append("batch rows and batches equal the fill histogram's")
    if not led["steps"] == counts["batches"] == \
            len(warm_rows) + len(steady_rows):
        bad.append("one replica step per batch")
    if bad:
        raise RuntimeError(f"serving telemetry of {kind}: failed {bad}: "
                           f"{counts}, fill {fill}")


def _check_prometheus(tel, tag: str) -> None:
    """The registry's Prometheus text, read back by the port's strict
    parser, holds the values snapshot() holds: every counter and gauge,
    and every histogram's count, sum and +Inf bucket."""
    from moolib_tpu_torch.telemetry import parse_prometheus

    snap, parsed = tel.snapshot(), parse_prometheus(tel.prometheus())
    want = {}
    for sid, series in snap.items():
        if series["type"] != "histogram":
            want[sid] = series["value"]
            continue
        name, _, labels = sid.partition("{")
        inner = labels[:-1]
        want[f"{name}_count" + (f"{{{inner}}}" if inner else "")] = \
            series["count"]
        want[f"{name}_sum" + (f"{{{inner}}}" if inner else "")] = \
            series["sum"]
        want[f"{name}_bucket{{" + (f"{inner}," if inner else "")
             + 'le="+Inf"}'] = series["buckets"][-1]
    bad = {sid: (parsed.get(sid), v) for sid, v in want.items()
           if not (parsed.get(sid) == v
                   or (v != v and parsed.get(sid) != parsed.get(sid)))}
    log(f"[telemetry] {tag}: Prometheus text parses into the snapshot's "
        f"values: {len(snap)} series, {len(want)} samples checked, "
        f"{len(bad)} differ")
    if bad:
        raise RuntimeError(f"{tag}: Prometheus text and snapshot differ: "
                           f"{bad}")


def _learn_batches(gen: torch.Generator, n: int):
    """``n`` consecutive learn batches of experiment.py's shape on the
    card: uint8 frames [T+1, B, 84, 84, 4]; an episode reset every
    EPISODE_LENGTH steps per env at a phase of its own (batch i starts
    where batch i-1 ended, as unrolls overlap by the bootstrap frame);
    rewards ~ N(0, 1), so reward_clip (1.0) cuts about a third of them;
    behaviour logits ~ N(0, 1) and actions sampled from them."""
    T, B, A = UNROLL, LEARN_B, 6
    phase = torch.randint(0, EPISODE_LENGTH, (1, B), generator=gen,
                          device="cuda")
    batches = []
    for i in range(n):
        t = torch.arange(T + 1, device="cuda")[:, None] + i * T
        logits = torch.randn((T, B, A), generator=gen, device="cuda")
        actions = torch.multinomial(torch.softmax(logits, -1).reshape(-1, A),
                                    1, generator=gen).reshape(T, B)
        batches.append({
            "obs": torch.randint(0, 256, (T + 1, B, 84, 84, 4),
                                 generator=gen, device="cuda",
                                 dtype=torch.uint8),
            "done": (t + phase) % EPISODE_LENGTH == 0,
            "rewards": torch.randn((T + 1, B), generator=gen,
                                   device="cuda"),
            "actions": actions,
            "behavior_logits": logits,
            "core_state": (),
        })
    return batches


def _to_cpu(batch):
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()}


# Train steps on the card vs the same steps with dense attention on the
# CPU: everything is f32 but the two bf16 roundings both sides make alike
# (scaled pixels, pos_emb), so the difference is summation order (the
# kernels, cuDNN's f32 convolutions, cuBLAS). Metrics: 1e-4 relative.
# Gradients of step 1: 1e-3 of each tensor's largest entry; the conv
# torso's gradients are sums over up to 672*441 positions whose terms
# cancel, which amplifies the order's error (6.8e-5 at conv1.bias on an
# H100 80GB HBM3). pos_emb's gradient is rounded to bf16 on its way back
# through the compute-dtype cast, where one rounding may fall the other
# way: 2**-7. Parameters after the last step: a step moves a parameter
# by lr*g/sqrt(nu+eps), at most 10*lr = 6e-3 on the first step, so a
# 1e-4 relative gradient difference moves it by < 6e-7 a step: 2e-6
# absolute after three.
TRAIN_METRIC_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
BF16_GRAD_TOL = {"pos_emb.weight": 2.0 ** -7}
TRAIN_PARAM_TOL = 2e-6
CONV_PARAMS = ("conv0.weight", "conv0.bias", "conv1.weight", "conv1.bias")
METRICS = ("total_loss", "pg_loss", "baseline_loss", "entropy", "grad_norm")


def _kernel_class(name: str) -> str:
    """The part of the step a device work item belongs to, from its name
    (cuDNN's convolution kernels name their pass: fprop, dgrad, wgrad)."""
    n = name.lower()
    if "wgrad" in n:
        return "conv weight gradient"
    if "dgrad" in n:
        return "conv data gradient"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "conv layout transposes"
    if "fft" in n or "cf32" in n:  # cuDNN's FFT algorithm, any pass
        return "conv via FFT"
    if "fprop" in n or "convolve" in n or re.search(r"\bconv", n):
        return "conv forward"
    if "flash_" in n:
        return "flash kernels"
    if "gemm" in n or "gemv" in n or "cublas" in n or "cutlass" in n:
        return "dense (cuBLAS)"
    if "max_pool" in n:
        return "max-pool"
    if "memcpy" in n or "memset" in n:
        return "copies and fills"
    return "elementwise and other"


# The profiled step's range, and the CUDA API calls that may
# block the host: synchronizes, allocations and frees (cudaFree waits for
# the device), host registration, and the synchronous copies and fills.
STEP_RANGE = "chip_smoke step"


def _blocking_api(name: str) -> bool:
    return bool(re.search(r"Synchronize|Malloc|MemAlloc|Free|HostAlloc|"
                          r"HostRegister", name)) or name in (
        "cudaMemcpy", "cudaMemset", "cudaMemcpy2D", "cuMemcpy",
        "cuMemcpyHtoD_v2", "cuMemcpyDtoH_v2")


def _profile_step(run_step, tag: str = "train") -> dict:
    """One train step under torch.profiler: its wall time, the number of
    work items on the card (kernels, copies, fills), their summed device
    time (one stream, so no overlap), the device time by kernel class
    (_kernel_class), the largest items, the spans that record_function
    ranges (the optimizer's step, and whatever the caller marks) cover on
    the device timeline, and the device time of the work items that
    start inside each span. Also the CUDA API calls (cuda* and cu*) the
    host made inside the step itself (before its read back), by name:
    those that can block it (synchronizes, allocations and frees, which
    CUDA's sync debug mode does not all see), and the longest call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(STEP_RANGE):
            _, m = run_step()
        float(m["total_loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, spans, items = {}, {}, []
    step_range, api_calls = None, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name == STEP_RANGE:
                step_range = (e.time_range.start, e.time_range.end)
            elif re.match(r"cu[A-Z]|cuda[A-Z]", e.name):
                api_calls.append((e.name, e.time_range.start,
                                  e.time_range.elapsed_us()))
            continue
        r = e.time_range
        if e.name == STEP_RANGE:
            continue
        if e.is_user_annotation:  # a range over other work, not work
            spans.setdefault(e.name, []).append((r.start, r.end))
            continue
        items.append((e.name, r.start, r.elapsed_us()))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + r.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    by_class = {}
    for name, (n, us) in by_name.items():
        c = _kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    span_ms = {name: sum(r1 - r0 for r0, r1 in rs) / 1e3
               for name, rs in spans.items()}
    span_work_ms = {
        name: sum(us for _, t, us in items
                  if any(r0 <= t < r1 for r0, r1 in rs)) / 1e3
        for name, rs in spans.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"[{tag}] profiled step: {wall_ms:.3f} ms wall (profiler on), "
        f"{len(items)} device work items, {busy_ms:.3f} ms device busy "
        f"({100 * busy_ms / wall_ms:.1f}% of the wall time)")
    log(f"[{tag}]   device ms by class: " + ", ".join(
        f"{c} {ms:.3f}" for c, ms in sorted(by_class.items(),
                                             key=lambda kv: -kv[1])))
    for name, (n, us) in top:
        log(f"[{tag}]   {us / 1e3:.3f} ms in {n} x {name[:90]}")
    for name in spans:
        log(f"[{tag}]   span {name}: {span_ms[name]:.3f} ms on the device "
            f"timeline, {span_work_ms[name]:.3f} ms of device work in it")
    if step_range is None:
        raise RuntimeError(f"{tag}: the profile holds no {STEP_RANGE!r} "
                           f"range")
    in_step = [(n, us) for n, t, us in api_calls
               if step_range[0] <= t < step_range[1]]
    api = {}
    for n, _ in in_step:
        api[n] = api.get(n, 0) + 1
    blocking = {n: c for n, c in api.items() if _blocking_api(n)}
    longest = max(in_step, key=lambda c: c[1], default=("none", 0.0))
    log(f"[{tag}]   host API calls in the step (to its read back): "
        f"{sum(api.values())}, "
        + ", ".join(f"{n} {c}" for n, c in sorted(api.items(),
                                                  key=lambda kv: -kv[1]))
        + f" | that can block the host: {blocking or 'none'} | longest "
        f"{longest[0]} {longest[1]:.1f} us, all "
        f"{sum(us for _, us in in_step) / 1e3:.3f} ms")
    return dict(wall_ms=wall_ms, device_items=len(items),
                host_api_calls=api, blocking_api_calls=blocking,
                longest_api_call=dict(name=longest[0], us=longest[1]),
                device_busy_ms=busy_ms, by_class_ms=by_class,
                spans_ms=span_ms, span_work_ms=span_work_ms,
                top=[dict(name=name[:90], count=n, ms=us / 1e3)
                     for name, (n, us) in top[:5]])


# StepScope ledgers of the scoped loops (phases 6 and 8): LEDGER_STEPS
# steps a loop, a step_phases flight event every FLIGHT_EVERY steps, and
# COST_ROUNDS rounds of (plain, scoped, scoped, plain) steps for
# telemetry's cost on the step.
LEDGER_STEPS = 8
FLIGHT_EVERY = 4
COST_ROUNDS = 3
LEDGER_PHASES = ("staging", "act", "fwd_bwd", "optimizer", "host_sync",
                 "other")


def _telemetry(name: str):
    """A fresh Telemetry for one phase: metrics and spans on."""
    from moolib_tpu_torch.telemetry import Telemetry

    return Telemetry(name, enabled=True, tracing=True)


def _no_sync(fn, *args):
    """``fn(*args)`` with CUDA's sync debug mode at "error": a scoped
    step only enqueues, so any call in it that waits for the device
    (a read back, a synchronize) raises here."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _read_metrics(m):
    """host_sync: the step's metrics on the host, in one copy."""
    return torch.stack([m[k].float() for k in METRICS]).cpu()


def _ledger(tel, scope, step_fn, steps: int = LEDGER_STEPS) -> dict:
    """Run ``steps`` steps of ``step_fn(i)`` (which opens its own phases)
    inside ``scope.step()``; returns the per-step ledgers in ms (from the
    scope's cumulative counters), each phase's median, and the loop's
    summary. Fails if the ledger does not close: the overrun gauge must
    read 0 (no phase claimed more than the step's wall time) and the
    phases, ``other`` included, must sum to the wall time."""
    per_step = []
    prev = scope.summary()
    for i in range(steps):
        with scope.step():
            step_fn(i)
        cur = scope.summary()
        row = {ph: 1e3 * (secs - prev["phases"].get(ph, 0.0))
               for ph, secs in cur["phases"].items()}
        row["wall"] = 1e3 * (cur["wall_s"] - prev["wall_s"])
        per_step.append(row)
        prev = cur
    summary = scope.summary()
    overrun = tel.registry.value("stepscope_ledger_overrun_fraction",
                                 loop=scope.loop)
    gap = abs(sum(summary["phases"].values()) - summary["wall_s"])
    if overrun != 0.0 or gap > 1e-9 * summary["wall_s"] or any(
            v < 0.0 for v in summary["phases"].values()):
        raise RuntimeError(f"{scope.loop}: the ledger does not close: "
                           f"overrun {overrun}, |phases - wall| {gap} s, "
                           f"phases {summary['phases']}")
    names = [ph for ph in LEDGER_PHASES if ph in summary["phases"]]
    names += sorted(set(summary["phases"]) - set(names))
    median = {ph: float(np.median([r.get(ph, 0.0) for r in per_step]))
              for ph in names + ["wall"]}
    return dict(loop=scope.loop, steps=summary["steps"], median_ms=median,
                per_step_ms=per_step,
                host_blocked=summary["fractions"]["host_blocked"],
                phases_s=summary["phases"], wall_s=summary["wall_s"],
                overrun=overrun)


def _log_ledger(tag: str, led: dict, breakdown=None, step_ms=None) -> None:
    """One ledger line; with the profiled step's ``breakdown`` and the
    steady step's time (CUDA events), the device's busy time beside it,
    as a share of both (the profiler slows the host, so the profiled
    step is the longer)."""
    m = led["median_ms"]
    busy_txt = ""
    if breakdown is not None:
        busy = breakdown["device_busy_ms"]
        busy_txt = (f" | profiler (same run): device busy {busy:.3f} ms, "
                    f"{100 * busy / breakdown['wall_ms']:.1f}% of the "
                    f"profiled step, {100 * busy / step_ms:.1f}% of the "
                    f"steady step")
    log(f"[stepscope] {tag} loop {led['loop']}: {led['steps']} steps, "
        f"median ms " + ", ".join(f"{ph} {m[ph]:.3f}" for ph in m
                                  if ph != "wall")
        + f" | wall {m['wall']:.3f} | host-blocked fraction "
        f"{led['host_blocked']:.3f} | overrun {led['overrun']}" + busy_txt)


def _train_ledgers(tag: str, tel, cfg, state, batches, optimizer,
                   count_launches=None) -> dict:
    """The scoped loops of one learner: the fused train step (staging the
    learn batch from the host, the step as ``fwd_bwd``, the metrics read
    back as ``host_sync``), the grad/apply split (``fwd_bwd``,
    ``optimizer``) on a copy of the model, and telemetry's cost: plain
    and scoped steps in (plain, scoped, scoped, plain) turns, each to its
    metrics on the host. Every scoped call of the two ledgers runs under
    _no_sync. ``count_launches()``, when given, is called after each
    fused step. Returns the ledgers and the cost."""
    from moolib_tpu_torch import (
        make_apply_step,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.ops import stage_batch
    from moolib_tpu_torch.telemetry import StepScope

    host = [_to_cpu(b) for b in batches]
    scope = StepScope(f"{tag}_train", telemetry=tel,
                      flight_every=FLIGHT_EVERY)
    step = make_impala_train_step(config=cfg, stepscope=scope)
    box = [state]

    def fused(i):
        with scope.phase("staging"):
            batch = stage_batch(host[i % len(host)], "cuda")
        box[0], m = _no_sync(step, box[0], batch)
        with scope.phase("host_sync"):
            _read_metrics(m)
        if count_launches is not None:
            count_launches()

    fused_led = _ledger(tel, scope, fused)

    split_scope = StepScope(f"{tag}_split", telemetry=tel,
                            flight_every=FLIGHT_EVERY)
    twin = copy.deepcopy(box[0].model)
    split_state = [make_train_state(twin, optimizer(twin))]
    grad_step = make_grad_step(config=cfg, stepscope=split_scope)
    apply_step = make_apply_step(stepscope=split_scope)

    def split(i):
        with split_scope.phase("staging"):
            batch = stage_batch(host[i % len(host)], "cuda")
        grads, m = _no_sync(grad_step, split_state[0].model, batch)
        split_state[0] = _no_sync(apply_step, split_state[0], grads)
        with split_scope.phase("host_sync"):
            _read_metrics(m)

    split_led = _ledger(tel, split_scope, split)
    del twin, split_state

    cost_scope = StepScope(f"{tag}_cost", telemetry=tel,
                           flight_every=FLIGHT_EVERY)
    plain = make_impala_train_step(config=cfg)
    scoped = make_impala_train_step(config=cfg, stepscope=cost_scope)
    times = {"plain": [], "scoped": []}
    for i in range(4 * COST_ROUNDS):
        kind = ("plain", "scoped", "scoped", "plain")[i % 4]
        batch = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "plain":
            box[0], m = plain(box[0], batch)
            _read_metrics(m)
        else:
            with cost_scope.step():
                box[0], m = scoped(box[0], batch)
                with cost_scope.phase("host_sync"):
                    _read_metrics(m)
        times[kind].append(1e3 * (time.perf_counter() - t0))
    cost = {k: float(np.median(v)) for k, v in times.items()}
    cost["ratio"] = cost["scoped"] / cost["plain"]
    log(f"[telemetry] {tag}: train step to its metrics on the host, "
        f"{2 * COST_ROUNDS} steps each in (plain, scoped, scoped, plain) "
        f"turns: stepscope=None median {cost['plain']:.3f} ms, live scope "
        f"(spans on) {cost['scoped']:.3f} ms, ratio {cost['ratio']:.4f} "
        f"| all ms plain {[round(x, 3) for x in times['plain']]} scoped "
        f"{[round(x, 3) for x in times['scoped']]}")
    return dict(train=fused_led, split=split_led, cost=cost,
                state=box[0])


def phase_train(tel):
    from moolib_tpu_torch import (
        ClippedRMSprop,
        ImpalaConfig,
        TransformerNet,
        impala_loss,
        make_apply_step,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.learner import call_model
    from moolib_tpu_torch.ops import attention as attention_ops
    from moolib_tpu_torch.ops._kernels import KERNELS

    gen = torch.Generator(device="cuda").manual_seed(2)

    def model(device, backend, generator=None):
        # experiment.py's transformer at full width (as in phase 5).
        return TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                              attention_backend=backend, device=device,
                              generator=generator)

    def optimizer(net):
        # experiment.py:240-243: clip_by_global_norm(40), then
        # rmsprop(6e-4, decay=0.99, eps=0.01).
        return ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                              max_norm=40.0)

    # experiment.py:246-251's values (discounting 0.99, baseline_cost
    # 0.5, entropy_cost 0.0006, reward_clip 1.0).
    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    net = model("cuda", "auto", gen)
    cpu = model("cpu", "dense")
    cpu.load_state_dict(net.state_dict())
    twin = copy.deepcopy(net)
    batches = _learn_batches(gen, TRAIN_STEPS)
    clipped = float(torch.stack([(b["rewards"][1:].abs() > 1).float().mean()
                                 for b in batches]).mean())
    resets = int(sum(int(b["done"][1:].sum()) for b in batches))
    log(f"[train] learn batches obs {tuple(batches[0]['obs'].shape)} u8 x "
        f"{TRAIN_STEPS}; {resets} resets; reward_clip cuts "
        f"{100 * clipped:.0f}% of rewards")

    # Gradients of step 1, card vs CPU.
    g_card, _ = make_grad_step(config=cfg)(net, batches[0])
    g_cpu, _ = make_grad_step(config=cfg)(cpu, _to_cpu(batches[0]))

    def rel_errs(grads):
        return {n: float((grads[n].cpu() - g_cpu[n]).abs().max())
                / float(g_cpu[n].abs().max()) for n in g_cpu}

    errs = rel_errs(g_card)
    worst = max((n for n in errs if n not in BF16_GRAD_TOL), key=errs.get)
    grad_err = errs[worst]
    log(f"[train] step-1 gradients vs CPU: max relative error {grad_err:.3e}"
        f" at {worst} (tol {TRAIN_GRAD_TOL}); "
        + " ".join(f"{n} {errs[n]:.3e} (tol {t:.3e})"
                   for n, t in BF16_GRAD_TOL.items())
        + "; conv torso " + " ".join(f"{n} {errs[n]:.3e}" for n in CONV_PARAMS))
    bad = [n for n, e in errs.items()
           if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)]
    if bad:
        raise RuntimeError(f"step-1 gradients differ from the CPU's at "
                           f"{bad}")
    # Control: the same gradients with cuDNN's TF32 left on (PyTorch's
    # default) for the backward, as the port computed them before the
    # train steps held it off there too.
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        total, _ = impala_loss(net, call_model, batches[0], cfg)
        names = [n for n, _ in net.named_parameters()]
        tf32 = dict(zip(names, torch.autograd.grad(total,
                                                   list(net.parameters()))))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    tf32_errs = rel_errs(tf32)
    log("[train] control, TF32 in the backward: conv torso "
        + " ".join(f"{n} {tf32_errs[n]:.3e}" for n in CONV_PARAMS)
        + f"; max over all {max(tf32_errs.values()):.3e}")
    del g_card, g_cpu, tf32

    # The main path: 3 fused train steps, launch counts from 0.
    step = make_impala_train_step(config=cfg)
    state = make_train_state(net, optimizer(net))
    ref_step = make_impala_train_step(config=cfg)
    ref_state = make_train_state(cpu, optimizer(cpu))
    metrics, ref_metrics, per_step = [], [], []
    # delta is the fused kernel's own work at T = 21: count any call of
    # the two-kernel design's delta ops on this path.
    plain_delta, delta_calls = attention_ops._flash_delta, []

    def counted_delta(o, do):
        delta_calls.append(tuple(o.shape))
        return plain_delta(o, do)

    attention_ops._flash_delta = counted_delta
    try:
        for kern in KERNELS:
            kern.launches = 0
        for i, batch in enumerate(batches):
            before = [kern.launches for kern in KERNELS]
            state, m = step(state, batch)
            metrics.append({k: float(m[k]) for k in METRICS})
            per_step.append([kern.launches - n for kern, n in
                             zip(KERNELS, before)])
            if i == 0:
                after_one = {k: v.clone()
                             for k, v in net.state_dict().items()}
        launches = {kern.name: kern.launches for kern in KERNELS}
    finally:
        attention_ops._flash_delta = plain_delta
    log(f"[train] launches per step {per_step} "
        f"({[kern.name for kern in KERNELS]}); total {launches}; "
        f"_flash_delta calls {len(delta_calls)}")
    # Per layer per step: one forward and one fused backward launch.
    want = [2 if kern.name in ("flash_fwd", "flash_bwd_tile") else 0
            for kern in KERNELS]
    if any(row != want for row in per_step) or delta_calls:
        raise RuntimeError(f"each train step must launch {want} "
                           f"({[kern.name for kern in KERNELS]}) and no "
                           f"delta op; got {per_step}, {delta_calls}")
    for batch in batches:
        ref_state, m = ref_step(ref_state, _to_cpu(batch))
        ref_metrics.append({k: float(m[k]) for k in METRICS})
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        errs = {k: abs(m[k] - r[k]) / max(abs(r[k]), 1e-30) for k in METRICS}
        log(f"[train] step {i + 1}: "
            + " ".join(f"{k} {m[k]:.6g}" for k in METRICS)
            + f" | max relative error vs CPU {max(errs.values()):.3e} "
            f"(tol {TRAIN_METRIC_TOL})")
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"non-finite metrics at step {i + 1}: {m}")
        if max(errs.values()) > TRAIN_METRIC_TOL:
            raise RuntimeError(f"step {i + 1} metrics differ from the CPU "
                               f"steps: {errs}")
    ref_params = cpu.state_dict()
    param_err = max(float((p.cpu() - ref_params[n]).abs().max())
                    for n, p in net.state_dict().items())
    finite = all(bool(torch.isfinite(p).all())
                 for p in net.state_dict().values())
    log(f"[train] parameters after step {TRAIN_STEPS}: max|card-CPU| "
        f"{param_err:.3e} (tol {TRAIN_PARAM_TOL}); finite {finite}")
    if not finite or param_err > TRAIN_PARAM_TOL:
        raise RuntimeError("parameters after the train steps differ from "
                           "the CPU steps")

    # experiment.py's split: grads x learn_batch_size, the one-peer
    # Accumulator mean (divide by the count), then the apply step.
    grads, _ = make_grad_step(config=cfg, grad_scale=float(LEARN_B))(
        twin, batches[0])
    grads = {n: g / LEARN_B for n, g in grads.items()}
    twin_state = make_apply_step()(make_train_state(twin, optimizer(twin)),
                                   grads)
    split_err = max(float((p - after_one[n]).abs().max())
                    for n, p in twin.state_dict().items())
    bitwise = all(torch.equal(p, after_one[n])
                  for n, p in twin.state_dict().items())
    # cuDNN's weight gradients may sum in another order from call to
    # call; anything else is the same arithmetic.
    log(f"[train] grad step x{LEARN_B} / {LEARN_B} + apply step vs fused "
        f"step 1: max|diff| {split_err:.3e} (tol 1e-7), bitwise {bitwise}; "
        f"step {twin_state.step}")
    if split_err > 1e-7 or twin_state.step != 1:
        raise RuntimeError("the grad/apply split differs from the fused "
                           "train step")

    # Steady state: more steps on the same batches, timed.
    event_ms, host_ms = [], []
    for i in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, batches[i % TRAIN_STEPS])
        end.record()
        float(m["total_loss"])  # the step's result, on the host
        end.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(end))
    log(f"[train] step time ms (CUDA events) "
        f"{[round(x, 3) for x in event_ms]}")
    log(f"[train] step time ms (host clock, to the loss on the host) "
        f"{[round(x, 3) for x in host_ms]}")
    steady = event_ms[2:]
    log(f"[train] steady-state step: {float(np.median(steady)):.3f} ms "
        f"(CUDA events, median of steps 3-8), "
        f"{float(np.median(host_ms[2:])):.3f} ms (host clock)")
    breakdown = _profile_step(lambda: step(state, batches[0]))

    # The scoped loops. Each fused step must still launch the forward and
    # the fused backward twice (once per layer) with the scope on.
    scoped_launches, last = [], [kern.launches for kern in KERNELS]

    def count_launches():
        nonlocal last
        now = [kern.launches for kern in KERNELS]
        scoped_launches.append([a - b for a, b in zip(now, last)])
        last = now

    ledgers = _train_ledgers("transformer", tel, cfg, state, batches,
                             optimizer, count_launches)
    state = ledgers.pop("state")
    step_ms = float(np.median(steady))
    _log_ledger("transformer", ledgers["train"], breakdown, step_ms)
    _log_ledger("transformer", ledgers["split"], breakdown, step_ms)
    log(f"[stepscope] transformer: launches per scoped step "
        f"{scoped_launches} ({[kern.name for kern in KERNELS]})")
    if any(row != want for row in scoped_launches):
        raise RuntimeError(f"each scoped train step must launch {want}; "
                           f"got {scoped_launches}")
    return dict(launches=launches, metrics=metrics, grad_err=grad_err,
                breakdown=breakdown, ledgers=ledgers,
                tf32_grad_err={n: tf32_errs[n] for n in CONV_PARAMS},
                param_err=param_err, split_err=split_err,
                step_ms=float(np.median(steady)),
                step_host_ms=float(np.median(host_ms[2:])))


# The impala learner path (experiment.py's default model="auto" on pixel
# envs builds ImpalaNet). The card's steps against the same steps on the
# CPU, which differ by more than summation order: f32 convolutions round
# otherwise on the two, and where a max-pool window's two largest inputs
# (or a relu's input and zero) lie within that rounding the two pick
# differently and a position's gradient goes elsewhere; over 672 frames
# some windows do, and three steps of training carry the difference on.
# bf16 rounds every conv's product and bias add, so its flips are many.
# Proxy on the CPU before the first card run (the port against the
# reference jitted, which rounds otherwise too, same shapes and chain):
# f32 step-1 gradients 2.1e-3 of a tensor's largest entry, metrics
# within 1.4e-3 relative over 3 steps, parameters 5.4e-6 absolute; bf16
# gradients 2.6e-2 in norm over all of them (a tensor whose gradient
# nearly cancels, such as the baseline head's bias, can differ wholly:
# bf16 is held only by the norm over all), metrics 5.8e-2, parameters
# 4.8e-5. Tolerances: a few times that. Measured on an H100 80GB HBM3
# (700 W): f32 1.1e-3, 3.4e-4, 1.7e-6; bf16 3.0e-2, 2.5e-2, 2.8e-5.
IMPALA_TOL = {
    torch.float32: dict(metric=5e-3, grad=1e-2, param=2e-5),
    torch.bfloat16: dict(metric=0.15, grad_global=0.1, param=2e-4),
}
# Act step: a forward only, no gradient to send elsewhere: f32 summation
# order (1e-4 of the largest entry; measured 1.6e-6 on an H100 80GB
# HBM3); bf16 rounds every layer and the state carries the flips on over
# the steps (measured 1.05e-2 there): 3e-2.
IMPALA_ACT_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
IMPALA_ACT_STEPS = 4
BENCH_B = 256


def _impala_train(dtype, tel) -> dict:
    from torch.profiler import record_function

    from moolib_tpu_torch import (
        ClippedRMSprop,
        ImpalaConfig,
        ImpalaNet,
        make_apply_step,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.ops import vtrace as vtrace_ops
    from moolib_tpu_torch.optim import global_norm

    tag = f"impala {str(dtype)[6:]}"
    tol = IMPALA_TOL[dtype]
    gen = torch.Generator(device="cuda").manual_seed(4)
    net = ImpalaNet(6, compute_dtype=dtype, device="cuda", generator=gen)
    cpu = ImpalaNet(6, compute_dtype=dtype, device="cpu")
    cpu.load_state_dict(net.state_dict())
    twin = copy.deepcopy(net)

    def optimizer(model):  # experiment.py's chain, as in phase 6
        return ClippedRMSprop(model.parameters(), 6e-4, decay=0.99,
                              eps=0.01, max_norm=40.0)

    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    batches = _learn_batches(gen, TRAIN_STEPS)
    log(f"[{tag}] full-width ImpalaNet (16/32/32, hidden 256, 6 actions, "
        f"{sum(p.numel() for p in net.parameters())} parameters), learn "
        f"batches obs {tuple(batches[0]['obs'].shape)} u8 x {TRAIN_STEPS}, "
        f"{int(sum(int(b['done'][1:].sum()) for b in batches))} resets")

    g_card, _ = make_grad_step(config=cfg)(net, batches[0])
    g_cpu, _ = make_grad_step(config=cfg)(cpu, _to_cpu(batches[0]))
    diff = {n: (g_card[n].cpu() - g_cpu[n]) for n in g_cpu}
    max_rel = {n: float(d.abs().max()) / float(g_cpu[n].abs().max())
               for n, d in diff.items()}
    worst = max(max_rel, key=max_rel.get)
    global_rel = float(global_norm(diff.values())
                       / global_norm(g_cpu.values()))
    log(f"[{tag}] step-1 gradients vs CPU: largest error relative to the "
        f"tensor's largest entry {max_rel[worst]:.3e} at {worst} (its "
        f"norm {float(g_cpu[worst].norm()):.3e}); all gradients together, "
        f"|card-CPU| / |CPU| {global_rel:.3e} (|CPU| "
        f"{float(global_norm(g_cpu.values())):.3e})")
    if "grad" in tol and max_rel[worst] > tol["grad"]:
        raise RuntimeError(f"{tag} step-1 gradients differ from the CPU's "
                           f"by {max_rel[worst]:.3e} > {tol['grad']}")
    if "grad_global" in tol and global_rel > tol["grad_global"]:
        raise RuntimeError(f"{tag} step-1 gradients differ from the CPU's "
                           f"by {global_rel:.3e} in norm > "
                           f"{tol['grad_global']}")
    grad_errs = dict(max_rel=max_rel[worst], global_rel=global_rel)
    del g_card, g_cpu

    step = make_impala_train_step(config=cfg)
    state = make_train_state(net, optimizer(net))
    ref_step = make_impala_train_step(config=cfg)
    ref_state = make_train_state(cpu, optimizer(cpu))
    metric_errs, param_errs = [], []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        ref_state, r = ref_step(ref_state, _to_cpu(batch))
        m = {k: float(m[k]) for k in METRICS}
        r = {k: float(r[k]) for k in METRICS}
        errs = {k: abs(m[k] - r[k]) / max(abs(r[k]), 1e-2) for k in METRICS}
        ref_params = cpu.state_dict()
        param_err = max(float((p.cpu() - ref_params[n]).abs().max())
                        for n, p in net.state_dict().items())
        metric_errs.append(max(errs.values()))
        param_errs.append(param_err)
        log(f"[{tag}] step {i + 1}: "
            + " ".join(f"{k} {m[k]:.6g}" for k in METRICS)
            + f" | max error vs CPU (relative to max(|value|, 0.01)) "
            f"{max(errs.values()):.3e} (tol {tol['metric']}) | parameters "
            f"max|card-CPU| {param_err:.3e} (tol {tol['param']})")
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{tag}: non-finite metrics at step {i + 1}")
        if max(errs.values()) > tol["metric"] or param_err > tol["param"]:
            raise RuntimeError(f"{tag} step {i + 1} differs from the CPU's")
        if i == 0:
            after_one = {k: v.clone() for k, v in net.state_dict().items()}
    if not all(bool(torch.isfinite(p).all()) for p in net.parameters()):
        raise RuntimeError(f"{tag}: parameters not finite")

    # experiment.py's split, as in phase 6: grads x B, the one-peer mean,
    # then the apply step, against the fused step 1.
    grads, _ = make_grad_step(config=cfg, grad_scale=float(LEARN_B))(
        twin, batches[0])
    make_apply_step()(make_train_state(twin, optimizer(twin)),
                      {n: g / LEARN_B for n, g in grads.items()})
    split_err = max(float((p - after_one[n]).abs().max())
                    for n, p in twin.state_dict().items())
    log(f"[{tag}] grad step x{LEARN_B} / {LEARN_B} + apply step vs fused "
        f"step 1: max|diff| {split_err:.3e} (tol 1e-6)")
    if split_err > 1e-6:
        raise RuntimeError(f"{tag}: the grad/apply split differs from the "
                           f"fused train step")
    del grads, twin

    event_ms, host_ms = [], []
    for i in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, batches[i % TRAIN_STEPS])
        end.record()
        float(m["total_loss"])
        end.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(end))
    log(f"[{tag}] step time ms (CUDA events) "
        f"{[round(x, 3) for x in event_ms]}")
    log(f"[{tag}] step time ms (host clock, to the loss on the host) "
        f"{[round(x, 3) for x in host_ms]}")
    step_ms = float(np.median(event_ms[2:]))
    step_host_ms = float(np.median(host_ms[2:]))
    log(f"[{tag}] steady-state step: {step_ms:.3f} ms (CUDA events, median "
        f"of steps 3-8), {step_host_ms:.3f} ms (host clock); "
        f"{UNROLL * LEARN_B / step_ms * 1e3:.0f} env-steps/s")

    # One step profiled, with the model's forward and V-trace marked.
    def forward(model, obs, done, core_state):
        with record_function("impala forward"):
            return model(obs, done, core_state)

    plain_vtrace = vtrace_ops.from_logits

    def traced_vtrace(*args, **kwargs):
        with record_function("vtrace"):
            return plain_vtrace(*args, **kwargs)

    marked = make_impala_train_step(apply_fn=forward, config=cfg)
    vtrace_ops.from_logits = traced_vtrace
    try:
        breakdown = _profile_step(lambda: marked(state, batches[0]), tag)
    finally:
        vtrace_ops.from_logits = plain_vtrace
    ledgers = _train_ledgers(f"impala_{str(dtype)[6:]}", tel, cfg, state,
                             batches, optimizer)
    del ledgers["state"]
    _log_ledger(tag, ledgers["train"], breakdown, step_ms)
    _log_ledger(tag, ledgers["split"], breakdown, step_ms)
    return dict(grad_err=grad_errs, metric_err=metric_errs,
                param_err=param_errs, split_err=split_err, step_ms=step_ms,
                step_host_ms=step_host_ms, breakdown=breakdown,
                ledgers=ledgers)


def _impala_act(dtype, tel) -> dict:
    """The act step of the LSTM ImpalaNet for ACT_ENVS envs at T=1, its
    state threaded over IMPALA_ACT_STEPS steps (a reset at step 2 for a
    quarter of the envs), against the same steps on the CPU."""
    from moolib_tpu_torch import ImpalaNet, make_act_step
    from moolib_tpu_torch.telemetry import StepScope

    tag = f"impala act {str(dtype)[6:]}"
    gen = torch.Generator(device="cuda").manual_seed(5)
    net = ImpalaNet(6, use_lstm=True, compute_dtype=dtype, device="cuda",
                    generator=gen).eval()
    cpu = ImpalaNet(6, use_lstm=True, compute_dtype=dtype,
                    device="cpu").eval()
    cpu.load_state_dict(net.state_dict())
    act, ref_act = make_act_step(net), make_act_step(cpu)
    sample = torch.Generator(device="cuda").manual_seed(6)
    ref_sample = torch.Generator().manual_seed(6)
    state, ref_state = net.initial_state(ACT_ENVS), cpu.initial_state(ACT_ENVS)
    errs, ms = [], []
    for t in range(IMPALA_ACT_STEPS):
        obs = torch.randint(0, 256, (ACT_ENVS, 84, 84, 4), generator=gen,
                            device="cuda", dtype=torch.uint8)
        done = torch.zeros(ACT_ENVS, dtype=torch.bool, device="cuda")
        if t == 2:
            done[: ACT_ENVS // 4] = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        actions, logits, state = act(obs, done, state, sample)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        _, ref_logits, ref_state = ref_act(obs.cpu(), done.cpu(), ref_state,
                                           ref_sample)
        if actions.shape != (ACT_ENVS,) or not bool(
                ((actions >= 0) & (actions < 6)).all()):
            raise RuntimeError(f"{tag}: bad actions {actions}")
        for got, want in ((logits, ref_logits), *zip(state, ref_state)):
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{tag}: non-finite output")
            errs.append(float((got.cpu() - want).abs().max())
                        / float(want.abs().max()))
    log(f"[{tag}] LSTM ImpalaNet, {ACT_ENVS} envs x {IMPALA_ACT_STEPS} "
        f"steps, state threaded: max error vs CPU (logits, c, h; relative "
        f"to the largest entry) {max(errs):.3e} (tol "
        f"{IMPALA_ACT_TOL[dtype]}) | act step ms (CUDA events) "
        f"{[round(x, 3) for x in ms]}")
    if max(errs) > IMPALA_ACT_TOL[dtype]:
        raise RuntimeError(f"{tag} differs from the CPU by {max(errs):.3e}")

    # The actor's loop, scoped: the act step as ``act``, the actions and
    # behaviour logits read back as ``host_sync``.
    scope = StepScope(f"impala_{str(dtype)[6:]}_actor", telemetry=tel,
                      flight_every=FLIGHT_EVERY)
    scoped_act = make_act_step(net, stepscope=scope)
    frames = [torch.randint(0, 256, (ACT_ENVS, 84, 84, 4), generator=gen,
                            device="cuda", dtype=torch.uint8)
              for _ in range(LEDGER_STEPS)]
    done = torch.zeros(ACT_ENVS, dtype=torch.bool, device="cuda")
    box = [net.initial_state(ACT_ENVS)]

    def actor(i):
        actions, logits, box[0] = _no_sync(scoped_act, frames[i], done,
                                           box[0], sample)
        with scope.phase("host_sync"):
            actions.cpu()
            logits.cpu()

    led = _ledger(tel, scope, actor)
    _log_ledger(tag, led)
    return dict(max_err=max(errs), act_ms=ms, ledger=led)


def phase_impala(tel):
    """The impala learner path: full-width ImpalaNet trained on
    experiment.py's learn batch in f32 and in bf16 against the CPU, the
    LSTM variant's act step, then bench_torch.py at B=256 and one of its
    steps profiled."""
    import bench_torch

    out = {str(dtype)[6:]: _impala_train(dtype, tel)
           for dtype in (torch.float32, torch.bfloat16)}
    out["act"] = {str(dtype)[6:]: _impala_act(dtype, tel)
                  for dtype in (torch.float32, torch.bfloat16)}
    line = bench_torch.main(batch=BENCH_B)
    if not line["value"] or line["mfu"] is None:
        raise RuntimeError(f"bench_torch.py gave no throughput or MFU: "
                           f"{line}")
    step, state, batch = bench_torch.build("cuda", BENCH_B)
    for _ in range(2):  # cuDNN's choice of algorithms, first allocations
        state, _ = step(state, batch)
    out["bench"] = dict(line=line, breakdown=_profile_step(
        lambda: step(state, batch), f"bench B={BENCH_B}"))
    return out


BUNDLE_DIR = os.path.join("build", "flightrec")
# The environment prefixes the port's bundles record (the reference's
# MOOLIB, and the card's in place of JAX and XLA).
CARD_ENV_PREFIXES = ("MOOLIB", "TORCH", "PYTORCH", "CUDA", "NCCL")


def phase_bundles(tels) -> dict:
    """One incident bundle per phase's Telemetry, captured through the
    explicit ``api`` trigger into build/flightrec/: each must load and
    validate, and the train and impala bundles must carry a step_phases
    flight event of every scoped loop (each loop's StepScope stamps one
    every FLIGHT_EVERY steps)."""
    from moolib_tpu_torch.flightrec import capture_incident, load_bundle
    from moolib_tpu_torch.telemetry import summarize_stepscope

    out = {}
    for kind, tel in tels.items():
        path = capture_incident("api", f"chip_smoke {kind} phase",
                                telemetry=tel, out_dir=BUNDLE_DIR)
        bundle = load_bundle(path)  # validates
        loops = set(summarize_stepscope(bundle["metrics"][kind]))
        stamped = {e["fields"]["loop"] for e in bundle["events"]
                   if e["kind"] == "step_phases"}
        env = sorted(bundle["fingerprint"]["env"])
        foreign = [k for k in env if k.split("_")[0] not in CARD_ENV_PREFIXES]
        out[kind] = dict(path=path, events=len(bundle["events"]),
                         spans=len(bundle["spans"]),
                         step_phases=len([e for e in bundle["events"]
                                          if e["kind"] == "step_phases"]),
                         loops=sorted(loops), env_keys=env)
        log(f"[flightrec] {kind}: {path} | {out[kind]['events']} events "
            f"({out[kind]['step_phases']} step_phases, loops stamped "
            f"{sorted(stamped)}), {out[kind]['spans']} spans, dropped "
            f"{bundle['events_dropped']}/{bundle['spans_dropped']} | loops "
            f"in its metrics {sorted(loops)} | fingerprint env {env}")
        if foreign:
            raise RuntimeError(f"bundle {path} records env keys outside "
                               f"{CARD_ENV_PREFIXES}: {foreign}")
        if kind != "serve" and stamped != loops:
            raise RuntimeError(f"bundle {path}: scoped loops {sorted(loops)} "
                               f"but step_phases events of {sorted(stamped)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA H100", file=sys.stderr)
        return 2
    from moolib_tpu_torch.ops._kernels import KERNELS

    name, smi = phase_device()
    phase_build()
    fwd_results, fwd_timings = phase_kernel_vs_plain()
    bwd_results, bwd_timings = phase_backward_vs_plain()
    tels = {kind: _telemetry(kind) for kind in ("serve", "train", "impala")}
    serve_launches = phase_serve(tels["serve"])
    train = phase_train(tels["train"])
    context_backward = phase_context_backward()
    for kern in KERNELS:
        kern.launches = 0
    impala = phase_impala(tels["impala"])
    impala_launches = {kern.name: kern.launches for kern in KERNELS}
    if any(impala_launches.values()):
        raise RuntimeError(f"the impala path launched a flash kernel: "
                           f"{impala_launches}")
    bundles = phase_bundles(tels)

    launches_by_path = {
        path: counts for path, counts in
        [*serve_launches.items(), ("train", train["launches"]),
         ("context backward", context_backward),
         ("impala", impala_launches)]
    }
    never = [kname for kname in train["launches"]
             if not any(c[kname] for c in launches_by_path.values())]
    if never:
        raise RuntimeError(f"kernels no path launched: {never}")

    def row(kname, source, replaces, timing, err, shape, extra):
        return {
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(c[kname] for c in launches_by_path.values()),
            "launches_by_path": {p: c[kname]
                                 for p, c in launches_by_path.items()},
            "max_abs_err": err,
            "ms": timing["ms"],
            "device_ms": timing["device_ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "bound_ms_no_resets": timing["bound_ms_no_resets"],
            "library_ms": timing["library_ms"],
            "library_device_ms": timing["library_device_ms"],
            "design": timing["design"],
            "shape": list(shape),
            "parity": "pass",
            **extra,
        }

    f = fwd_results["context (main path)"]
    ctx = fwd_timings["context (main path)"]
    kernels = [row(
        "flash_fwd", "moolib_tpu_torch/ops/csrc/flash_fwd.cu",
        "moolib_tpu/ops/attention.py:226", ctx,
        max(f["o_err"], f["lse_err"]), CONTEXT_SHAPE,
        {"no_resets": fwd_timings["context (no resets)"],
         "act_shape": dict(shape=list(ACT_SHAPE),
                           **fwd_timings["act (main path)"]),
         "train_shape": dict(shape=list(TRAIN_SHAPE),
                             **fwd_timings["train (main path)"]),
         "bf16_shape": dict(shape=[8, 4, 2048, 32],
                            **fwd_timings["B*H=32 T=2048 bf16"])},
    )]
    for kname, line, grads in (("flash_bwd_dq", 362, ("dq",)),
                               ("flash_bwd_dkdv", 407, ("dk", "dv"))):
        b = bwd_results["context (main path)"]
        kernels.append(row(
            kname, "moolib_tpu_torch/ops/csrc/flash_bwd.cu",
            f"moolib_tpu/ops/attention.py:{line}",
            bwd_timings["context (main path)"][kname],
            max(b["errs"][g][0] for g in grads), CONTEXT_SHAPE,
            {"no_resets": bwd_timings["context (no resets)"][kname],
             "bf16_shape": dict(shape=[8, 4, 2048, 32],
                                **bwd_timings["B*H=32 T=2048 bf16"][kname])},
        ))
    b = bwd_results["train (main path)"]
    kernels.append(row(
        "flash_bwd_tile", "moolib_tpu_torch/ops/csrc/flash_bwd.cu",
        "moolib_tpu/ops/attention.py:362 and :407 (both, at Tq, Tk <= 64)",
        bwd_timings["train (main path)"]["flash_bwd_tile"],
        max(b["errs"][g][0] for g in ("dq", "dk", "dv")), TRAIN_SHAPE, {},
    ))
    print(json.dumps({"kernels": kernels,
                      "train": {k: train[k] for k in
                                ("step_ms", "step_host_ms", "breakdown",
                                 "grad_err", "tf32_grad_err", "param_err",
                                 "split_err", "ledgers")},
                      "impala": impala, "bundles": bundles}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
