#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name, capability and power limit; needs sm_90.
2. Build: every hand-written kernel from the sources in the checkout.
3. Kernel vs plain: each kernel's wrapper on the card, held against its
   plain PyTorch version on the same inputs (the main path's shapes
   included), with the kernel's, the plain version's and a library
   call's times and the card's least time for the same work.
4. Serve: the full-width TransformerNet behind two Replicas (the act
   step at T=1 and a 2048-step context window), a few requests each,
   replies held against the same forward with plain dense attention
   on the CPU;
   every kernel's launch count must rise during each service.
5. The kernels line, the card line, and the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

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


def episode_segments(gen: torch.Generator, B: int, T: int) -> torch.Tensor:
    """[B, T] int32 segment ids of lanes that reset every EPISODE_LENGTH
    steps, each at a random phase."""
    phase = torch.randint(0, EPISODE_LENGTH, (B, 1), generator=gen,
                          device="cuda")
    done = (torch.arange(T, device="cuda") + phase) % EPISODE_LENGTH == 0
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
    bandwidth, against 4*D FLOPs per visible pair over the peak for the
    input type. Returns (ms, "bytes" | "operations")."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    item = q.element_size()
    nbytes = (2 * B * H * Tq * D + 2 * B * H * Tk * D) * item
    nbytes += B * H * Tq * 4 + (B * Tq + B * Tk) * 4
    flops = 4 * D * visible_pairs(seg_q, seg_k, H, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def phase_build():
    from moolib_tpu_torch.ops._kernels import FLASH_FWD

    t0 = time.perf_counter()
    FLASH_FWD.ensure_built()
    log(f"[build] {FLASH_FWD.name} ready in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {FLASH_FWD.build_seconds}s)")
    for line in FLASH_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {FLASH_FWD.name}: {line.strip()}")


def _compare(o, lse, o_ref, lse_ref, o_tol_fn):
    if not torch.equal(torch.isinf(lse), torch.isinf(lse_ref)):
        raise RuntimeError("kernel and plain disagree on fully masked rows")
    fin = torch.isfinite(lse_ref)
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() else 0.0
    o_err_t = (o.float() - o_ref.float()).abs()
    ok = bool((o_err_t <= o_tol_fn(o_ref.float().abs())).all())
    return float(o_err_t.max()), lse_err, ok


def phase_kernel_vs_plain():
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import _flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32_tol = lambda ref: 1e-4  # noqa: E731  summation order only
    # bf16 output: one rounding of the f32 result, 2**-7 relative.
    bf16_tol = lambda ref: 2.0 ** -7 * ref + 1e-5  # noqa: E731
    cases = [
        # name, (B, H, Tq, D), Tk, dtype, causal, kv masked rows
        ("context (main path)", CONTEXT_SHAPE, CONTEXT_T, torch.float32,
         True, False),
        ("act (main path)", ACT_SHAPE, 1, torch.float32, True, False),
        ("B*H=32 T=2048 f32", (8, 4, 2048, 32), 2048, torch.float32, True,
         False),
        ("B*H=32 T=2048 bf16", (8, 4, 2048, 32), 2048, torch.bfloat16,
         True, False),
        ("T=20 unroll", (32, 4, 20, 32), 20, torch.float32, True, False),
        ("non-causal masked rows D=64", (2, 4, 256, 64), 384,
         torch.float32, False, True),
        ("causal D=128 bf16", (2, 2, 512, 128), 512, torch.bfloat16, True,
         False),
    ]
    results = {}
    for name, (B, H, Tq, D), Tk, dtype, causal, kv_mask in cases:
        q = torch.randn((B, H, Tq, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, H, Tk, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, H, Tk, D), generator=gen, device="cuda").to(dtype)
        seg_q = episode_segments(gen, B, Tq)
        if kv_mask:
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
        if kv_mask and not torch.isinf(lse).any():
            raise RuntimeError("masked-rows case produced no masked row")
        if lse_err > 1e-4:
            ok = False
        tol_txt = ("2^-7*|o|+1e-5" if dtype == torch.bfloat16 else "1e-4")
        log(f"[kernel] flash_fwd {name}: q {tuple(q.shape)} Tk {Tk} "
            f"{str(dtype)[6:]} causal={causal} | max|o-plain| {o_err:.3e} "
            f"(tol {tol_txt}) max|lse-plain| {lse_err:.3e} (tol 1e-4) | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_fwd disagrees with plain on {name}")
        results[name] = dict(q=q, k=k, v=v, seg_q=seg_q, seg_k=seg_k,
                             causal=causal, o_err=o_err, lse_err=lse_err)

    timings = {}
    for name in ("context (main path)", "act (main path)",
                 "B*H=32 T=2048 f32", "B*H=32 T=2048 bf16"):
        r = results[name]
        q, k, v, sq, sk, causal = (r["q"], r["k"], r["v"], r["seg_q"],
                                   r["seg_k"], r["causal"])
        ms = cuda_ms(lambda: _kernels.flash_fwd(q, k, v, sq, sk, causal), 20)
        plain_ms = cuda_ms(
            lambda: _flash_forward_plain(q, k, v, sq, sk, causal), 5)
        Tq, Tk = q.shape[2], k.shape[2]
        mask = sq[:, None, :, None] == sk[:, None, None, :]
        if causal:
            mask = mask & torch.ones((Tq, Tk), dtype=torch.bool,
                                     device="cuda").tril()
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), 20)
        bound_ms, bound_by = flash_bound_ms(q, k, sq, sk, causal)
        # The same work with no episode reset in the window: the whole
        # causal triangle is visible.
        no_reset_ms, _ = flash_bound_ms(q, k, torch.zeros_like(sq),
                                        torch.zeros_like(sk), causal)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_ms_no_resets=no_reset_ms)
        log(f"[kernel] flash_fwd {name} timing: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({bound_by}), bound with no resets {no_reset_ms:.4f} ms; "
            f"kernel/bound {ms / bound_ms:.1f}x")
    return results, timings


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


def phase_serve():
    from moolib_tpu_torch import Replica, TransformerNet, make_act_step
    from moolib_tpu_torch.ops._kernels import FLASH_FWD

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
                      pad=True, linger_s=0.05, device="cuda")
        try:
            FLASH_FWD.launches = 0
            replies, host_ms, event_ms = _serve(rep, reqs, waves)
            launches[kind] = {FLASH_FWD.name: FLASH_FWD.launches}
        finally:
            rep.close()
        # Hold every reply against the dense-attention forward on the CPU.
        errs = []
        with torch.no_grad():
            for req, out in zip(reqs, replies):
                obs = torch.from_numpy(req["obs"])
                done = torch.from_numpy(req["done"])
                if kind == "act":
                    (logits, _), _ = dense(obs[None], done[None], ())
                    errs.append(_check("act logits", out["logits"],
                                       logits[0].numpy(), (ACT_ENVS, 6)))
                    a = np.asarray(out["action"])
                    if a.shape != (ACT_ENVS,) or not ((a >= 0) & (a < 6)).all():
                        raise RuntimeError(f"bad actions {a}")
                else:
                    (logits, baseline), _ = dense(obs[:, None],
                                                  done[:, None], ())
                    errs.append(_check("context logits", out["logits"],
                                       logits[:, 0].numpy(), (CONTEXT_T, 6)))
                    errs.append(_check("context baseline", out["baseline"],
                                       baseline[:, 0].numpy(), (CONTEXT_T,)))
        log(f"[serve] {kind}: {len(reqs)} requests in waves "
            f"{[len(w) for w in waves]} | max|reply-dense on CPU| "
            f"{max(errs):.3e} (tol {SERVE_TOL}) | launches {launches[kind]}")
        if max(errs) > SERVE_TOL:
            raise RuntimeError(f"{kind} replies differ from the CPU forward "
                               f"by {max(errs):.3e} > {SERVE_TOL}")
        log(f"[serve] {kind}: request latency ms (host clock) "
            f"{[round(x, 3) for x in host_ms]}")
        log(f"[serve] {kind}: request latency ms (CUDA events) "
            f"{[round(x, 3) for x in event_ms]}")
        log(f"[serve] {kind}: batch forward ms (CUDA events) "
            f"{[round(x, 3) for x in batch_ms[kind]]}")
        for k, n in launches[kind].items():
            if n == 0:
                raise RuntimeError(f"{k} was never launched by the {kind} "
                                   "service")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA H100", file=sys.stderr)
        return 2
    name, smi = phase_device()
    phase_build()
    results, timings = phase_kernel_vs_plain()
    launches = phase_serve()

    main_case = "context (main path)"
    t = timings[main_case]
    r = results[main_case]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "moolib_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "moolib_tpu/ops/attention.py:226",
        "launches": sum(sv["flash_fwd"] for sv in launches.values()),
        "launches_by_service": {k: sv["flash_fwd"]
                                for k, sv in launches.items()},
        "max_abs_err": max(r["o_err"], r["lse_err"]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_ms_no_resets": t["bound_ms_no_resets"],
        "library_ms": t["library_ms"],
        "shape": list(CONTEXT_SHAPE),
        "parity": "pass",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
