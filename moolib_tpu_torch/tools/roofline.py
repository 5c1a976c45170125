"""Analytic roofline for the ImpalaNet train step on the H100: where does
the time go, and what MFU is attainable at all; the twin of the
reference's ``tools/roofline.py``.

Per layer this prints (a) useful model FLOPs, (b) the tensor-core tile
efficiency of the conv as an implicit GEMM — contraction K = kh*kw*c_in
and output columns N = c_out, each padded up to the tile granularity —
and (c) activation bytes moved (bf16), giving an HBM time floor. The
layer walk, the FLOPs and the bytes are the reference's
(:func:`~moolib_tpu_torch.utils.flops.impala_layer_walk`, the same
source ``bench_torch.py``'s MFU uses); the card's figures replace the
TPU's: 989 TFLOP/s dense bf16 and 3.35 TB/s (NVIDIA's H100 SXM data
sheet, at 700 W).

The granularity assumed in place of the TPU's 128x128 MXU padding: cuDNN
runs these convolutions as implicit GEMMs on Hopper's tensor cores, whose
bf16 instruction (``wgmma`` m64nNk16) takes K in steps of 16 and N in
steps of 8. That is the finest padding any tensor-core mapping can have
(cuDNN's kernels tile coarser, at their CTA tiles, which it does not
report), so the tile ceiling and the attainable MFU are upper bounds.

Usage::

    python -m moolib_tpu_torch.tools.roofline [B] [T] [--measured-mfu F]

(defaults B=256 T=20; the measured MFU defaults to ``bench_torch.py``'s
2.18% at B=256 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §5). Pure
Python: runs anywhere, no card needed.
"""

from __future__ import annotations

import argparse
import math
import sys

from ..utils.flops import TRAIN_FLOPS_MULTIPLIER, impala_layer_walk

#: wgmma's bf16 granularity: K in steps of 16, N in steps of 8.
TILE_K, TILE_N = 16, 8
BF16 = 2  # bytes
PEAK = 989e12  # H100 SXM dense bf16 FLOP/s
HBM = 3.35e12  # H100 SXM bytes/s
#: bench_torch.py at B=256 (PERF.md §5: H100 80GB HBM3, 700 W).
MEASURED_MFU_B256 = 0.0218
MEASURED_MS_B256 = 81.25


def tile_eff(k: int, n: int, tile_k: int = TILE_K, tile_n: int = TILE_N
             ) -> float:
    """Useful-MAC fraction of a (M,K)x(K,N) GEMM, M large, with K padded
    to ``tile_k`` and N to ``tile_n``."""
    return (k * n) / (math.ceil(k / tile_k) * tile_k
                      * math.ceil(n / tile_n) * tile_n)


def analyze(B: int = 256, T: int = 20) -> dict:
    """The roofline's numbers for one train step of [T+1, B] frames."""
    frames = (T + 1) * B
    rows = list(impala_layer_walk())
    tot_f = sum(r[1] for r in rows)
    act_bytes = sum(r[4] * BF16 for r in rows)
    train_f = TRAIN_FLOPS_MULTIPLIER * frames * tot_f
    ceiling = tot_f / sum(r[1] / tile_eff(r[2], r[3]) for r in rows)
    # fwd reads each layer's input (~ the previous layer's output) and
    # writes its activation; bwd re-reads the activation and writes a
    # grad of the same shape -> ~4x fwd activation bytes. Weight traffic
    # is omitted (~1.6 MB of parameters).
    traffic = 4 * frames * act_bytes
    t_peak = train_f / PEAK
    t_hbm = traffic / HBM
    return {
        "B": B, "T": T, "frames": frames, "rows": rows,
        "fwd_flops_per_frame": tot_f, "train_flops": train_f,
        "tile_ceiling": ceiling, "traffic_bytes": traffic,
        "peak_ms": 1e3 * t_peak, "hbm_ms": 1e3 * t_hbm,
        "attainable_mfu": t_peak / max(t_peak / ceiling, t_hbm),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=256)
    ap.add_argument("T", nargs="?", type=int, default=20)
    ap.add_argument("--measured-mfu", type=float, default=None,
                    help="a measured MFU to print beside the attainable "
                         "one (default at B=256: bench_torch.py's)")
    args = ap.parse_args(argv)
    a = analyze(args.B, args.T)
    print(f"{'layer':38s} {'MFLOP/frm':>9s} {'share':>6s} {'K':>5s} "
          f"{'N':>4s} {'tile_eff':>8s} {'act_KB':>7s}")
    tot_f = a["fwd_flops_per_frame"]
    for name, f, k, n, elems in a["rows"]:
        print(f"{name:38s} {f / 1e6:9.2f} {f / tot_f:6.1%} {k:5d} {n:4d} "
              f"{tile_eff(k, n):8.1%} {elems * BF16 / 1024:7.0f}")
    print(f"\nper-frame useful fwd FLOPs:    {tot_f / 1e6:.1f} M")
    print(f"train step ({a['frames']} frames):  "
          f"{a['train_flops'] / 1e12:.3f} TFLOP useful")
    print(f"tile ceiling (k16/n8):         {a['tile_ceiling']:.1%} MFU")
    print(f"tensor-core floor @989T bf16:  {a['peak_ms']:.2f} ms "
          f"(100% MFU)")
    print(f"activation traffic (~4x fwd):  {a['traffic_bytes'] / 1e9:.2f} GB "
          f"-> HBM floor {a['hbm_ms']:.2f} ms @3.35TB/s")
    measured = args.measured_mfu
    if measured is None and (args.B, args.T) == (256, 20):
        measured = MEASURED_MFU_B256
    print(f"attainable MFU: {a['attainable_mfu']:.1%}"
          + (f"; measured {measured:.2%}" if measured is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
