// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, causal and
// segment-masked.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkdv_kernel` in moolib_tpu/ops/attention.py (launched by
// `_flash_backward`). They compute what those kernels compute, not their
// block loops. With scale = 1/sqrt(D), all in f32:
//
//   s[i,j]  = (q[i] . k[j]) * scale
//   p[i,j]  = exp(s[i,j] - lse[i])  where j is visible to i and lse[i] is
//             finite, else 0 (masked: causal j > i or seg_q[i] != seg_k[j];
//             a fully masked row has lse = +inf and contributes exactly 0)
//   dp[i,j] = dO[i] . v[j]
//   ds[i,j] = p[i,j] * (dp[i,j] - delta[i]),  delta[i] = dO[i] . o[i]
//   dQ[i]   = sum_j ds[i,j] k[j] * scale
//   dV[j]   = sum_i p[i,j] dO[i]
//   dK[j]   = sum_i ds[i,j] q[i] * scale
//
// P is rebuilt from the forward's saved lse, not from a second softmax;
// delta is taken from the forward's returned (rounded) o. Inputs are f32 or
// bf16; the gradients are written in the input type.
//
// Three kernels behind three entry points:
//
// flash_bwd_tile_kernel (flash_bwd_tile), for Tq and Tk of at most one
// 64-row tile (the train step's T = 21), where a launch is held by its
// latencies, not by its bytes; it replaces both Pallas backward kernels
// there. One launch computes delta, dQ, dK and dV, one CTA (16 warps) per
// (b, h):
//  - One round trip to memory: q, dO, o, k and v rows by 16-byte cp.async
//    into shared memory as stored (bf16 rows stay bf16, converted as they
//    are read), lse and both segment ids by 4-byte ones, all in flight
//    before one wait and one barrier.
//  - The five products on the tensor cores, mma.sync m16n8k8 with TF32
//    operands, a warp a 16 x 8 output tile, f32 inputs and P and dS kept
//    to f32 accuracy by the 3xTF32 split of the wgmma kernels (bf16 rows
//    are exact in TF32). The same design on the CUDA cores (a lane a
//    pair, then a thread four outputs) ran 0.0048 ms at the train shape
//    against 0.0045 here (PERF.md); either way the two phases take most
//    of the launch, ~1.2-1.5 us each, more than their instruction counts
//    explain (an open question).
//  - S and dP: a warp computes the same tile of both, so P and dS come
//    out of its accumulators elementwise, with the row's delta = dO . o
//    from the row's four lanes (a quarter of D each, two shuffles). The
//    products read P and dS by row (dQ) and by column (dK, dV): a
//    transpose across warps, so they pass through shared memory, one
//    barrier.
//  - dQ = dS.K, dK = dS^T.Q, dV = P^T.dO: each tile sums over the
//    causally visible range only (dQ: keys j <= i; dK, dV: rows i >= j),
//    and a tile of S wholly above the diagonal is not multiplied.
//  - One owner per output element and a fixed order of terms: no atomics,
//    the same bits each run.
//
// flash_bwd_dq_kernel and flash_bwd_dkdv_kernel (flash_bwd_dq,
// flash_bwd_dkdv; delta from the caller), for longer sequences. One CTA
// (one warpgroup, 128 threads) owns 64 rows: query rows in dQ, key rows in
// dK/dV; it streams tiles of the other side and keeps its own rows'
// gradient sums in registers, so every output row has one owner: no
// atomics, and two runs give the same bits.
//  - dQ: S = Q.K^T and dP = dO.V^T on wgmma, with Q and dO (the CTA's own
//    rows, read once) as register A operands where they fit (D = 32, and
//    bf16 at D = 64; shared-memory tiles else) and K and V (the
//    key tile, as stored) from shared memory;
//    P = exp(S - lse) and dS = P o (dP - delta) in registers; dQ += dS.K
//    with dS straight from the accumulator registers as the A operand and
//    K as a K-major tile [D, keys] whose keys are permuted so that the two
//    layouts agree (the forward's V^T trick).
//  - dK/dV: S^T = K.Q^T and dP^T = V.dO^T with K and V (own rows; register
//    A operands at D = 32) and the query tile's Q and dO from shared
//    memory; P^T = exp(S^T - lse[col]),
//    dS^T = P^T o (dP^T - delta[col]); dV += P^T.dO and dK += dS^T.Q from
//    the accumulators, with dO and Q as transposed, permuted K-major tiles.
//    bf16 takes the same explicit transposes (wgmma's transpose bit for
//    16-bit B operands is not used), which keeps one split for both types.
//  - Precision as in the forward: f32 inputs as 3xTF32 on every product
//    (x = hi + lo, hi.hi + hi.lo + lo.hi); bf16 inputs as bf16 operands,
//    with P and dS passed as bf16 hi + lo pairs. Both accumulate in f32.
//  - The streamed tiles' rows (contiguous in device memory) come by bulk
//    copies on the TMA engine into a ring of staging slots with an mbarrier
//    each, and are split (f32) and transposed from there into the operand
//    tiles; rows past the end are zero-filled.
//  - Exact tile skipping: besides the causal range, a CTA keeps only the
//    streamed tiles whose [min, max] of segment ids meets its own rows'
//    interval (dQ: key tiles against the query tile; dK/dV the mirror).
//    Exact for any ids: a skipped tile holds no visible pair, so all of its
//    p are 0 and it adds nothing. Tiles wholly visible skip the
//    per-element mask.
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3, 700 W): each visible
// pair costs 6*D FLOPs in dQ (s, dp, dQ) and 8*D in dK/dV (s, dp, dV, dK).
// At the context shape [4,4,2048,32] f32 with the repo's episode resets
// every 200 steps few pairs are visible, and the bytes (q, k, v, dO, lse,
// delta in; the gradients out) bound both kernels (~6-8 us); with no reset
// in the window the 3xTF32 operations do (~40-50 us). The train step's
// tile kernel moves ~2.7 MB (0.8 us) and is held by its fixed latencies:
// the launch, one memory round trip, two barriers and the stores.
//
// Tile sizes (rows of the streamed side): as wide as shared memory and
// registers allow. dQ: 64 for bf16 and for f32 at D = 32, 32 for f32 at
// D = 64, 16 for f32 at D = 128. dK/dV: 64 for bf16 at D <= 64, 32 for
// bf16 at D = 128 and for f32 at D <= 64 (at 64, f32 at D = 32 needs 255
// registers and spills), 8 for f32 at D = 128. f32 at D = 128 has room
// for one staging slot only.
//
// Each tile's products are retired before the tile ends: a product left
// in flight across the loop's back edge makes ptxas serialize every wgmma
// of the kernel (C7518), which costs far more than the overlap saves; a
// branch around a masked pair's exp does the same (the masks multiply).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "operands.cuh"

namespace {

constexpr int kThreads = 128;    // one warpgroup
constexpr int kRows = 64;        // rows a CTA owns (the wgmma M)
constexpr int kListCap = 128;    // streamed tiles scanned per pass of the list
constexpr int kScanLoads = 16;   // segment-id loads in flight per thread
// List flag of a tile in which every pair is visible (no mask needed).
constexpr int kFullTile = 1 << 30;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float inv_sqrt_dim(int d) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
}

// ---------------------------------------------------------------------------
// wgmma kernels (Tq or Tk past one tile)
// ---------------------------------------------------------------------------

// Shared-memory layout of the dQ (kDQ) or dK/dV kernel for (D, T).
template <int D, typename T, bool kDQ>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);          // operand element bytes
  static constexpr int W = 128 / E;            // elements per swizzle row
  static constexpr bool kBig = kF32 && D == 128;
  // Rows of the streamed side per tile (keys in dQ, queries in dK/dV).
  static constexpr int BN =
      kF32 ? (D == 32 && kDQ ? 64 : D <= 64 ? 32 : kDQ ? 16 : 8)
           : (D == 128 && !kDQ ? 32 : 64);
  static constexpr int kStages = kBig ? 1 : 2;  // staging slots
  static constexpr int kNT = kDQ ? 1 : 2;       // K^T; or Q^T and dO^T
  static constexpr int kParts = kF32 ? 2 : 1;   // hi (and lo)
  static constexpr int DC = D < W ? W : D;      // stored depth, row tiles
  static constexpr int NC = BN < W ? W : BN;    // stored depth, transposed
  static constexpr int kOwnBytes = kRows * DC * E;   // one own tile, one part
  // The own rows (Q and dO, or K and V) are register A operands, read
  // once as the forward keeps Q, where they fit beside the accumulators: 4
  // words a thread per k-step, hi and lo for f32; else shared-memory tiles.
  static constexpr bool kARegs = D == 32 || (kDQ && !kF32 && D == 64);
  static constexpr int kRowBytes = BN * DC * E;      // one streamed tile
  static constexpr int kTBytes = D * NC * E;         // one transposed tile
  static constexpr int kMemRow = D * E;              // one row in memory
  static constexpr int kStageBytes = 2 * BN * kMemRow;
  // Own tiles (Q, dO or K, V), streamed row tiles (K, V or Q, dO), the
  // transposed tiles, the staging ring, then the small arrays.
  static constexpr int kOffOwn = 0;
  static constexpr int kOffRow =
      kOffOwn + (kARegs ? 0 : 2 * kParts * kOwnBytes);
  static constexpr int kOffT = kOffRow + 2 * kParts * kRowBytes;
  static constexpr int kOffStage = kOffT + kNT * kParts * kTBytes;
  static constexpr int kOffBar = kOffStage + kStages * kStageBytes;
  static constexpr int kOffSeg = kOffBar + 8 * kStages;
  static constexpr int kOffLse = kOffSeg + 4 * BN;
  static constexpr int kOffDelta = kOffLse + 4 * BN;
  static constexpr int kOffList = kOffDelta + 4 * BN;
  static constexpr int kOffMin = kOffList + 4 * kListCap;
  static constexpr int kOffMax = kOffMin + 4 * kListCap;
  static constexpr int kOffMisc = kOffMax + 4 * kListCap;
  static constexpr int kBytes = kOffMisc + 16;
  // Room to align the base to 1024 bytes (the swizzle repeats every 1024).
  static constexpr int kSmem = kBytes + 1024;
  static constexpr int kStepsD = D * E / 32;    // k-steps over D
  static constexpr int kStepsN = BN * E / 32;   // k-steps over the tile
  static constexpr int NW = kF32 ? BN / 2 : BN / 4;  // P or dS words
  static_assert(kSmem <= 227 * 1024, "tile set exceeds shared memory");
  static_assert(kStepsN >= 1, "a tile must cover one k-step");
};

// D (+)= A . B^T over STEPS k-steps, A (RA rows) and B (RB rows) both
// K-major tiles in shared memory.
template <int N, int RA, int RB, int STEPS, bool F32>
__device__ __forceinline__ void ss_steps(float (&d)[N / 2], uint32_t a,
                                         uint32_t b, int scale_first) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks) {
    const int sc = ks == 0 ? scale_first : 1;
    if constexpr (F32) {
      wgmma::tf32<N>(d, step_desc<RA>(a, ks), step_desc<RB>(b, ks), sc);
    } else {
      wgmma::bf16<N>(d, step_desc<RA>(a, ks), step_desc<RB>(b, ks), sc);
    }
  }
}

// D = A . B^T, 3xTF32 for f32 (hi.hi + hi.lo + lo.hi; each operand's lo
// tile sits `a_lo` / `b_lo` bytes after its hi tile), one bf16 product
// otherwise.
template <int N, int RA, int RB, int STEPS, bool F32>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a,
                                           int a_lo, uint32_t b, int b_lo) {
  ss_steps<N, RA, RB, STEPS, F32>(d, a, b, 0);
  if constexpr (F32) {
    ss_steps<N, RA, RB, STEPS, F32>(d, a, b + b_lo, 1);
    ss_steps<N, RA, RB, STEPS, F32>(d, a + a_lo, b, 1);
  }
}

// D (+)= A . B^T with A from registers as hi and lo words (see rs_steps;
// kSwap: in the accumulator's order) and B (RB rows) whose lo part sits
// `b_lo` bytes after its hi part: 3xTF32 for f32; for bf16 hi.B, plus
// lo.B where A carries a lo part (kALo: P and dS as bf16 pairs).
template <int N, int RB, int STEPS, bool F32, bool kSwap, bool kALo,
          int NW>
__device__ __forceinline__ void rs_product(float (&d)[N / 2],
                                           const uint32_t (&hi)[NW],
                                           const uint32_t (&lo)[NW],
                                           uint32_t b, int b_lo,
                                           int scale_first) {
  rs_steps<N, RB, STEPS, F32, kSwap>(d, hi, b, scale_first);
  if constexpr (F32 || kALo) rs_steps<N, RB, STEPS, F32, kSwap>(d, lo, b, 1);
  if constexpr (F32) rs_steps<N, RB, STEPS, F32, kSwap>(d, hi, b + b_lo, 1);
}

// A fragments of this thread's two rows (`row`, absolute; rows past n as
// zeros) of a [n, D] matrix, for a product over D: per k-step, rows g and
// g+8 of the warp's 16, columns t and t+4 (f32, as tf32 hi and lo) or
// pairs 2t and 2t+8 (bf16, in hi).
template <int D, typename T, int NW>
__device__ __forceinline__ void a_fragments(const T* src, const int (&row)[2],
                                            int n, uint32_t (&hi)[NW],
                                            uint32_t (&lo)[NW]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < NW / 4; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e & 1];
      if constexpr (std::is_same<T, float>::value) {
        const int c = 8 * ks + t + 4 * (e >> 1);
        const float x = r < n ? src[static_cast<size_t>(r) * D + c] : 0.f;
        const float h = tf32_hi(x);
        hi[4 * ks + e] = __float_as_uint(h);
        lo[4 * ks + e] = __float_as_uint(x - h);
      } else {
        const int c = 16 * ks + 2 * t + 8 * (e >> 1);
        hi[4 * ks + e] = r < n ? *reinterpret_cast<const uint32_t*>(
                                     src + static_cast<size_t>(r) * D + c)
                               : 0u;
        lo[4 * ks + e] = 0u;
      }
    }
  }
}

// Two values of the accumulator's order as A words: f32 as tf32 hi and lo
// (words i and i+1), bf16 as a bf16 pair hi and the pair of what it left
// (word i/2).
template <bool F32, int NW>
__device__ __forceinline__ void to_words(uint32_t (&hi)[NW],
                                         uint32_t (&lo)[NW], int i,
                                         float x0, float x1) {
  if constexpr (F32) {
    const float h0 = tf32_hi(x0), h1 = tf32_hi(x1);
    hi[i] = __float_as_uint(h0);
    hi[i + 1] = __float_as_uint(h1);
    lo[i] = __float_as_uint(x0 - h0);
    lo[i + 1] = __float_as_uint(x1 - h1);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i / 2] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i / 2] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// Rows [r0, r0 + 64) of a [n, D] matrix (rows past n as zeros) into an own
// operand tile: f32 as hi and lo (lo `lo_off` bytes on), bf16 as it is.
template <int D, typename T, int E>
__device__ __forceinline__ void own_tile(unsigned char* dst, int lo_off,
                                         const T* src, int r0, int n) {
  for (int idx = threadIdx.x; idx < kRows * D / 4; idx += kThreads) {
    const int r = 4 * idx / D;
    const int c = 4 * idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load4(src + static_cast<size_t>(r0 + r) * D + c, x);
    store4<T>(dst + swz<E, kRows>(r, c), lo_off, x);
  }
}

// A staged tile of BN rows (n_valid of them real) into its row tile, as
// it is, and into its transposed tile [D, BN] with the tile's rows in the
// order the accumulator's words take (see rs_steps): f32 unit
// (8g + 4h .. +3) of a transposed row holds rows 8g + h + 2e, e < 4; bf16
// rows in order, 8 a unit. Rows past n_valid become zeros.
template <int D, typename T, int E, int BN>
__device__ __forceinline__ void split_tile(unsigned char* row_t, int row_lo,
                                           unsigned char* t_t, int t_lo,
                                           const T* st, int n_valid) {
  for (int idx = threadIdx.x; idx < BN * D / 4; idx += kThreads) {
    const int r = 4 * idx / D;
    const int c = 4 * idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_valid) load4(st + r * D + c, x);
    store4<T>(row_t + swz<E, BN>(r, c), row_lo, x);
  }
  // One 16-byte unit of one dimension per item, the lanes of a warp on
  // consecutive dimensions.
  for (int idx = threadIdx.x; idx < BN * D * E / 16; idx += kThreads) {
    const int d = idx % D;
    const int unit = idx / D;
    if constexpr (std::is_same<T, float>::value) {
      const int r_first = 8 * (unit / 2) + (unit & 1);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_first + 2 * e;
        x[e] = r < n_valid ? st[r * D + d] : 0.f;
      }
      store4<T>(t_t + swz<E, D>(d, 4 * unit), t_lo, x);
    } else {
      const int r_first = 8 * unit;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_first + 2 * e;
        const float a = r < n_valid ? to_f32(st[r * D + d]) : 0.f;
        const float b = r + 1 < n_valid ? to_f32(st[(r + 1) * D + d]) : 0.f;
        w[e] = pack_bf16(a, b);
      }
      *reinterpret_cast<uint4*>(t_t + swz<E, D>(d, r_first)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// [min, max] of seg over rows [r0, min(r0 + 64, n)) into misc[0], misc[1]
// (warp 0; the caller synchronises).
__device__ __forceinline__ void own_interval(const int* seg, int r0, int n,
                                             int* misc) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = r0 + lane; r < min(r0 + kRows, n); r += 32) {
    lo = min(lo, seg[r]);
    hi = max(hi, seg[r]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    misc[0] = lo;
    misc[1] = hi;
  }
}

// The ordered list of streamed tiles t in [t0, t0 + nt) (tile t covers
// rows [t*BN, min((t+1)*BN, n)) of seg) whose [min, max] of seg meets
// [lo, hi], flagged kFullTile where full(t, tile_lo, tile_hi) says every
// pair is visible. Every thread calls it; returns the list's length.
// A warp reads 32 consecutive ids kScanLoads times a warp-width apart, all
// loads in flight at once, and reduces each tile's share in registers.
template <int BN, typename Full>
__device__ __forceinline__ int tile_list(const int* seg, int n, int t0, int nt, int lo,
                         int hi, int* tmin, int* tmax, int* list, int* misc,
                         Full full) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kGroup = BN < 32 ? BN : 32;  // lanes of one tile
  for (int j = tid; j < nt; j += kThreads) {
    tmin[j] = INT_MAX;
    tmax[j] = INT_MIN;
  }
  __syncthreads();
  const int kb = t0 * BN;
  const int ke = min(n, (t0 + nt) * BN);
  for (int base0 = kb + 32 * warp; base0 < ke;
       base0 += kThreads * kScanLoads) {
    int sv[kScanLoads];
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u) {
      const int r = base0 + u * kThreads + lane;
      sv[u] = r < ke ? seg[r] : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u) {
      const int base = base0 + u * kThreads;
      if (base >= ke) break;  // the same for the whole warp
      const bool ok = base + lane < ke;
      int vlo = ok ? sv[u] : INT_MAX, vhi = ok ? sv[u] : INT_MIN;
      if constexpr (kGroup == 32) {
        vlo = __reduce_min_sync(0xffffffffu, vlo);
        vhi = __reduce_max_sync(0xffffffffu, vhi);
      } else {
#pragma unroll
        for (int off = 1; off < kGroup; off <<= 1) {
          vlo = min(vlo, __shfl_xor_sync(0xffffffffu, vlo, off));
          vhi = max(vhi, __shfl_xor_sync(0xffffffffu, vhi, off));
        }
      }
      if (lane % kGroup == 0 && ok) {
        atomicMin(&tmin[(base + lane - kb) / BN], vlo);
        atomicMax(&tmax[(base + lane - kb) / BN], vhi);
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int j0 = 0; j0 < nt; j0 += 32) {
      const int j = j0 + lane;
      int f = 0;
      if (j < nt) {
        const int tlo = tmin[j], thi = tmax[j];
        const bool meets = !(thi < lo || tlo > hi);
        f = meets ? (full(t0 + j, tlo, thi) ? 2 : 1) : 0;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, f != 0);
      if (f) {
        list[count + __popc(ballot & ((1u << lane) - 1u))] =
            (t0 + j) | (f == 2 ? kFullTile : 0);
      }
      count += __popc(ballot);
    }
    if (lane == 0) misc[2] = count;
  }
  __syncthreads();
  return misc[2];
}

// Load streamed tile t's rows of a and b (rows [t*BN, ...) of [n, D]
// matrices from row `rows` on) into staging slot `slot` (thread 0 only).
template <typename C, typename T>
__device__ __forceinline__ void fetch_tile(unsigned char* stage, uint64_t* bar,
                                           const T* a, const T* b,
                                           size_t rows, int n, int t,
                                           int slot) {
  constexpr int D = C::kMemRow / C::E;
  const int r0 = t * C::BN;
  const uint32_t bytes = min(C::BN, n - r0) * C::kMemRow;
  unsigned char* dst = stage + slot * C::kStageBytes;
  mbar_expect_tx(&bar[slot], 2 * bytes);
  bulk_load(dst, a + (rows + r0) * D, bytes, &bar[slot]);
  bulk_load(dst + C::BN * C::kMemRow, b + (rows + r0) * D, bytes,
            &bar[slot]);
}

// dQ: one CTA per (b*h, 64 query rows); loops over the visible key tiles.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    int heads, int tq, int tk, int causal) {
  using C = Cfg<D, T, true>;
  constexpr int BN = C::BN;
  constexpr int E = C::E;
  constexpr int NW = C::NW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_t = smem + C::kOffOwn;
  unsigned char* do_t = q_t + C::kParts * C::kOwnBytes;
  unsigned char* k_t = smem + C::kOffRow;
  unsigned char* v_t = k_t + C::kParts * C::kRowBytes;
  unsigned char* stage = smem + C::kOffStage;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  int* segk_s = reinterpret_cast<int*>(smem + C::kOffSeg);
  int* list = reinterpret_cast<int*>(smem + C::kOffList);
  int* tmin = reinterpret_cast<int*>(smem + C::kOffMin);
  int* tmax = reinterpret_cast<int*>(smem + C::kOffMax);
  int* misc = reinterpret_cast<int*>(smem + C::kOffMisc);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  // The heaviest query tiles (most causal key tiles) are scheduled first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t q_rows = static_cast<size_t>(bh) * tq;
  const size_t kv_rows = static_cast<size_t>(bh) * tk;
  const int* segq_b = seg_q + static_cast<size_t>(b) * tq;
  const int* segk_b = seg_k + static_cast<size_t>(b) * tk;
  const float scale = inv_sqrt_dim(D);

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  own_interval(segq_b, q0, tq, misc);
  // This thread's two rows of the 64 x N accumulators.
  const int r0 = 16 * warp + lane / 4;
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  constexpr int kAW = C::kARegs ? 4 * C::kStepsD : 1;
  uint32_t qh[kAW], ql[kAW], doh[kAW], dol[kAW];
  if constexpr (C::kARegs) {
    a_fragments<D>(q + q_rows * D, row, tq, qh, ql);
    a_fragments<D>(dout + q_rows * D, row, tq, doh, dol);
  } else {
    own_tile<D, T, E>(q_t, C::kOwnBytes, q + q_rows * D, q0, tq);
    own_tile<D, T, E>(do_t, C::kOwnBytes, dout + q_rows * D, q0, tq);
  }
  fence_async_smem();
  __syncthreads();
  const int qlo = misc[0], qhi = misc[1];
  int sq[2];
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const bool ok = row[a] < tq;
    sq[a] = ok ? segq_b[row[a]] : 0;
    // A padding row, like a fully masked one, gets lse = +inf: p = 0.
    lse_r[a] = ok ? lse[q_rows + row[a]] : INFINITY;
    dl_r[a] = ok ? delta[q_rows + row[a]] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t dsh[NW], dsl[NW];

  // Causal: keys past the tile's last row are masked for every row here.
  const int k_end = causal ? min(tk, min(q0 + kRows, tq)) : tk;
  const int n_tiles = (k_end + BN - 1) / BN;
  // Every pair of key tile t is visible to every valid row here.
  auto full = [&](int t, int lo, int hi) {
    const int k0 = t * BN;
    return lo == hi && qlo == qhi && lo == qlo && k0 + BN <= tk &&
           (causal == 0 || k0 + BN - 1 <= q0);
  };
  auto seg_of = [&](int j) {
    const int kk = (list[j] & (kFullTile - 1)) * BN + tid;
    return tid < BN && kk < tk ? segk_b[kk] : 0;
  };

  int it = 0;  // visible tiles consumed so far
  for (int t0 = 0; t0 < n_tiles; t0 += kListCap) {
    const int n_list = tile_list<BN>(segk_b, tk, t0, min(kListCap,
                                     n_tiles - t0), qlo, qhi, tmin, tmax,
                                     list, misc, full);
    if (tid == 0) {
      for (int j = 0; j < min(C::kStages, n_list); ++j) {
        fetch_tile<C>(stage, bar, k, v, kv_rows, tk,
                      list[j] & (kFullTile - 1), (it + j) % C::kStages);
      }
    }
    int seg_next = n_list > 0 ? seg_of(0) : 0;

    for (int j = 0; j < n_list; ++j, ++it) {
      const int slot = it % C::kStages;
      const int entry = list[j];
      const bool is_full = entry & kFullTile;
      const int k0 = (entry & (kFullTile - 1)) * BN;
      unsigned char* kt_t = smem + C::kOffT;
      mbar_wait(&bar[slot], (it / C::kStages) & 1);
      const T* st_k =
          reinterpret_cast<const T*>(stage + slot * C::kStageBytes);
      const T* st_v = st_k + BN * D;
      const int n_valid = min(BN, tk - k0);
      split_tile<D, T, E, BN>(k_t, C::kRowBytes, kt_t, C::kTBytes, st_k,
                              n_valid);
      // V only as it is: dP = dO.V^T reads V's rows.
      for (int idx = tid; idx < BN * D / 4; idx += kThreads) {
        const int r = 4 * idx / D;
        const int c = 4 * idx % D;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < n_valid) load4(st_v + r * D + c, x);
        store4<T>(v_t + swz<E, BN>(r, c), C::kRowBytes, x);
      }
      if (tid < BN) segk_s[tid] = seg_next;
      fence_async_smem();
      __syncthreads();  // operand tiles complete; the staging slot is free
      if (tid == 0 && j + C::kStages < n_list) {
        fence_async_smem();
        fetch_tile<C>(stage, bar, k, v, kv_rows, tk,
                      list[j + C::kStages] & (kFullTile - 1), slot);
      }
      if (j + 1 < n_list) seg_next = seg_of(j + 1);

      // S = Q.K^T and dP = dO.V^T on the tensor cores.
      wgmma::fence_operand(acc);
      wgmma::fence_operand(s);
      wgmma::fence_operand(dp);
      wgmma::fence();
      if constexpr (C::kARegs) {
        rs_product<BN, BN, C::kStepsD, C::kF32, false, false>(
            s, qh, ql, smem_addr(k_t), C::kRowBytes, 0);
        rs_product<BN, BN, C::kStepsD, C::kF32, false, false>(
            dp, doh, dol, smem_addr(v_t), C::kRowBytes, 0);
      } else {
        ss_product<BN, kRows, BN, C::kStepsD, C::kF32>(
            s, smem_addr(q_t), C::kOwnBytes, smem_addr(k_t), C::kRowBytes);
        ss_product<BN, kRows, BN, C::kStepsD, C::kF32>(
            dp, smem_addr(do_t), C::kOwnBytes, smem_addr(v_t),
            C::kRowBytes);
      }
      wgmma::commit();
      wgmma::wait_all();
      wgmma::fence_operand(s);
      wgmma::fence_operand(dp);

      // P from lse (masked pairs, keys past tk and rows with lse = +inf
      // give 0), then dS, as A words of the dQ product.
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int a = (i >> 1) & 1;
        const int c = 8 * (i / 4) + 2 * (lane % 4);
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // Branch-free (see the note at the top): p of every pair times
          // the mask; the clamp keeps a masked p finite, so 0 * p = 0.
          const int kpos = k0 + c + e;
          const bool visible =
              is_full | ((kpos < tk) & (segk_s[c + e] == sq[a]) &
                         ((causal == 0) | (row[a] >= kpos)));
          const float x = (s[i + e] * scale - lse_r[a]) * kLog2e;
          const float p = exp2f(fminf(x, 64.f)) * (visible ? 1.f : 0.f);
          ds[e] = p * (dp[i + e] - dl_r[a]);
        }
        to_words<C::kF32>(dsh, dsl, i, ds[0], ds[1]);
      }

      // dQ += dS.K on the tensor cores, retired before the tile ends (see
      // the note at the top).
      wgmma::fence_operand(dsh);
      wgmma::fence_operand(dsl);
      wgmma::fence_operand(acc);
      wgmma::fence();
      rs_product<D, D, C::kStepsN, C::kF32, true, true>(
          acc, dsh, dsl, smem_addr(kt_t), C::kTBytes, 1);
      wgmma::commit();
      wgmma::wait_all();
      wgmma::fence_operand(acc);
      __syncthreads();  // every warp is past its reads of segk_s
    }
  }
  wgmma::wait_all();

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (row[a] >= tq) continue;
    T* dst = dq + (q_rows + row[a]) * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      store2(&dst[c], acc[i + 2 * a] * scale, acc[i + 2 * a + 1] * scale);
    }
  }
}

// dK/dV: one CTA per (b*h, 64 key rows); loops over the visible query
// tiles.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const T* __restrict__ dout, T* __restrict__ dk,
                      T* __restrict__ dv, int heads, int tq, int tk,
                      int causal) {
  using C = Cfg<D, T, false>;
  constexpr int BN = C::BN;
  constexpr int E = C::E;
  constexpr int NW = C::NW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k_t = smem + C::kOffOwn;
  unsigned char* v_t = k_t + C::kParts * C::kOwnBytes;
  unsigned char* qr_t = smem + C::kOffRow;
  unsigned char* dor_t = qr_t + C::kParts * C::kRowBytes;
  unsigned char* stage = smem + C::kOffStage;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  int* segq_s = reinterpret_cast<int*>(smem + C::kOffSeg);
  float* lse_s = reinterpret_cast<float*>(smem + C::kOffLse);
  float* dl_s = reinterpret_cast<float*>(smem + C::kOffDelta);
  int* list = reinterpret_cast<int*>(smem + C::kOffList);
  int* tmin = reinterpret_cast<int*>(smem + C::kOffMin);
  int* tmax = reinterpret_cast<int*>(smem + C::kOffMax);
  int* misc = reinterpret_cast<int*>(smem + C::kOffMisc);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  // Causal: the first key tiles see the most query tiles; they go first.
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t q_rows = static_cast<size_t>(bh) * tq;
  const size_t kv_rows = static_cast<size_t>(bh) * tk;
  const int* segq_b = seg_q + static_cast<size_t>(b) * tq;
  const int* segk_b = seg_k + static_cast<size_t>(b) * tk;
  const float scale = inv_sqrt_dim(D);

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  own_interval(segk_b, k0, tk, misc);
  const int r0 = 16 * warp + lane / 4;
  const int krow[2] = {k0 + r0, k0 + r0 + 8};
  constexpr int kAW = C::kARegs ? 4 * C::kStepsD : 1;
  uint32_t kh[kAW], kl[kAW], vh[kAW], vl[kAW];
  if constexpr (C::kARegs) {
    a_fragments<D>(k + kv_rows * D, krow, tk, kh, kl);
    a_fragments<D>(v + kv_rows * D, krow, tk, vh, vl);
  } else {
    own_tile<D, T, E>(k_t, C::kOwnBytes, k + kv_rows * D, k0, tk);
    own_tile<D, T, E>(v_t, C::kOwnBytes, v + kv_rows * D, k0, tk);
  }
  fence_async_smem();
  __syncthreads();
  const int klo = misc[0], khi = misc[1];
  int sk[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) sk[a] = krow[a] < tk ? segk_b[krow[a]] : 0;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  float st[BN / 2], dpt[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t ph[NW], pl[NW], dsh[NW], dsl[NW];

  // Causal: query tiles that end before this key tile see none of it (k0
  // is a multiple of BN, so the first tile to visit starts at k0).
  const int t_begin = causal ? k0 / BN : 0;
  const int n_tiles = max(0, (tq + BN - 1) / BN - t_begin);
  auto full = [&](int t, int lo, int hi) {
    const int i0 = t * BN;
    return lo == hi && klo == khi && lo == klo && i0 + BN <= tq &&
           (causal == 0 || i0 >= k0 + kRows - 1);
  };
  // This thread's query column of list entry j's tile (tid < BN): its
  // segment id, lse (+inf past tq: p = 0) and delta.
  struct Col {
    int seg;
    float lse, delta;
  };
  auto col_of = [&](int j) {
    const int i = (list[j] & (kFullTile - 1)) * BN + tid;
    const bool ok = tid < BN && i < tq;
    return Col{ok ? segq_b[i] : 0, ok ? lse[q_rows + i] : INFINITY,
               ok ? delta[q_rows + i] : 0.f};
  };

  int it = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kListCap) {
    const int n_list = tile_list<BN>(segq_b, tq, t_begin + t0,
                                     min(kListCap, n_tiles - t0), klo, khi,
                                     tmin, tmax, list, misc, full);
    if (tid == 0) {
      for (int j = 0; j < min(C::kStages, n_list); ++j) {
        fetch_tile<C>(stage, bar, q, dout, q_rows, tq,
                      list[j] & (kFullTile - 1), (it + j) % C::kStages);
      }
    }
    Col col_next = n_list > 0 ? col_of(0) : Col{0, INFINITY, 0.f};

    for (int j = 0; j < n_list; ++j, ++it) {
      const int slot = it % C::kStages;
      const int entry = list[j];
      const bool is_full = entry & kFullTile;
      const int i0 = (entry & (kFullTile - 1)) * BN;
      unsigned char* qt_t = smem + C::kOffT;
      unsigned char* dot_t = qt_t + C::kParts * C::kTBytes;
      mbar_wait(&bar[slot], (it / C::kStages) & 1);
      const T* st_q =
          reinterpret_cast<const T*>(stage + slot * C::kStageBytes);
      const T* st_do = st_q + BN * D;
      const int n_valid = min(BN, tq - i0);
      split_tile<D, T, E, BN>(qr_t, C::kRowBytes, qt_t, C::kTBytes, st_q,
                              n_valid);
      split_tile<D, T, E, BN>(dor_t, C::kRowBytes, dot_t, C::kTBytes, st_do,
                              n_valid);
      if (tid < BN) {
        segq_s[tid] = col_next.seg;
        lse_s[tid] = col_next.lse;
        dl_s[tid] = col_next.delta;
      }
      fence_async_smem();
      __syncthreads();  // operand tiles complete; the staging slot is free
      if (tid == 0 && j + C::kStages < n_list) {
        fence_async_smem();
        fetch_tile<C>(stage, bar, q, dout, q_rows, tq,
                      list[j + C::kStages] & (kFullTile - 1), slot);
      }
      if (j + 1 < n_list) col_next = col_of(j + 1);

      // S^T = K.Q^T and dP^T = V.dO^T.
      wgmma::fence_operand(dk_acc);
      wgmma::fence_operand(dv_acc);
      wgmma::fence_operand(st);
      wgmma::fence_operand(dpt);
      wgmma::fence();
      if constexpr (C::kARegs) {
        rs_product<BN, BN, C::kStepsD, C::kF32, false, false>(
            st, kh, kl, smem_addr(qr_t), C::kRowBytes, 0);
        rs_product<BN, BN, C::kStepsD, C::kF32, false, false>(
            dpt, vh, vl, smem_addr(dor_t), C::kRowBytes, 0);
      } else {
        ss_product<BN, kRows, BN, C::kStepsD, C::kF32>(
            st, smem_addr(k_t), C::kOwnBytes, smem_addr(qr_t),
            C::kRowBytes);
        ss_product<BN, kRows, BN, C::kStepsD, C::kF32>(
            dpt, smem_addr(v_t), C::kOwnBytes, smem_addr(dor_t),
            C::kRowBytes);
      }
      wgmma::commit();
      wgmma::wait_all();
      wgmma::fence_operand(st);
      wgmma::fence_operand(dpt);

      // P^T and dS^T, column by column (a column is a query).
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int a = (i >> 1) & 1;
        const int c = 8 * (i / 4) + 2 * (lane % 4);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qpos = i0 + c + e;
          const bool visible =
              is_full | ((segq_s[c + e] == sk[a]) &
                         ((causal == 0) | (qpos >= krow[a])));
          const float x = (st[i + e] * scale - lse_s[c + e]) * kLog2e;
          p[e] = exp2f(fminf(x, 64.f)) * (visible ? 1.f : 0.f);
          ds[e] = p[e] * (dpt[i + e] - dl_s[c + e]);
        }
        to_words<C::kF32>(ph, pl, i, p[0], p[1]);
        to_words<C::kF32>(dsh, dsl, i, ds[0], ds[1]);
      }

      // dV += P^T.dO and dK += dS^T.Q, retired before the tile ends.
      wgmma::fence_operand(ph);
      wgmma::fence_operand(pl);
      wgmma::fence_operand(dsh);
      wgmma::fence_operand(dsl);
      wgmma::fence_operand(dv_acc);
      wgmma::fence_operand(dk_acc);
      wgmma::fence();
      rs_product<D, D, C::kStepsN, C::kF32, true, true>(
          dv_acc, ph, pl, smem_addr(dot_t), C::kTBytes, 1);
      rs_product<D, D, C::kStepsN, C::kF32, true, true>(
          dk_acc, dsh, dsl, smem_addr(qt_t), C::kTBytes, 1);
      wgmma::commit();
      wgmma::wait_all();
      wgmma::fence_operand(dv_acc);
      wgmma::fence_operand(dk_acc);
      __syncthreads();  // every warp is past its reads of the column arrays
    }
  }
  wgmma::wait_all();

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (krow[a] >= tk) continue;
    const size_t off = (kv_rows + krow[a]) * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      store2(&dk[off + c], dk_acc[i + 2 * a] * scale,
             dk_acc[i + 2 * a + 1] * scale);
      store2(&dv[off + c], dv_acc[i + 2 * a], dv_acc[i + 2 * a + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// One tile: delta, dQ, dK and dV in one launch
// ---------------------------------------------------------------------------

constexpr int kTileMax = 64;        // Tq and Tk it is chosen for
constexpr int kTileThreads = 512;  // 16 warps, a product tile each

// Shared-memory layout of one CTA, in bytes: the q, dO, o, k and v rows
// in the input type at a stride of D + 16 bytes, then P and dS [tq, pst]
// in f32 (pst = tk rounded up to 8, plus 4: the fragment reads of a warp,
// rows g and columns t, fall in 32 different banks), lse and the segment
// ids.
template <int D, typename T>
struct TileLayout {
  static constexpr int kStride = D + 16 / static_cast<int>(sizeof(T));
  __host__ __device__ static int pst(int tk) { return (tk + 7) / 8 * 8 + 4; }
  __host__ __device__ static int rows_bytes(int tq, int tk) {
    return (3 * tq + 2 * tk) * kStride * static_cast<int>(sizeof(T));
  }
  __host__ __device__ static int bytes(int tq, int tk) {
    return rows_bytes(tq, tk) + 4 * (2 * tq * pst(tk) + 2 * tq + tk);
  }
};

// d += a . b for one m16n8k8 tile on the tensor cores, TF32 operands.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f32 -> (hi, lo) TF32 words: hi cut to tf32, lo = x - hi.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float h = tf32_hi(x[e]);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(x[e] - h);
  }
}

// Element (r, c) of a [rows, cols] matrix in shared memory (row stride
// `stride`) as f32; 0 past its rows or columns, which pads a product's
// tiles with zeros.
template <typename T>
__device__ __forceinline__ float at(const T* m, int stride, int r, int c,
                                    int rows, int cols) {
  return r < rows && c < cols ? to_f32(m[r * stride + c]) : 0.f;
}

// One 16 x 8 tile of A . B at (m0, n0) over k in [k_begin, k_end) (k-steps
// of 8; elements past the matrices read as 0), A and B given by element:
// a_at(m, k), b_at(k, n). Lane (g, t) = (lane / 4, lane % 4) holds A's
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B's (t, g), (t + 4, g)
// and the result's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// 3xTF32: a.b = ah.bh + (ah.bl + al.bh) to f32 accuracy, the small terms
// in a second accumulator so the two chains overlap.
template <typename FA, typename FB>
__device__ __forceinline__ void tile_product(float (&d)[4], FA a_at, FB b_at,
                                             int m0, int n0, int k_begin,
                                             int k_end, int lane) {
  const int g = lane / 4, t = lane % 4;
  float small[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    const float a[4] = {a_at(m0 + g, k0 + t), a_at(m0 + g + 8, k0 + t),
                        a_at(m0 + g, k0 + t + 4),
                        a_at(m0 + g + 8, k0 + t + 4)};
    const float b[2] = {b_at(k0 + t, n0 + g), b_at(k0 + t + 4, n0 + g)};
    uint32_t ah[4], al[4], bh[2], bl[2];
    split(a, ah, al);
    split(b, bh, bl);
    mma_tf32(small, ah, bl);
    mma_tf32(small, al, bh);
    mma_tf32(d, ah, bh);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += small[e];
}

// One CTA per (b, h); the design is in the note at the top of the file.
template <int D, typename T>
__global__ void __launch_bounds__(kTileThreads)
flash_bwd_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      const T* __restrict__ o,
                      const float* __restrict__ lse,
                      const T* __restrict__ dout, T* __restrict__ dq,
                      T* __restrict__ dk, T* __restrict__ dv, int heads,
                      int tq, int tk, int causal) {
  using L = TileLayout<D, T>;
  constexpr int S = L::kStride;
  constexpr int kUnits = D * sizeof(T) / 16;  // 16-byte units of a row
  constexpr int kWarps = kTileThreads / 32;
  extern __shared__ float4 tile_smem[];
  T* q_s = reinterpret_cast<T*>(tile_smem);
  T* do_s = q_s + tq * S;
  T* o_s = do_s + tq * S;
  T* k_s = o_s + tq * S;
  T* v_s = k_s + tk * S;
  const int pst = L::pst(tk);
  float* p_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(tile_smem) + L::rows_bytes(tq, tk));
  float* ds_s = p_s + tq * pst;
  float* lse_s = ds_s + tq * pst;
  int* sq_s = reinterpret_cast<int*>(lse_s + tq);
  int* sk_s = sq_s + tq;

  const int bh = blockIdx.x;
  const size_t b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_rows = static_cast<size_t>(bh) * tq;
  const size_t kv_rows = static_cast<size_t>(bh) * tk;
  const float scale = inv_sqrt_dim(D);

  for (int u = tid; u < tq * kUnits; u += kTileThreads) {
    const int r = u / kUnits;
    const int off = 16 * (u % kUnits);
    const size_t src = (q_rows + r) * D;
    copy_unit(q_s + r * S, q + src, off);
    copy_unit(do_s + r * S, dout + src, off);
    copy_unit(o_s + r * S, o + src, off);
  }
  for (int u = tid; u < tk * kUnits; u += kTileThreads) {
    const int r = u / kUnits;
    const int off = 16 * (u % kUnits);
    const size_t src = (kv_rows + r) * D;
    copy_unit(k_s + r * S, k + src, off);
    copy_unit(v_s + r * S, v + src, off);
  }
  for (int i = tid; i < tq; i += kTileThreads) {
    cp_async4(lse_s + i, lse + q_rows + i);
    cp_async4(sq_s + i, seg_q + b * tq + i);
  }
  for (int j = tid; j < tk; j += kTileThreads) {
    cp_async4(sk_s + j, seg_k + b * tk + j);
  }
  cp_async_wait_all();
  __syncthreads();

  // S = Q.K^T and dP = dO.V^T, a warp a 16 x 8 tile of both; P and dS
  // from the accumulators into shared memory.
  const int n_nt = (tk + 7) / 8;
  for (int tile = warp; tile < (tq + 15) / 16 * n_nt; tile += kWarps) {
    const int m0 = 16 * (tile / n_nt);
    const int n0 = 8 * (tile % n_nt);
    // delta of rows m0 + g and m0 + g + 8: each lane of the row's four
    // takes a quarter of D, two shuffles add them.
    float delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m0 + g + 8 * h;
      float part = 0.f;
      if (i < tq) {
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          const int c = t * D / 4 + 4 * u;
          float x[4], y[4];
          load4(do_s + i * S + c, x);
          load4(o_s + i * S + c, y);
          part += x[0] * y[0] + x[1] * y[1] + x[2] * y[2] + x[3] * y[3];
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      delta[h] = part + __shfl_xor_sync(0xffffffffu, part, 2);
    }
    // A tile wholly above the diagonal holds no visible pair.
    const bool any = causal == 0 || n0 <= m0 + 15;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    if (any) {
      tile_product(
          s, [&](int i, int c) { return at(q_s, S, i, c, tq, D); },
          [&](int c, int j) { return at(k_s, S, j, c, tk, D); }, m0, n0, 0,
          D, lane);
      tile_product(
          dp, [&](int i, int c) { return at(do_s, S, i, c, tq, D); },
          [&](int c, int j) { return at(v_s, S, j, c, tk, D); }, m0, n0, 0,
          D, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + g + 8 * (e >> 1);
      const int j = n0 + 2 * t + (e & 1);
      if (i >= tq || j >= tk) continue;
      float p = 0.f, ds = 0.f;
      if (any && (causal == 0 || i >= j) && isfinite(lse_s[i]) &&
          sq_s[i] == sk_s[j]) {
        p = exp2f((s[e] * scale - lse_s[i]) * kLog2e);
        ds = p * (dp[e] - delta[e >> 1]);
      }
      p_s[i * pst + j] = p;
      ds_s[i * pst + j] = ds;
    }
  }
  __syncthreads();

  // dQ = dS.K, dK = dS^T.Q and dV = P^T.dO, a warp a 16 x 8 tile of one;
  // each sum over the causally visible range only (dQ: keys j <= i;
  // dK, dV: query rows i >= j).
  constexpr int kNt = D / 8;
  const int n_q = (tq + 15) / 16 * kNt;
  const int n_k = (tk + 15) / 16 * kNt;
  for (int tile = warp; tile < n_q + 2 * n_k; tile += kWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    T* out;
    int m0, n0, rows;
    float mul;
    if (tile < n_q) {
      m0 = 16 * (tile / kNt);
      n0 = 8 * (tile % kNt);
      tile_product(
          acc, [&](int i, int j) { return at(ds_s, pst, i, j, tq, tk); },
          [&](int j, int c) { return at(k_s, S, j, c, tk, D); }, m0, n0, 0,
          causal ? min(tk, m0 + 16) : tk, lane);
      out = dq + q_rows * D;
      rows = tq;
      mul = scale;
    } else {
      const bool is_v = tile >= n_q + n_k;
      const int u = tile - n_q - (is_v ? n_k : 0);
      m0 = 16 * (u / kNt);
      n0 = 8 * (u % kNt);
      // A = P^T or dS^T, [tk, tq]: the stored [tq, tk] matrix transposed.
      const float* a_mat = is_v ? p_s : ds_s;
      const T* b_rows = is_v ? do_s : q_s;
      tile_product(
          acc, [&](int j, int i) { return at(a_mat, pst, i, j, tq, tk); },
          [&](int i, int c) { return at(b_rows, S, i, c, tq, D); }, m0, n0,
          causal ? m0 : 0, tq, lane);
      out = (is_v ? dv : dk) + kv_rows * D;
      rows = tk;
      mul = is_v ? 1.f : scale;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      if (r < rows) {
        store2(out + r * D + n0 + 2 * t, acc[2 * h] * mul,
               acc[2 * h + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg_q;
  const int* seg_k;
  const void* o;
  const float* lse;
  const float* delta;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int bh, heads, tq, tk, causal;
  cudaStream_t stream;
};

// Above 48 KB a block's shared memory must be asked for (once per kernel).
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, typename T>
struct DQ {
  static cudaError_t run(const Args& a) {
    constexpr int smem = Cfg<D, T, true>::kSmem;
    static const cudaError_t configured =
        allow_smem(flash_bwd_dq_kernel<D, T>, smem);
    if (configured != cudaSuccess) return configured;
    const dim3 grid(a.bh, (a.tq + kRows - 1) / kRows);
    flash_bwd_dq_kernel<D, T><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k, a.lse, a.delta,
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.heads, a.tq,
        a.tk, a.causal);
    return cudaGetLastError();
  }
};

template <int D, typename T>
struct DKDV {
  static cudaError_t run(const Args& a) {
    constexpr int smem = Cfg<D, T, false>::kSmem;
    static const cudaError_t configured =
        allow_smem(flash_bwd_dkdv_kernel<D, T>, smem);
    if (configured != cudaSuccess) return configured;
    const dim3 grid(a.bh, (a.tk + kRows - 1) / kRows);
    flash_bwd_dkdv_kernel<D, T><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k, a.lse, a.delta,
        static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.heads, a.tq, a.tk, a.causal);
    return cudaGetLastError();
  }
};

template <int D, typename T>
struct Tile {
  static cudaError_t run(const Args& a) {
    if (a.tq > kTileMax || a.tk > kTileMax) return cudaErrorInvalidValue;
    static const cudaError_t configured =
        allow_smem(flash_bwd_tile_kernel<D, T>,
                   TileLayout<D, T>::bytes(kTileMax, kTileMax));
    if (configured != cudaSuccess) return configured;
    const int smem = TileLayout<D, T>::bytes(a.tq, a.tk);
    flash_bwd_tile_kernel<D, T><<<a.bh, kTileThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k,
        static_cast<const T*>(a.o), a.lse, static_cast<const T*>(a.dout),
        static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.heads, a.tq, a.tk, a.causal);
    return cudaGetLastError();
  }
};

// Pick the instantiation for (d, dtype): dtype 0 is f32, 1 is bf16.
template <template <int, typename> class Launch>
cudaError_t dispatch(int d, int dtype, const Args& a) {
  if (dtype == 0) {
    switch (d) {
      case 32: return Launch<32, float>::run(a);
      case 64: return Launch<64, float>::run(a);
      case 128: return Launch<128, float>::run(a);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 32: return Launch<32, __nv_bfloat16>::run(a);
      case 64: return Launch<64, __nv_bfloat16>::run(a);
      case 128: return Launch<128, __nv_bfloat16>::run(a);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/dout [bh, tq, d], k/v [bh, tk, d] contiguous and 16-byte aligned, f32
// (dtype 0) or bf16 (dtype 1); seg_q [bh/heads, tq], seg_k [bh/heads, tk]
// int32; lse and delta [bh, tq] f32; dq like q. Launches on `stream` and
// returns cudaGetLastError().
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const int* seg_q, const int* seg_k, const float* lse,
                 const float* delta, const void* dout, void* dq, int bh,
                 int heads, int tq, int tk, int d, int causal, int dtype,
                 void* stream) {
  const Args a{q, k, v, seg_q, seg_k, nullptr, lse, delta, dout, dq,
               nullptr, nullptr, bh, heads, tq, tk, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<DQ>(d, dtype, a);
}

// As flash_bwd_dq; dk and dv like k.
int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, const float* lse,
                   const float* delta, const void* dout, void* dk, void* dv,
                   int bh, int heads, int tq, int tk, int d, int causal,
                   int dtype, void* stream) {
  const Args a{q, k, v, seg_q, seg_k, nullptr, lse, delta, dout, nullptr,
               dk, dv, bh, heads, tq, tk, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<DKDV>(d, dtype, a);
}

// The whole backward at tq, tk <= 64 in one launch: as flash_bwd_dq and
// flash_bwd_dkdv, but with the forward's o (like q) in place of delta.
int flash_bwd_tile(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, int bh, int heads, int tq, int tk, int d,
                   int causal, int dtype, void* stream) {
  const Args a{q, k, v, seg_q, seg_k, o, lse, nullptr, dout, dq, dk, dv,
               bh, heads, tq, tk, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<Tile>(d, dtype, a);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
