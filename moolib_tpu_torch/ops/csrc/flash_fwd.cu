// Flash-attention forward for Hopper (sm_90a), causal and segment-masked.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// moolib_tpu/ops/attention.py (launched by `_flash_forward`). It computes
// what that kernel computes, not its block loop:
//
//   s[i,j]  = (q[i] . k[j]) / sqrt(D)                in f32
//   s[i,j]  = -1e30 where j is masked for i          (the mask floor)
//   masked: causal (j > i) or seg_q[i] != seg_k[j]
//   s[i,j]  = -inf for j >= Tk                        (keys that do not exist)
//   o[i]    = sum_j exp(s[i,j] - m[i]) v[j] / l[i],  online over key tiles
//   lse[i]  = m[i] + log(l[i])
//
// A row whose running max is still <= -1e30/2 is fully masked: its
// probabilities are 0, its output is zeros and its lse is +inf. Inputs are
// f32 or bf16; the softmax state runs in f32. `o` is written in the input
// type, `lse` in f32.
//
// Two designs behind one entry point:
//
// flash_fwd_wgmma_kernel, for any sequence longer than one 64-row tile.
// One CTA (one warpgroup, 128 threads) owns 64 query rows of one (b, h).
//  - Segment-aware tile skipping. The CTA takes [min, max] of seg_q over
//    its valid rows and, for every causal key tile, [min, max] of that
//    tile's seg_k; a tile whose interval is disjoint from the query tile's
//    holds no visible pair, so it is neither loaded nor multiplied. The
//    skip is exact for any ids: such a tile's scores all sit at the floor,
//    which leaves m, l and acc unchanged (scale_old is 1 for a row with a
//    visible key and 0 either way for a row without one). With the model's
//    monotone ids (a cumsum of resets) it skips exactly the tiles that lie
//    wholly in earlier episodes.
//  - Both products on the tensor cores through wgmma. bf16 inputs: Q.K^T
//    with bf16 operands (exact products, f32 accumulation); P.V with P as
//    a bf16 hi + lo pair (two products), so P keeps ~16 bits. f32 inputs:
//    3xTF32 on both products, x = hi + lo with hi = x cut to tf32 and
//    lo = x - hi (exact), product = hi.hi + hi.lo + lo.hi, which keeps
//    f32-level accuracy where plain TF32 would give ~1e-3.
//  - tf32 wgmma takes K-major operands only, so V is transposed to
//    [D, keys] on its way into the operand tiles; K as stored ([keys, D])
//    is already K-major. Q is the A operand of Q.K^T from registers,
//    loaded once (in shared memory for f32 at D = 128, where its hi and lo
//    would take 128 registers). P stays in registers as the A operand of
//    P.V: for bf16 the S accumulator's layout already is A's; for tf32 it
//    holds columns 2t, 2t+1 where A wants t, t+4, so V^T's keys are stored
//    in the order that makes the two agree (no shuffle, no trip through
//    shared memory). V^T has two buffers, so the P.V product of one tile
//    runs while the next tile is split.
//  - Asynchronous loads: the visible tiles' K and V rows (contiguous in
//    device memory) come by bulk copies on the TMA engine into a ring of
//    two staging slots with an mbarrier each; the next two visible tiles
//    are in flight while the current one is split, transposed and
//    multiplied. Keys past Tk are zero-filled in the operand tiles and
//    their scores set to -inf after the product.
// flash_fwd_simt_kernel, for Tq and Tk of at most one 64-row tile (the act
// step at T = 1, [32 or 128, 4, 1, 32]; the train step at T = 21,
// [32, 4, 21, 32]), on the CUDA cores; `_flash_kernel` at these lengths:
//  - Lanes hold real rows: eight lanes a query row (four dims each at
//    D = 32), and short rows share a CTA (four (b, h) of one warp at
//    Tq = 1); longer ones get a CTA a (b, h), 8 * Tq lanes.
//  - One round trip to memory: q and seg_q into registers and the K, V
//    rows and seg_k into shared memory by cp.async (as stored, no
//    conversion) all issued before one wait and one barrier; only keys
//    some row of the CTA may see are copied.
//  - Only keys that exist and are causally visible are scored, four at a
//    time (one branch a block of four, whose dot products and shuffles
//    overlap), into at most 64 scores in registers: the softmax takes one
//    pass over them (max, then p and P.V), with no online rescale.
//  - No tensor cores: a lane's whole product is at most 64 keys x 4 dims
//    each way at D = 32 (~0.1 us of serial FMAs at T = 21), where 3xTF32
//    mma.sync would need three products a tile and a split of every
//    operand for the same result; the launch and the memory round trip
//    are the cost.
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3, 700 W): at the
// context shape [4,4,2048,32] f32 the kernel must move q, k, v and o once,
// 16.8 MB, 5.0 us at 3.35 TB/s. The arithmetic is 4*D FLOPs per visible
// pair; with the repo's resets every 200 steps 4.1e8 FLOPs, 2.5 us as
// 3xTF32 at 495 TFLOP/s (6.1 us on the CUDA cores at 67), so the bound is
// bytes; with no reset in the window 4.3e9 FLOPs, 26 us as 3xTF32:
// operations. The wgmma kernel runs at several times either bound
// (PERF.md): per 64-key tile a CTA waits on the tensor cores (three
// products each way for f32) and spends as long again on the CUDA cores
// splitting K and V and taking the softmax, and at the model's short head
// dim (32) those phases are not yet overlapped across tiles; a CTA that
// sees few tiles is held by its fixed cost (segment scan, first load). The
// small-tile shapes move 0.26 MB (act, 0.08 us) and 1.4 MB (train,
// 0.4 us): their bound is bytes, but a launch that small is held by fixed
// latencies (the launch, one memory round trip, a barrier), which its
// design cuts to one of each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "operands.cuh"

namespace {

constexpr float kNegInf = -1e30f;      // the mask floor of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Small-tile design: at most one tile of queries and keys, CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kSimtMaxT = 64;          // Tq and Tk it is chosen for
constexpr int kRowLanes = 8;           // lanes per query row
constexpr int kKeyBlock = 4;           // keys scored between two branches
constexpr int kSimtMaxThreads = kRowLanes * kSimtMaxT;
// Dynamic shared memory a CTA may take: one (b, h) needs at most 64 K and
// V rows of 128 f32 (64 KB) and their segment ids.
constexpr int kSimtSmemCap = 96 * 1024;

// A CTA owns `per_cta` consecutive (b, h) and kRowLanes lanes for each of
// their query rows; lane g of a row owns the 4-element chunks 8c + g of a
// D-row (dims 32c + 4g .. + 3), so the 8 lanes of one row read a key row's
// 128 bytes in one conflict-free phase and complete each dot product with
// three shuffles. Every load is issued at once: the lane's chunks of its q
// row and its seg_q into registers, the CTA's K and V rows (only the keys
// some row may see) and seg_k into shared memory by cp.async in the input
// type; one wait and one barrier. Each row then scores only the keys that
// exist and are causally visible, takes a single-pass softmax over them
// (at most 64 scores in registers: no online rescale) and accumulates P.V.
template <int D, typename T>
__global__ void __launch_bounds__(kSimtMaxThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k, T* __restrict__ o,
                      float* __restrict__ lse, int bh_total, int heads,
                      int tq, int tk, int causal, int per_cta) {
  static_assert(D % (4 * kRowLanes) == 0, "D must be a multiple of 32");
  constexpr int kC = D / (4 * kRowLanes);    // chunks a lane owns
  constexpr int kUnits = D * sizeof(T) / 16;  // 16-byte units of a row
  extern __shared__ __align__(16) unsigned char simt_smem[];
  const int kn = causal ? min(tk, tq) : tk;  // keys some row may see
  T* k_s = reinterpret_cast<T*>(simt_smem);
  T* v_s = k_s + per_cta * kn * D;
  int* segk_s = reinterpret_cast<int*>(v_s + per_cta * kn * D);

  const int bh0 = blockIdx.x * per_cta;
  const int n_heads = min(per_cta, bh_total - bh0);
  const int tid = threadIdx.x;
  const int row_id = tid / kRowLanes;
  const int g = tid % kRowLanes;
  const int h = row_id / tq;
  const int i = row_id % tq;
  const bool row_ok = h < n_heads;
  const int hs = row_ok ? h : 0;  // lanes without a row read head 0
  const size_t bh = static_cast<size_t>(bh0 + hs);

  float qr[4 * kC] = {};
  int sq = 0;
  if (row_ok) {
    const T* qrow = q + (bh * tq + i) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float x[4];
      load4(qrow + 4 * (8 * c + g), x);
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[4 * c + e] = x[e];
    }
    sq = seg_q[(bh / heads) * tq + i];
  }
  const int head_units = kn * kUnits;
  for (int u = tid; u < n_heads * head_units; u += blockDim.x) {
    const int hh = u / head_units;
    const int off = 16 * (u % head_units);
    const size_t src = static_cast<size_t>(bh0 + hh) * tk * D;
    copy_unit(k_s + hh * kn * D, k + src, off);
    copy_unit(v_s + hh * kn * D, v + src, off);
  }
  for (int u = tid; u < n_heads * kn; u += blockDim.x) {
    const int b = (bh0 + u / kn) / heads;
    cp_async4(segk_s + u, seg_k + static_cast<size_t>(b) * tk + u % kn);
  }
  cp_async_wait_all();
  __syncthreads();

  // Keys this row scores, and the most any row of the warp does (the
  // loops run to the warp's bound, so the shuffles see every lane).
  const int j_row = row_ok ? (causal ? min(i + 1, tk) : tk) : 0;
  const int j_warp = __reduce_max_sync(0xffffffffu, j_row);
  const T* kh = k_s + hs * kn * D;
  const T* vh = v_s + hs * kn * D;
  const int* skh = segk_s + hs * kn;
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  // Keys go in blocks of kKeyBlock: one branch a block, and the block's
  // dot products and shuffles overlap. A key past the staged ones (in the
  // warp's last block) reads the last staged row and scores -inf.
  float s[kSimtMaxT];
  float m = -INFINITY;
#pragma unroll
  for (int j0 = 0; j0 < kSimtMaxT; j0 += kKeyBlock) {
    if (j0 >= j_warp) break;  // straight to the loop's end
#pragma unroll
    for (int j = j0; j < j0 + kKeyBlock; ++j) {
      const int jr = min(j, kn - 1);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float x[4];
        load4(kh + jr * D + 4 * (8 * c + g), x);
        part += qr[4 * c] * x[0] + qr[4 * c + 1] * x[1] +
                qr[4 * c + 2] * x[2] + qr[4 * c + 3] * x[3];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      // Past this row's keys: no key (-inf); masked: the floor.
      s[j] = j >= j_row ? -INFINITY
                        : (skh[jr] == sq ? part * scale : kNegInf);
      m = fmaxf(m, s[j]);
    }
  }
  // A row whose max is at the floor is fully masked: p = 0 everywhere.
  const float shift = m > kNegInf / 2 ? m : 0.f;
  float l = 0.f;
  float acc[4 * kC];
#pragma unroll
  for (int d = 0; d < 4 * kC; ++d) acc[d] = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < kSimtMaxT; j0 += kKeyBlock) {
    if (j0 >= j_warp) break;
#pragma unroll
    for (int j = j0; j < j0 + kKeyBlock; ++j) {
      const float p = exp2f((s[j] - shift) * kLog2e);
      l += p;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float x[4];
        load4(vh + min(j, kn - 1) * D + 4 * (8 * c + g), x);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * c + e] += p * x[e];
      }
    }
  }

  if (!row_ok) return;
  const float safe_l = l > 0.f ? l : 1.f;
  T* orow = o + (bh * tq + i) * D;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float x[4] = {acc[4 * c] / safe_l, acc[4 * c + 1] / safe_l,
                        acc[4 * c + 2] / safe_l, acc[4 * c + 3] / safe_l};
    store_out4(orow + 4 * (8 * c + g), x);
  }
  if (g == 0) lse[bh * tq + i] = l > 0.f ? shift + logf(safe_l) : INFINITY;
}

// ---------------------------------------------------------------------------
// wgmma variant
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;       // one warpgroup
constexpr int kBlockQ = 64;         // query rows per CTA (the wgmma M)
constexpr int kListCap = 128;       // key tiles scanned per pass of the list
constexpr int kStages = 2;          // staging slots in the load ring
constexpr int kScanLoads = 16;      // seg_k loads in flight per thread

template <int D, typename T>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);         // operand element bytes
  static constexpr int BK = (kF32 && D == 128) ? 32 : 64;  // keys per tile
  static constexpr int W = 128 / E;           // elements per swizzle row
  static constexpr int DC = D < W ? W : D;    // stored depth, Q and K
  static constexpr int KC = BK < W ? W : BK;  // stored depth of V^T tiles
  static constexpr int kParts = kF32 ? 2 : 1;  // hi (and lo) of Q, K, V
  // Q lives in registers as the A operand of Q.K^T (read once) where it
  // fits: 8 words a thread per 8 of D for f32 (hi and lo), 4 per 16 of D
  // for bf16; f32 at D = 128 keeps it in shared memory.
  static constexpr bool kQRegs = !kF32 || D <= 64;
  static_assert(kQRegs || BK == 32, "Q.K^T from shared memory is tf32, N 32");
  static constexpr int kQBytes = kBlockQ * DC * E;
  static constexpr int kKBytes = BK * DC * E;
  static constexpr int kVBytes = D * KC * E;
  static constexpr int kRowBytes = D * E;     // one K or V row in memory
  static constexpr int kStageBytes = 2 * BK * kRowBytes;  // K rows, V rows
  static constexpr int kOffQ = 0;
  static constexpr int kOffK = kOffQ + (kQRegs ? 0 : kParts * kQBytes);
  // V^T has two buffers: tile j+1 is split into one while the P.V product
  // of tile j still reads the other.
  static constexpr int kOffV = kOffK + kParts * kKBytes;
  static constexpr int kVBufBytes = kParts * kVBytes;
  static constexpr int kOffStage = kOffV + 2 * kVBufBytes;
  static constexpr int kOffBar = kOffStage + kStages * kStageBytes;
  static constexpr int kOffSegK = kOffBar + 8 * kStages;
  static constexpr int kOffList = kOffSegK + 4 * BK;
  static constexpr int kOffMin = kOffList + 4 * kListCap;
  static constexpr int kOffMax = kOffMin + 4 * kListCap;
  static constexpr int kOffMisc = kOffMax + 4 * kListCap;
  static constexpr int kBytes = kOffMisc + 16;
  // The dynamic shared memory request: the layout plus room to align its
  // base to 1024 bytes (the swizzle repeats every 1024).
  static constexpr int kSmem = kBytes + 1024;
  static constexpr int kStepsS = D * E / 32;   // k-steps of Q.K^T
  static constexpr int kStepsO = BK * E / 32;  // k-steps of P.V
  static_assert(kSmem <= 227 * 1024, "tile set exceeds shared memory");
};

// D (+)= A . B^T over STEPS tf32 k-steps, A (64 rows) and B (N rows)
// both from shared memory: Q.K^T for f32 at D = 128, Q kept there.
template <int N, int RB, int STEPS>
__device__ __forceinline__ void ss_steps(float (&d)[N / 2], uint32_t a,
                                         uint32_t b, int scale_first) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks) {
    wgmma::tf32<N>(d, step_desc<kBlockQ>(a, ks), step_desc<RB>(b, ks),
                   ks == 0 ? scale_first : 1);
  }
}

// List flag of a tile in which every pair is visible (no mask needed).
constexpr int kFullTile = 1 << 30;

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ seg_q,
                       const int* __restrict__ seg_k, T* __restrict__ o,
                       float* __restrict__ lse, int heads, int tq, int tk,
                       int causal) {
  using C = Cfg<D, T>;
  constexpr int BK = C::BK;
  constexpr int E = C::E;
  constexpr int NP = C::kF32 ? BK / 2 : BK / 4;  // P words per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_t = smem + C::kOffQ;
  unsigned char* k_t = smem + C::kOffK;
  unsigned char* stage = smem + C::kOffStage;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::kOffBar);
  int* segk_s = reinterpret_cast<int*>(smem + C::kOffSegK);
  int* list = reinterpret_cast<int*>(smem + C::kOffList);
  int* tile_min = reinterpret_cast<int*>(smem + C::kOffMin);
  int* tile_max = reinterpret_cast<int*>(smem + C::kOffMax);
  int* misc = reinterpret_cast<int*>(smem + C::kOffMisc);  // qlo, qhi, n

  const int bh = blockIdx.x;
  const int b = bh / heads;
  // The heaviest query tiles (most causal key tiles) are scheduled first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t q_rows = static_cast<size_t>(bh) * tq;
  const size_t kv_rows = static_cast<size_t>(bh) * tk;
  const int* segq_b = seg_q + static_cast<size_t>(b) * tq;
  const int* segk_b = seg_k + static_cast<size_t>(b) * tk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The query tile's segment interval, over its valid rows.
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = q0 + lane; r < min(q0 + kBlockQ, tq); r += 32) {
      const int sv = segq_b[r];
      lo = min(lo, sv);
      hi = max(hi, sv);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      misc[0] = lo;
      misc[1] = hi;
    }
  }
  // Q into its operand tile(s), rows past tq as zeros.
  for (int idx = tid; !C::kQRegs && idx < kBlockQ * D / 4; idx += kThreads) {
    const int r = 4 * idx / D;
    const int c = 4 * idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < tq) load4(q + (q_rows + q0 + r) * D + c, x);
    store4<T>(q_t + swz<E, kBlockQ>(r, c), C::kQBytes, x);
  }
  fence_async_smem();
  __syncthreads();
  const int qlo = misc[0], qhi = misc[1];

  // This thread's two rows of the 64 x N accumulators.
  const int r0 = 16 * warp + lane / 4;
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  int sq[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) sq[a] = row[a] < tq ? segq_b[row[a]] : 0;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
  float s[BK / 2];
  uint32_t ph[NP], pl[NP];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  // Q's A fragments (when in registers): per k-step, rows g and g+8 of the
  // warp's 16, columns t and t+4 (f32) or pairs 2t and 2t+8 (bf16).
  constexpr int kQWords = C::kQRegs ? 4 * C::kStepsS : 1;
  uint32_t qh[kQWords], ql[kQWords];
  if constexpr (C::kQRegs) {
    const int t = lane % 4;
#pragma unroll
    for (int ks = 0; ks < C::kStepsS; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e & 1];
        if constexpr (C::kF32) {
          const int c = 8 * ks + t + 4 * (e >> 1);
          const float x = r < tq ? q[(q_rows + r) * D + c] : 0.f;
          const float h = tf32_hi(x);
          qh[4 * ks + e] = __float_as_uint(h);
          ql[4 * ks + e] = __float_as_uint(x - h);
        } else {
          const int c = 16 * ks + 2 * t + 8 * (e >> 1);
          qh[4 * ks + e] = r < tq ? *reinterpret_cast<const uint32_t*>(
                                        q + (q_rows + r) * D + c)
                                  : 0u;
        }
      }
    }
  }

  // Causal: keys past the tile's last row are masked for every row here.
  const int k_end = causal ? min(tk, min(q0 + kBlockQ, tq)) : tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  // Load tile t's K and V rows into staging slot `slot` (thread 0 only).
  auto issue = [&](int t, int slot) {
    const int k0 = t * BK;
    const uint32_t bytes = min(BK, tk - k0) * C::kRowBytes;
    unsigned char* dst = stage + slot * C::kStageBytes;
    mbar_expect_tx(&bar[slot], 2 * bytes);
    bulk_load(dst, k + (kv_rows + k0) * D, bytes, &bar[slot]);
    bulk_load(dst + BK * C::kRowBytes, v + (kv_rows + k0) * D, bytes,
              &bar[slot]);
  };
  // This thread's key of list entry j's tile (its segment id, for masks).
  auto seg_of = [&](int j) {
    const int kk = (list[j] & (kFullTile - 1)) * BK + tid;
    return tid < BK && kk < tk ? segk_b[kk] : 0;
  };

  int it = 0;  // visible tiles consumed so far: slot it % 2, use it / 2
  for (int t0 = 0; t0 < n_tiles; t0 += kListCap) {
    const int nt = min(kListCap, n_tiles - t0);
    // [min, max] of seg_k over each key tile: a warp reads 32 consecutive
    // keys (all in one tile) kScanLoads times a warp-width apart, all
    // loads in flight at once, reduces each 32 in one instruction, and
    // lane 0 folds them into the tile's interval.
    for (int j = tid; j < nt; j += kThreads) {
      tile_min[j] = INT_MAX;
      tile_max[j] = INT_MIN;
    }
    __syncthreads();
    const int kb = t0 * BK;
    const int ke = min(tk, (t0 + nt) * BK);
    for (int base0 = kb + 32 * warp; base0 < ke;
         base0 += kThreads * kScanLoads) {
      int sv[kScanLoads];
#pragma unroll
      for (int u = 0; u < kScanLoads; ++u) {
        const int kk = base0 + u * kThreads + lane;
        sv[u] = kk < ke ? segk_b[kk] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanLoads; ++u) {
        const int base = base0 + u * kThreads;
        if (base >= ke) break;  // the same for the whole warp
        const bool ok = base + lane < ke;
        const int lo = __reduce_min_sync(0xffffffffu, ok ? sv[u] : INT_MAX);
        const int hi = __reduce_max_sync(0xffffffffu, ok ? sv[u] : INT_MIN);
        if (lane == 0) {
          atomicMin(&tile_min[(base - kb) / BK], lo);
          atomicMax(&tile_max[(base - kb) / BK], hi);
        }
      }
    }
    __syncthreads();
    // The ordered list of tiles whose interval meets the query tile's,
    // flagged kFullTile where every pair is visible (no mask needed).
    if (warp == 0) {
      int n = 0;
      for (int j0 = 0; j0 < nt; j0 += 32) {
        const int j = j0 + lane;
        int f = 0;
        if (j < nt) {
          const int lo = tile_min[j], hi = tile_max[j];
          const int k0 = (t0 + j) * BK;
          const bool meets = !(hi < qlo || lo > qhi);
          const bool full = lo == hi && qlo == qhi && lo == qlo &&
                            k0 + BK <= tk &&
                            (causal == 0 || k0 + BK - 1 <= q0);
          f = meets ? (full ? 2 : 1) : 0;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, f != 0);
        if (f) {
          list[n + __popc(ballot & ((1u << lane) - 1u))] =
              (t0 + j) | (f == 2 ? kFullTile : 0);
        }
        n += __popc(ballot);
      }
      if (lane == 0) misc[2] = n;
    }
    __syncthreads();
    const int n_list = misc[2];
    if (tid == 0) {
      for (int j = 0; j < min(kStages, n_list); ++j) {
        issue(list[j] & (kFullTile - 1), (it + j) % kStages);
      }
    }
    int seg_next = n_list > 0 ? seg_of(0) : 0;

    for (int j = 0; j < n_list; ++j, ++it) {
      const int slot = it % kStages;
      const int entry = list[j];
      const bool full = entry & kFullTile;
      const int k0 = (entry & (kFullTile - 1)) * BK;
      const int n_valid = min(BK, tk - k0);
      unsigned char* v_t = smem + C::kOffV + (it & 1) * C::kVBufBytes;
      mbar_wait(&bar[slot], (it / kStages) & 1);
      // Split (f32) the staged rows into the operand tiles, K as it is
      // and V transposed; keys past tk become zeros. The P.V product of
      // the previous tile may still run: it reads the other V^T buffer.
      const T* st_k =
          reinterpret_cast<const T*>(stage + slot * C::kStageBytes);
      const T* st_v = st_k + BK * D;
      for (int idx = tid; idx < BK * D / 4; idx += kThreads) {
        const int r = 4 * idx / D;
        const int c = 4 * idx % D;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < n_valid) load4(st_k + r * D + c, x);
        store4<T>(k_t + swz<E, BK>(r, c), C::kKBytes, x);
      }
      // V^T: one 16-byte unit of one dimension per item, the lanes of a
      // warp on consecutive dimensions. f32: unit (8g + 4h .. +3) holds
      // keys 8g + h + 2e, e < 4 (the order P's registers take, see
      // rs_steps); bf16: keys in order, 8 a unit.
      for (int idx = tid; idx < BK * D * E / 16; idx += kThreads) {
        const int d = idx % D;
        const int unit = idx / D;
        if constexpr (C::kF32) {
          const int k_first = 8 * (unit / 2) + (unit & 1);
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = k_first + 2 * e;
            x[e] = kr < n_valid ? st_v[kr * D + d] : 0.f;
          }
          store4<T>(v_t + swz<E, D>(d, 4 * unit), C::kVBytes, x);
        } else {
          const int k_first = 8 * unit;
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = k_first + 2 * e;
            const float a = kr < n_valid ? to_f32(st_v[kr * D + d]) : 0.f;
            const float c =
                kr + 1 < n_valid ? to_f32(st_v[(kr + 1) * D + d]) : 0.f;
            w[e] = pack_bf16(a, c);
          }
          *reinterpret_cast<uint4*>(v_t + swz<E, D>(d, k_first)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      if (tid < BK) segk_s[tid] = seg_next;
      fence_async_smem();
      __syncthreads();  // operand tiles complete; the staging slot is free
      if (tid == 0 && j + kStages < n_list) {
        fence_async_smem();
        issue(list[j + kStages] & (kFullTile - 1), slot);
      }
      if (j + 1 < n_list) seg_next = seg_of(j + 1);

      // S = Q . K^T on the tensor cores; the wait also retires the
      // previous tile's P.V.
      const uint32_t ka = smem_addr(k_t);
      wgmma::fence();
      if constexpr (C::kQRegs && C::kF32) {
        rs_steps<BK, BK, C::kStepsS, true, false>(s, qh, ka, 0);
        rs_steps<BK, BK, C::kStepsS, true, false>(s, qh, ka + C::kKBytes,
                                                  1);
        rs_steps<BK, BK, C::kStepsS, true, false>(s, ql, ka, 1);
      } else if constexpr (C::kQRegs) {
        rs_steps<BK, BK, C::kStepsS, false, false>(s, qh, ka, 0);
      } else {
        const uint32_t qa = smem_addr(q_t);
        ss_steps<BK, BK, C::kStepsS>(s, qa, ka, 0);
        ss_steps<BK, BK, C::kStepsS>(s, qa, ka + C::kKBytes, 1);
        ss_steps<BK, BK, C::kStepsS>(s, qa + C::kQBytes, ka, 1);
      }
      wgmma::commit();
      wgmma::wait_all();

      // Masks (unless every pair of the tile is visible), then the online
      // softmax over this tile.
      float tmax[2] = {-INFINITY, -INFINITY};
      if (full) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] *= scale;
          tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int a = (i >> 1) & 1;
          const int c = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int kpos = k0 + c;
          const bool visible =
              segk_s[c] == sq[a] && (causal == 0 || row[a] >= kpos);
          s[i] = kpos >= tk ? -INFINITY : (visible ? s[i] * scale : kNegInf);
          tmax[a] = fmaxf(tmax[a], s[i]);
        }
      }
      float shift[2], scale_old[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        tmax[a] = fmaxf(tmax[a], __shfl_xor_sync(0xffffffffu, tmax[a], 1));
        tmax[a] = fmaxf(tmax[a], __shfl_xor_sync(0xffffffffu, tmax[a], 2));
        const float m_new = fmaxf(m[a], tmax[a]);
        shift[a] = m_new > kNegInf / 2 ? m_new : 0.f;
        scale_old[a] =
            m[a] > kNegInf / 2 ? exp2f((m[a] - shift[a]) * kLog2e) : 0.f;
        m[a] = m_new;
        l[a] *= scale_old[a];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= scale_old[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int a = (i >> 1) & 1;
        const float p0 = exp2f((s[i] - shift[a]) * kLog2e);
        const float p1 = exp2f((s[i + 1] - shift[a]) * kLog2e);
        l[a] += p0 + p1;
        if constexpr (C::kF32) {
          const float h0 = tf32_hi(p0), h1 = tf32_hi(p1);
          ph[i] = __float_as_uint(h0);
          ph[i + 1] = __float_as_uint(h1);
          pl[i] = __float_as_uint(p0 - h0);
          pl[i + 1] = __float_as_uint(p1 - h1);
        } else {
          const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
          ph[i / 2] = *reinterpret_cast<const uint32_t*>(&h);
          pl[i / 2] = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
        }
      }

      // acc += P . V on the tensor cores, left running into the next
      // tile's split.
      const uint32_t va = smem_addr(v_t);
      wgmma::fence();
      rs_steps<D, D, C::kStepsO, C::kF32, true>(acc, ph, va, 1);
      rs_steps<D, D, C::kStepsO, C::kF32, true>(acc, pl, va, 1);
      if constexpr (C::kF32) {
        rs_steps<D, D, C::kStepsO, true, true>(acc, ph, va + C::kVBytes, 1);
      }
      wgmma::commit();
      __syncthreads();  // every warp is past its reads of K and segk_s
    }
  }
  wgmma::wait_all();

  // Each row's sum lives in the four lanes of a quad.
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (row[a] >= tq) continue;
    const float safe_l = l[a] > 0.f ? l[a] : 1.f;
    T* dst = o + (q_rows + row[a]) * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      store2(&dst[c], acc[i + 2 * a] / safe_l, acc[i + 2 * a + 1] / safe_l);
    }
    if (lane % 4 == 0) {
      const float sh = m[a] > kNegInf / 2 ? m[a] : 0.f;
      lse[q_rows + row[a]] = l[a] > 0.f ? sh + logf(safe_l) : INFINITY;
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, void* o, float* lse,
                   int bh, int heads, int tq, int tk, int causal,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (tq <= kSimtMaxT && tk <= kSimtMaxT) {
    if (bh == 0 || tq == 0) return cudaSuccess;  // no row to compute
    static const cudaError_t configured = cudaFuncSetAttribute(
        flash_fwd_simt_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSimtSmemCap);
    if (configured != cudaSuccess) return configured;
    // Short rows share a CTA: up to a warp's rows (four (b, h) at Tq = 1),
    // as shared memory allows; longer ones get a CTA a (b, h).
    const int kn = causal ? min(tk, tq) : tk;
    const int head_bytes = kn * (2 * D * static_cast<int>(sizeof(T)) + 4);
    int per_cta = tq <= 4 ? 4 / tq : 1;
    if (head_bytes > 0) {
      per_cta = max(1, min(per_cta, kSimtSmemCap / head_bytes));
    }
    const int threads = (per_cta * tq * kRowLanes + 31) / 32 * 32;
    const int grid = (bh + per_cta - 1) / per_cta;
    flash_fwd_simt_kernel<D, T><<<grid, threads, per_cta * head_bytes,
                                  stream>>>(qt, kt, vt, seg_q, seg_k, ot,
                                            lse, bh, heads, tq, tk, causal,
                                            per_cta);
    return cudaGetLastError();
  }
  // Above 48 KB a block's shared memory must be asked for (once).
  static const cudaError_t configured = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D, T>::kSmem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_wgmma_kernel<D, T><<<grid, kThreads, Cfg<D, T>::kSmem, stream>>>(
      qt, kt, vt, seg_q, seg_k, ot, lse, heads, tq, tk, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const int* seg_q, const int* seg_k, void* o,
                       float* lse, int bh, int heads, int tq, int tk,
                       int causal, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, seg_q, seg_k, o, lse, bh, heads, tq, tk,
                           causal, stream);
    case 64:
      return launch<64, T>(q, k, v, seg_q, seg_k, o, lse, bh, heads, tq, tk,
                           causal, stream);
    case 128:
      return launch<128, T>(q, k, v, seg_q, seg_k, o, lse, bh, heads, tq,
                            tk, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [bh, tq, d], k/v [bh, tk, d] contiguous and 16-byte aligned, f32
// (dtype 0) or bf16 (dtype 1); seg_q [bh/heads, tq], seg_k [bh/heads, tk]
// int32; o like q; lse [bh, tq] f32. Launches on `stream` and returns
// cudaGetLastError().
int flash_fwd(const void* q, const void* k, const void* v, const int* seg_q,
              const int* seg_k, void* o, float* lse, int bh, int heads,
              int tq, int tk, int d, int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, seg_q, seg_k, o, lse, bh, heads,
                             tq, tk, causal, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, seg_q, seg_k, o, lse, bh,
                                     heads, tq, tk, causal, s);
  }
  return cudaErrorInvalidValue;
}

// 1 if flash_fwd runs the wgmma design at these lengths, 0 for the SIMT one.
int flash_fwd_uses_wgmma(int tq, int tk) {
  return tq <= kSimtMaxT && tk <= kSimtMaxT ? 0 : 1;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
