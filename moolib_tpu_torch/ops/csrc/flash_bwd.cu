// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, causal and
// segment-masked.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkdv_kernel` in moolib_tpu/ops/attention.py (launched by
// `_flash_backward`). They compute what those kernels compute, not their
// block loops. With scale = 1/sqrt(D), all in f32:
//
//   s[i,j]  = (q[i] * scale) . k[j]
//   p[i,j]  = exp(s[i,j] - lse[i])  where j is visible to i and lse[i] is
//             finite, else 0 (masked: causal j > i or seg_q[i] != seg_k[j];
//             a fully masked row has lse = +inf and contributes exactly 0)
//   dp[i,j] = dO[i] . v[j]
//   ds[i,j] = p[i,j] * (dp[i,j] - delta[i]),  delta[i] = dO[i] . o[i]
//   dQ[i]   = sum_j ds[i,j] k[j] * scale                  (dq kernel)
//   dV[j]   = sum_i p[i,j] dO[i]                          (dkdv kernel)
//   dK[j]   = sum_i ds[i,j] (q[i] * scale)                (dkdv kernel)
//
// P is rebuilt from the forward's saved lse, not from a second softmax;
// delta comes from the caller (the reference computes it outside its
// kernels too). Inputs are f32 or bf16, widened to f32 on load; the
// gradients are written in the input type.
//
// What bounds them on the H100: each visible (query, key) pair costs 6*D
// FLOPs in the dq kernel (s, dp, dQ) and 8*D in the dkdv kernel (s, dp, dV,
// dK), against a few D-wide rows of bytes per query or key, so at the
// model's sequence lengths (T = 2048) the work is arithmetic. This first
// version does it in f32 on the CUDA cores (67 TFLOP/s peak), as the
// forward does. What the design does about it: each CTA keeps its own rows
// (and their running gradient sums) in registers for the whole loop and
// streams the other side's rows through shared memory, so every streamed
// tile is read from device memory once per CTA and reused by all of its
// rows; tiles that lie entirely on the masked side of the causal diagonal
// are never loaded. wgmma with bf16 operands is later work.
//
// Split: the Pallas kernels carry their sums across a sequential grid axis
// in VMEM scratch. Here the dq kernel owns a tile of query rows and loops
// over key tiles inside the CTA; the dkdv kernel owns a tile of key rows
// and loops over query tiles. Every output row has one owner, so there
// are no atomics and the sums run in a fixed order: two runs give the same
// bits.
//
// Layout: kLanes adjacent lanes share one row (2 for D <= 64, 4 for
// D = 128). Lane `part` of the group owns the dimensions
// 4*(kLanes*c + part) + e, c < D/(4*kLanes), e < 4 (interleaved float4
// chunks, so a group's reads of one shared row fall in different banks),
// and the group completes each dot product with log2(kLanes) shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;       // rows a CTA owns (query rows or key rows)
constexpr int kTile = 32;       // rows of the other side per shared tile

template <int D>
struct Layout {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  static constexpr int kLanes = D >= 128 ? 4 : 2;   // lanes per row
  static constexpr int kOwn = D / kLanes;           // dims per lane
  static constexpr int kChunks = kOwn / 4;          // float4 chunks per lane
  static constexpr int kThreads = kRows * kLanes;
  __device__ static int dim(int c, int part, int e) {
    return 4 * (kLanes * c + part) + e;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Sum over the kLanes lanes of one row group; every lane of the group gets
// the same bits (the pairwise sums are commutative).
template <int kLanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// One lane's share of a.b, a in registers, b a row in shared memory.
template <int D>
__device__ __forceinline__ float partial_dot(const float* a, const float* b,
                                             int part) {
  using L = Layout<D>;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const float4 bb =
        *reinterpret_cast<const float4*>(&b[L::dim(c, part, 0)]);
    acc += a[4 * c] * bb.x + a[4 * c + 1] * bb.y + a[4 * c + 2] * bb.z +
           a[4 * c + 3] * bb.w;
  }
  return acc;
}

// acc += w * b over one lane's dims, b a row in shared memory.
template <int D>
__device__ __forceinline__ void axpy(float* acc, float w, const float* b,
                                     int part) {
  using L = Layout<D>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const float4 bb =
        *reinterpret_cast<const float4*>(&b[L::dim(c, part, 0)]);
    acc[4 * c] += w * bb.x;
    acc[4 * c + 1] += w * bb.y;
    acc[4 * c + 2] += w * bb.z;
    acc[4 * c + 3] += w * bb.w;
  }
}

// Load one lane's dims of a global row into registers, times `mul`.
template <int D, typename T>
__device__ __forceinline__ void load_own(float* dst, const T* row, bool ok,
                                         int part, float mul) {
  using L = Layout<D>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[4 * c + e] = ok ? to_f32(row[L::dim(c, part, e)]) * mul : 0.f;
    }
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_own(T* row, const float* src, int part,
                                          float mul) {
  using L = Layout<D>;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store(&row[L::dim(c, part, e)], src[4 * c + e] * mul);
    }
  }
}

// Copy rows [r0, r0 + kTile) of a [n, D] matrix into shared memory as f32,
// times `mul`; rows past n are zeros.
template <int D, typename T, int kThreads>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* src,
                                          int r0, int n, float mul) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r][c] = r0 + r < n
                    ? to_f32(src[static_cast<size_t>(r0 + r) * D + c]) * mul
                    : 0.f;
  }
}

__device__ __forceinline__ float inv_sqrt_dim(int d) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
}

// dQ: one CTA per (batch*head, kRows query rows); loops over key tiles.
template <int D, typename T>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    int heads, int tq, int tk, int causal) {
  using L = Layout<D>;
  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];
  __shared__ int segk_s[kTile];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int q0 = blockIdx.y * kRows;
  const int row = q0 + threadIdx.x / L::kLanes;
  const int part = threadIdx.x % L::kLanes;
  const bool row_ok = row < tq;
  const float scale = inv_sqrt_dim(D);

  const size_t row_off = (static_cast<size_t>(bh) * tq + (row_ok ? row : 0)) * D;
  float qr[L::kOwn], dor[L::kOwn], acc[L::kOwn];
  load_own<D>(qr, q + row_off, row_ok, part, scale);
  load_own<D>(dor, dout + row_off, row_ok, part, 1.f);
#pragma unroll
  for (int d = 0; d < L::kOwn; ++d) acc[d] = 0.f;
  const size_t stat = static_cast<size_t>(bh) * tq + row;
  const float lse_r = row_ok ? lse[stat] : INFINITY;
  const float delta_r = row_ok ? delta[stat] : 0.f;
  const int sq = row_ok ? seg_q[static_cast<size_t>(b) * tq + row] : 0;
  // A fully masked row (lse = +inf) and a padding row contribute nothing.
  const bool live = isfinite(lse_r);

  // Causal: keys past the tile's last row are masked for every row here.
  const int k_end = causal ? min(tk, min(q0 + kRows, tq)) : tk;
  const T* k_bh = k + static_cast<size_t>(bh) * tk * D;
  const T* v_bh = v + static_cast<size_t>(bh) * tk * D;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D, T, L::kThreads>(k_s, k_bh, k0, tk, 1.f);
    load_tile<D, T, L::kThreads>(v_s, v_bh, k0, tk, 1.f);
    if (threadIdx.x < kTile) {
      const int kr = k0 + threadIdx.x;
      segk_s[threadIdx.x] =
          kr < tk ? seg_k[static_cast<size_t>(b) * tk + kr] : 0;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float s = group_sum<L::kLanes>(partial_dot<D>(qr, k_s[j], part));
      const float dp =
          group_sum<L::kLanes>(partial_dot<D>(dor, v_s[j], part));
      const int kpos = k0 + j;
      const bool visible = live && kpos < tk && segk_s[j] == sq &&
                           (causal == 0 || row >= kpos);
      const float p = visible ? expf(s - lse_r) : 0.f;
      axpy<D>(acc, p * (dp - delta_r), k_s[j], part);
    }
  }

  if (row_ok) store_own<D>(dq + row_off, acc, part, scale);
}

// dK/dV: one CTA per (batch*head, kRows key rows); loops over query tiles.
template <int D, typename T>
__global__ void __launch_bounds__(Layout<D>::kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const T* __restrict__ dout, T* __restrict__ dk,
                      T* __restrict__ dv, int heads, int tq, int tk,
                      int causal) {
  using L = Layout<D>;
  __shared__ __align__(16) float q_s[kTile][D];
  __shared__ __align__(16) float do_s[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  __shared__ int segq_s[kTile];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int k0 = blockIdx.y * kRows;
  const int krow = k0 + threadIdx.x / L::kLanes;
  const int part = threadIdx.x % L::kLanes;
  const bool krow_ok = krow < tk;
  const float scale = inv_sqrt_dim(D);

  const size_t row_off = (static_cast<size_t>(bh) * tk + (krow_ok ? krow : 0)) * D;
  float kr[L::kOwn], vr[L::kOwn], dk_acc[L::kOwn], dv_acc[L::kOwn];
  load_own<D>(kr, k + row_off, krow_ok, part, 1.f);
  load_own<D>(vr, v + row_off, krow_ok, part, 1.f);
#pragma unroll
  for (int d = 0; d < L::kOwn; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  const int sk = krow_ok ? seg_k[static_cast<size_t>(b) * tk + krow] : 0;

  // Causal: query tiles that end before this key tile see none of it.
  // k0 is a multiple of kTile, so the first tile to visit starts at k0.
  const int q_start = causal ? k0 : 0;
  const T* q_bh = q + static_cast<size_t>(bh) * tq * D;
  const T* do_bh = dout + static_cast<size_t>(bh) * tq * D;
  const size_t stat_bh = static_cast<size_t>(bh) * tq;

  for (int i0 = q_start; i0 < tq; i0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D, T, L::kThreads>(q_s, q_bh, i0, tq, scale);
    load_tile<D, T, L::kThreads>(do_s, do_bh, i0, tq, 1.f);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      const bool ok = i < tq;
      // A padding row gets lse = +inf: it contributes nothing.
      lse_s[threadIdx.x] = ok ? lse[stat_bh + i] : INFINITY;
      delta_s[threadIdx.x] = ok ? delta[stat_bh + i] : 0.f;
      segq_s[threadIdx.x] = ok ? seg_q[static_cast<size_t>(b) * tq + i] : 0;
    }
    __syncthreads();

#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      const float s = group_sum<L::kLanes>(partial_dot<D>(kr, q_s[ii], part));
      const float dp =
          group_sum<L::kLanes>(partial_dot<D>(vr, do_s[ii], part));
      const int qpos = i0 + ii;
      const float l = lse_s[ii];
      const bool visible = krow_ok && isfinite(l) && segq_s[ii] == sk &&
                           (causal == 0 || qpos >= krow);
      const float p = visible ? expf(s - l) : 0.f;
      axpy<D>(dv_acc, p, do_s[ii], part);
      axpy<D>(dk_acc, p * (dp - delta_s[ii]), q_s[ii], part);
    }
  }

  if (krow_ok) {
    store_own<D>(dk + row_off, dk_acc, part, 1.f);
    store_own<D>(dv + row_off, dv_acc, part, 1.f);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg_q;
  const int* seg_k;
  const float* lse;
  const float* delta;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int bh, heads, tq, tk, causal;
  cudaStream_t stream;
};

template <int D, typename T>
cudaError_t launch_dq(const Args& a) {
  const dim3 grid(a.bh, (a.tq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<D, T><<<grid, Layout<D>::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.seg_k, a.lse, a.delta,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.heads, a.tq,
      a.tk, a.causal);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkdv(const Args& a) {
  const dim3 grid(a.bh, (a.tk + kRows - 1) / kRows);
  flash_bwd_dkdv_kernel<D, T><<<grid, Layout<D>::kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg_q, a.seg_k, a.lse, a.delta,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.heads, a.tq, a.tk, a.causal);
  return cudaGetLastError();
}

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

template <int D, typename T>
struct DQ {
  static cudaError_t run(const Args& a) { return launch_dq<D, T>(a); }
};

template <int D, typename T>
struct DKDV {
  static cudaError_t run(const Args& a) { return launch_dkdv<D, T>(a); }
};

}  // namespace

extern "C" {

// q/dout [bh, tq, d], k/v [bh, tk, d] contiguous, f32 (dtype 0) or bf16
// (dtype 1); seg_q [bh/heads, tq], seg_k [bh/heads, tk] int32; lse and
// delta [bh, tq] f32; dq like q. Launches on `stream` and returns
// cudaGetLastError().
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const int* seg_q, const int* seg_k, const float* lse,
                 const float* delta, const void* dout, void* dq, int bh,
                 int heads, int tq, int tk, int d, int causal, int dtype,
                 void* stream) {
  const Args a{q, k, v, seg_q, seg_k, lse, delta, dout, dq, nullptr, nullptr,
               bh, heads, tq, tk, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<DQ>(d, dtype, a);
}

// As flash_bwd_dq; dk and dv like k.
int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, const float* lse,
                   const float* delta, const void* dout, void* dk, void* dv,
                   int bh, int heads, int tq, int tk, int d, int causal,
                   int dtype, void* stream) {
  const Args a{q, k, v, seg_q, seg_k, lse, delta, dout, nullptr, dk, dv,
               bh, heads, tq, tk, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<DKDV>(d, dtype, a);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
