// Flash-attention forward for Hopper (sm_90a), causal and segment-masked.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// moolib_tpu/ops/attention.py (launched by `_flash_forward`). It computes
// what that kernel computes, not its block loop:
//
//   s[i,j]  = (q[i] / sqrt(D)) . k[j]               in f32
//   s[i,j]  = -1e30 where j is masked for i          (the mask floor)
//   masked: causal (j > i) or seg_q[i] != seg_k[j]
//   o[i]    = sum_j exp(s[i,j] - m[i]) v[j] / l[i],  online over key tiles
//   lse[i]  = m[i] + log(l[i])
//
// A row whose running max is still <= -1e30/2 is fully masked: its
// probabilities are 0, its output is zeros and its lse is +inf. Inputs are
// f32 or bf16 and are widened to f32 on their way into shared memory; the
// softmax state and the products run in f32, as in the TPU kernel. `o` is
// written in the input type, `lse` in f32.
//
// What bounds it on the H100: the causal product costs 4*D FLOPs for each
// visible (query, key) pair, against 4*D*2 bytes of q/k/v/o per row, so at
// the model's sequence lengths (T = 2048) the work is arithmetic, not
// memory traffic. This first version does that arithmetic in f32 on the
// CUDA cores (67 TFLOP/s peak), far from the tensor cores. What the design
// does about it: every key/value tile is read from device memory once per
// 64-query tile and reused by all 64 rows from shared memory; the running
// max, sum and accumulator stay in registers for the whole key loop; key
// tiles that lie entirely above the causal diagonal are never loaded.
// Moving the two products onto wgmma with bf16 operands is later work.
//
// Layout: one CTA per (batch*head, tile of 64 query rows), 128 threads.
// Each query row belongs to a pair of adjacent lanes; each lane of the
// pair owns half of the D dimensions (in interleaved 4-float chunks so the
// pair's float4 reads of a shared key row fall in different banks), holds
// that half of the scaled query row and of the accumulator in registers,
// and the pair completes each dot product with one warp shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;            // query rows per CTA
constexpr int kBlockK = 32;            // keys per shared-memory tile
constexpr int kThreads = 2 * kBlockQ;  // two lanes per query row
constexpr float kNegInf = -1e30f;      // the mask floor of the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_k, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int tq, int tk,
                 int causal) {
  static_assert(D % 8 == 0, "D must be a multiple of 8");
  constexpr int kHalf = D / 2;     // dimensions owned by one lane
  constexpr int kChunks = D / 8;   // float4 chunks owned by one lane

  __shared__ __align__(16) float k_s[kBlockK][D];
  __shared__ __align__(16) float v_s[kBlockK][D];
  __shared__ int segk_s[kBlockK];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid / 2;
  const int half = tid & 1;
  const bool row_ok = row < tq;

  // Lane `half` owns dims 8*c + 4*half + e, c < kChunks, e < 4.
  float qr[kHalf];
  float acc[kHalf];
  const float sqrt_d = sqrtf(static_cast<float>(D));
  const size_t q_base = (static_cast<size_t>(bh) * tq + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * c + 4 * half + e;
      qr[4 * c + e] = row_ok ? to_f32(q[q_base + d]) / sqrt_d : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  const int sq = row_ok ? seg_q[static_cast<size_t>(b) * tq + row] : 0;
  float m = -INFINITY;
  float l = 0.f;

  // Causal: keys past the tile's last row are masked for every row here.
  const int k_end = causal ? min(tk, min(q0 + kBlockQ, tq)) : tk;
  const size_t kv_base = static_cast<size_t>(bh) * tk * D;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D;
      const int c = idx % D;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < tk) {
        const size_t g = kv_base + static_cast<size_t>(kr) * D + c;
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    if (tid < kBlockK) {
      const int kr = k0 + tid;
      segk_s[tid] = kr < tk ? seg_k[static_cast<size_t>(b) * tk + kr] : 0;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&k_s[j][8 * c + 4 * half]);
        part += qr[4 * c] * kk.x + qr[4 * c + 1] * kk.y +
                qr[4 * c + 2] * kk.z + qr[4 * c + 3] * kk.w;
      }
      float sj = part + __shfl_xor_sync(0xffffffffu, part, 1);
      const int kpos = k0 + j;
      const bool visible =
          segk_s[j] == sq && (causal == 0 || row >= kpos);
      // Keys past tk do not exist (they only pad the last tile); masked
      // keys sit at the floor, as in the TPU kernel.
      sj = kpos >= tk ? -INFINITY : (visible ? sj : kNegInf);
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }

    const float m_new = fmaxf(m, tile_max);
    const float shift = m_new > kNegInf / 2 ? m_new : 0.f;
    const float scale_old = m > kNegInf / 2 ? expf(m - shift) : 0.f;
    m = m_new;
    l *= scale_old;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) acc[d] *= scale_old;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - shift);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_s[j][8 * c + 4 * half]);
        acc[4 * c] += p * vv.x;
        acc[4 * c + 1] += p * vv.y;
        acc[4 * c + 2] += p * vv.z;
        acc[4 * c + 3] += p * vv.w;
      }
    }
  }

  if (!row_ok) return;
  const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store(&o[q_base + 8 * c + 4 * half + e], acc[4 * c + e] / safe_l);
    }
  }
  if (half == 0) {
    const float shift = m > kNegInf / 2 ? m : 0.f;
    lse[static_cast<size_t>(bh) * tq + row] =
        l > 0.f ? shift + logf(safe_l) : INFINITY;
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_k, void* o, float* lse,
                   int bh, int heads, int tq, int tk, int causal,
                   cudaStream_t stream) {
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg_q, seg_k, static_cast<T*>(o), lse,
      heads, tq, tk, causal);
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

// q [bh, tq, d], k/v [bh, tk, d] contiguous, f32 (dtype 0) or bf16
// (dtype 1); seg_q [bh/heads, tq], seg_k [bh/heads, tk] int32; o like q;
// lse [bh, tq] f32. Launches on `stream` and returns cudaGetLastError().
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

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
