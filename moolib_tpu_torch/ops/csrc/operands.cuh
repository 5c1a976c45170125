// Shared-memory operand tiles and the pieces around them that the flash
// kernels (flash_fwd.cu, flash_bwd.cu) share on Hopper (sm_90a): element
// conversions, the 128-byte swizzled K-major tile layout and its wgmma
// descriptors, mbarriers and bulk copies on the TMA engine, cp.async
// copies, the 3xTF32 split, and wgmma products whose A operand comes from
// registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An operand tile of R rows whose K dimension is cut into 128-byte column
// chunks; chunk c holds R rows of 128 bytes (row r at byte 128*r), with the
// 16-byte units of each row permuted by the 128-byte swizzle (unit u of row
// r sits at unit u ^ (r % 8)), the layout wgmma reads with a B128
// descriptor. Byte offset of element (r, c) for elements of E bytes:
template <int E, int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kW = 128 / E;  // elements per 128-byte row
  const int byte = (c % kW) * E;
  return (c / kW) * (R * 128) + r * 128 +
         ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
}

// wgmma matrix descriptor of a K-major, 128-byte-swizzled tile at shared
// address `addr` (chunk bases 1024-byte aligned): start address >> 4, SBO
// 1024 bytes between 8-row groups, layout B128 (LBO unused).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Descriptor of k-step `ks` (32 bytes of depth) of a tile with R rows.
template <int R>
__device__ __forceinline__ uint64_t step_desc(uint32_t tile, int ks) {
  return make_desc(tile + (ks * 32 / 128) * (R * 128) + (ks * 32) % 128);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A copy that never lands traps (a launch error) instead of hanging the
// card: each try_wait already suspends for a while, so 2^24 of them is
// seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory on the TMA engine; completion is
// counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Asynchronous copies of 16 (bypassing L1) or 4 bytes from device memory
// into shared memory; every copy a thread issued has landed after its
// cp_async_wait_all (a barrier then makes them visible to the CTA).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
// The 16 bytes at byte `off` of a row, `src` in device memory to `dst` in
// shared memory.
template <typename T>
__device__ __forceinline__ void copy_unit(T* dst, const T* src, int off) {
  cp_async16(reinterpret_cast<unsigned char*>(dst) + off,
             reinterpret_cast<const unsigned char*>(src) + off);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// f32 -> (hi, lo): hi is x with its low 13 mantissa bits cleared, a tf32
// value the tensor core reads exactly; lo = x - hi is exact in f32.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// Four consecutive elements of a row, as f32 (16- or 8-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  x[0] = __low2float(a); x[1] = __high2float(a);
  x[2] = __low2float(b); x[3] = __high2float(b);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two consecutive outputs (8- or 4-byte aligned) in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Four consecutive outputs (16- or 8-byte aligned) in one store.
__device__ __forceinline__ void store_out4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* p,
                                           const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
}

// Four consecutive operand elements at `dst` (within one 16-byte unit):
// f32 as tf32 hi there and lo `lo_off` bytes further; bf16 as they are.
template <typename T>
__device__ __forceinline__ void store4(unsigned char* dst, int lo_off,
                                      const float (&x)[4]) {
  if constexpr (std::is_same<T, float>::value) {
    float4 hi, lo;
    hi.x = tf32_hi(x[0]); hi.y = tf32_hi(x[1]);
    hi.z = tf32_hi(x[2]); hi.w = tf32_hi(x[3]);
    lo.x = x[0] - hi.x; lo.y = x[1] - hi.y;
    lo.z = x[2] - hi.z; lo.w = x[3] - hi.w;
    *reinterpret_cast<float4*>(dst) = hi;
    *reinterpret_cast<float4*>(dst + lo_off) = lo;
  } else {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
}

// D (+)= A . B^T over STEPS k-steps, A from registers in the A-fragment
// layout of mma.sync (four 32-bit words a k-step: f32 one tf32 value a
// word, bf16 a pair), B K-major from shared memory. kSwap: the f32 words
// come in the S accumulator's order, whose k-step ks maps to A's words
// {4ks, 4ks+2, 4ks+1, 4ks+3}; that is P in P.V (and P or dS in the
// backward's products), whose B tile is stored with its K index permuted
// to match (see the V^T split in flash_fwd.cu). bf16 P is in A's order as
// it is.
template <int N, int RB, int STEPS, bool F32, bool kSwap, int NW>
__device__ __forceinline__ void rs_steps(float (&d)[N / 2],
                                         const uint32_t (&a)[NW],
                                         uint32_t b, int scale_first) {
#pragma unroll
  for (int ks = 0; ks < STEPS; ++ks) {
    const int sc = ks == 0 ? scale_first : 1;
    if constexpr (F32) {
      const uint32_t w[4] = {a[4 * ks], a[4 * ks + (kSwap ? 2 : 1)],
                             a[4 * ks + (kSwap ? 1 : 2)], a[4 * ks + 3]};
      wgmma::tf32_rs<N>(d, w, step_desc<RB>(b, ks), sc);
    } else {
      const uint32_t w[4] = {a[4 * ks], a[4 * ks + 1], a[4 * ks + 2],
                             a[4 * ks + 3]};
      wgmma::bf16_rs<N>(d, w, step_desc<RB>(b, ks), sc);
    }
  }
}

}  // namespace
