// 3x3 stride-2 max-pool with flax's "SAME" padding, forward and backward,
// over channels-last tensors, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package pools with flax's `nn.max_pool`
// (moolib_tpu/models/impala.py:81), an XLA op and not a Pallas kernel.
// On the card the library pool could not take this shape as it is: flax's
// "SAME" pads asymmetrically ((0, 1) at even sizes, (1, 1) at odd), which
// `max_pool2d`'s `padding=` cannot say, so every pool went through a
// padded copy of its input, and the library's backward walks int64 indices
// that its forward writes (8 bytes for every 2-byte output). These kernels
// pad inside their index arithmetic and write no indices: the backward
// finds each window's argmax again from the pool's input.
//
// The rule (the plain version's, models/impala.py:_max_pool_same_plain):
// a window is the 3x3 block of the padded input, walked in row-major
// order from its first position with the running max at -inf; an element
// v takes the window when `v > max || isnan(v)`. So the first maximum
// wins a tie, a NaN wins (the last NaN of a window), a padded position
// (-inf) never takes a window, and a window that holds nothing above -inf
// keeps its first position, which may be a pad (its gradient is then
// dropped). The backward uses the identical rule, so each window's
// gradient goes to the pixel the forward's maximum came from.
//
// The backward is a gather with no atomics: each input element sums, in
// f32 and in ascending (oh, ow) order, the output gradients of the 1, 2 or
// 4 windows whose argmax it is, and is rounded to its dtype once, as the
// library's channels-last backward sums. The result does not depend on
// the schedule: the same inputs give the same bits on every run.
//
// What bounds them on the H100 (3.35 TB/s; the work is a few compares per
// byte): bytes. At the learner's shapes (bf16, 5,376 frames a step; the
// inputs 84x84x16, 42x42x32 and 21x21x32) the forward must read each
// input once and write each output once, 2.47 GB a step (0.74 ms); the
// backward must read the output's gradient and the input and write the
// input's gradient, 4.44 GB (1.33 ms).
//
// How the design meets that bound. A CTA takes a tile of the output (a
// band of output rows of one frame, or whole frames when a frame is
// small; whole rows and all channels unless a row would not fit) and
// stages the input rows its windows cover in shared memory, each 16-byte
// vector (8 bf16 or 4 f32 channels) read from device memory once: the
// rows of a band are one contiguous run of memory, copied by 16-byte async
// copies that are all in flight before the CTA waits. The windows then
// read shared memory only. The backward stages the input rows and the
// output gradient's rows, keeps each window's argmax in shared memory,
// and gathers by cells of 2x2 pixels, whose (at most four) windows a
// thread reads once; the band's halo (the window row above it and the
// input rows under that window) is computed again by both neighbouring
// CTAs rather than shared through memory. Outputs and the input's
// gradient are written once, with 16-byte stores.
//
// Below the byte bound, the cost is instructions: the compares and
// selects run on the half-rate integer pipe. So bf16 packs compare two
// channels a word (one packed compare gives both channels' masks, one
// logic op selects both), the backward's argmax is kept as a bf16 number
// per channel so that the gather matches by the same packed compare, and
// a thread steps through its items without a division. C that is not a
// multiple of one vector (or a tensor off a 16-byte boundary) runs the
// same kernels one element at a time, in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// Shared memory a tile may take. Forward: four CTAs an SM at the
// learner's shapes. Backward: three, each with up to 85 registers a
// thread (kBwdBlocks); larger tiles there cost less halo (on the H100 at
// the learner's shapes, 64 KB tiles at three CTAs an SM took 1.79 ms a
// step where 48 KB tiles at two took 2.55).
constexpr size_t kFwdBudget = 48 * 1024;
constexpr size_t kBwdBudget = 64 * 1024;
constexpr int kBwdBlocks = 3;
// A tile never takes more than its budget (the least tile, one pack of
// one output pixel, is far below either), and the forward's stays within
// the 48 KB a launch may take without asking for more.
static_assert(kFwdBudget <= 48 * 1024, "the forward asks for no more");
// Frames share a tile only while the grid keeps two tiles for each of the
// H100's 132 SMs.
constexpr int kMinTiles = 2 * 132;

// P consecutive channels of one pixel, moved as one access.
template <typename T, int P>
struct alignas(sizeof(T) * P) Pack {
  T v[P];
};

// The argmax (0..8, row-major in the 3x3 window) of P channels.
template <int P>
struct alignas(P) Arg {
  uint8_t v[P];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The rule by which an element takes a window from the running max.
__device__ __forceinline__ bool takes(float v, float max) {
  return v > max || isnan(v);
}

// The rule applied to a pack of P channels, one channel at a time in f32:
// `best` holds each channel's running max as stored (its bits), `Index`
// the position (0..8) that took it. The backward keeps the Index of each
// window in shared memory and sums, per channel, the gradients of the
// windows whose Index is a pixel's position in them (`Sum`, in f32).
template <typename T, int P>
struct Rule {
  using Index = Arg<P>;
  struct Sum {
    float v[P];
  };
  __device__ static void start(Index& at) {
#pragma unroll
    for (int k = 0; k < P; ++k) at.v[k] = 0;
  }
  __device__ static void take(Pack<T, P>& best, const Pack<T, P>& v) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (takes(to_f(v.v[k]), to_f(best.v[k]))) best.v[k] = v.v[k];
    }
  }
  __device__ static void take(Pack<T, P>& best, Index& at,
                              const Pack<T, P>& v, int pos) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (takes(to_f(v.v[k]), to_f(best.v[k]))) {
        best.v[k] = v.v[k];
        at.v[k] = static_cast<uint8_t>(pos);
      }
    }
  }
  __device__ static void add(Sum& sum, const Index& at, const Pack<T, P>& d,
                             int pos) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (at.v[k] == pos) sum.v[k] += to_f(d.v[k]);
    }
  }
  __device__ static Pack<T, P> round(const Sum& sum) {
    Pack<T, P> out;
#pragma unroll
    for (int k = 0; k < P; ++k) out.v[k] = from_f<T>(sum.v[k]);
    return out;
  }
};

// A bf16 vector pack: the same rule two channels at a time, on the 32-bit
// words that hold them (per-channel masks from one packed compare). The
// Index holds each position as a bf16 number, so that the backward finds
// a pixel's windows by the same packed compare.
template <>
struct Rule<__nv_bfloat16, 8> {
  using Index = uint4;
  struct Sum {
    float v[8];
  };
  __device__ static void start(Index& at) { at = make_uint4(0, 0, 0, 0); }
  __device__ static void take(Pack<__nv_bfloat16, 8>& best,
                              const Pack<__nv_bfloat16, 8>& v) {
    uint4& b = reinterpret_cast<uint4&>(best);
    const uint4& x = reinterpret_cast<const uint4&>(v);
    b.x = pick(x.x, b.x, takes2(x.x, b.x));
    b.y = pick(x.y, b.y, takes2(x.y, b.y));
    b.z = pick(x.z, b.z, takes2(x.z, b.z));
    b.w = pick(x.w, b.w, takes2(x.w, b.w));
  }
  __device__ static void take(Pack<__nv_bfloat16, 8>& best, Index& at,
                              const Pack<__nv_bfloat16, 8>& v, int pos) {
    uint4& b = reinterpret_cast<uint4&>(best);
    const uint4& x = reinterpret_cast<const uint4&>(v);
    const unsigned here = number2(pos);
    unsigned m = takes2(x.x, b.x);
    b.x = pick(x.x, b.x, m);
    at.x = pick(here, at.x, m);
    m = takes2(x.y, b.y);
    b.y = pick(x.y, b.y, m);
    at.y = pick(here, at.y, m);
    m = takes2(x.z, b.z);
    b.z = pick(x.z, b.z, m);
    at.z = pick(here, at.z, m);
    m = takes2(x.w, b.w);
    b.w = pick(x.w, b.w, m);
    at.w = pick(here, at.w, m);
  }
  __device__ static void add(Sum& sum, const Index& at,
                             const Pack<__nv_bfloat16, 8>& d, int pos) {
    const uint4& g = reinterpret_cast<const uint4&>(d);
    const unsigned here = number2(pos);
    add2(sum.v[0], sum.v[1], g.x & equal2(at.x, here));
    add2(sum.v[2], sum.v[3], g.y & equal2(at.y, here));
    add2(sum.v[4], sum.v[5], g.z & equal2(at.z, here));
    add2(sum.v[6], sum.v[7], g.w & equal2(at.w, here));
  }
  __device__ static Pack<__nv_bfloat16, 8> round(const Sum& sum) {
    Pack<__nv_bfloat16, 8> out;
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const __nv_bfloat162 two =
          __floats2bfloat162_rn(sum.v[k], sum.v[k + 1]);
      out.v[k] = two.x;
      out.v[k + 1] = two.y;
    }
    return out;
  }

 private:
  __device__ static __nv_bfloat162 bf2(unsigned u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  }
  // Per channel: all ones where v takes the window from best (v > best,
  // or v is NaN: unordered with itself).
  __device__ static unsigned takes2(unsigned v, unsigned best) {
    return __hgt2_mask(bf2(v), bf2(best)) | __hneu2_mask(bf2(v), bf2(v));
  }
  __device__ static unsigned equal2(unsigned a, unsigned b) {
    return __heq2_mask(bf2(a), bf2(b));
  }
  // The position as a bf16 number in both halves.
  __device__ static unsigned number2(int pos) {
    return (__float_as_uint(static_cast<float>(pos)) >> 16) * 0x00010001u;
  }
  __device__ static unsigned pick(unsigned a, unsigned b, unsigned m) {
    return (a & m) | (b & ~m);
  }
  // A channel left out by the mask adds +0, which leaves an f32 sum that
  // starts at +0 as it was.
  __device__ static void add2(float& lo, float& hi, unsigned two) {
    lo += __uint_as_float(two << 16);
    hi += __uint_as_float(two & 0xffff0000u);
  }
};

// A 16-byte copy from device to shared memory on the async-copy path
// (cached in L2 only), so that every copy of a tile is in flight at once.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Input [n, h, w, c] and output [n, ho, wo, c], channels-last.
struct Geometry {
  int n, h, w, c;
  int ho, wo;
  int pt, pl;  // the top and left pads (the bottom and right follow)
};

// A tile is `frames` x `rows` x `cols` output pixels x `packs` packs of
// channels; n_* tiles along each of the four.
struct Tiling {
  int frames, rows, cols, packs;
  int n_frames, n_rows, n_cols, n_packs;
};

// One CTA's tile, in output coordinates; `p0` and `np` count packs.
struct Tile {
  int f0, nf, oh0, nr, ow0, nq, p0, np;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, const Tiling& t,
                                        int cp) {
  unsigned b = blockIdx.x;
  const int tp = b % t.n_packs;
  b /= t.n_packs;
  const int tq = b % t.n_cols;
  b /= t.n_cols;
  const int tr = b % t.n_rows;
  const int tf = b / t.n_rows;
  Tile r;
  r.f0 = tf * t.frames;
  r.nf = min(t.frames, g.n - r.f0);
  r.oh0 = tr * t.rows;
  r.nr = min(t.rows, g.ho - r.oh0);
  r.ow0 = tq * t.cols;
  r.nq = min(t.cols, g.wo - r.ow0);
  r.p0 = tp * t.packs;
  r.np = min(t.packs, cp - r.p0);
  return r;
}

// Where a thread's items of an f x r x q x p block sit (item threadIdx.x,
// then every kThreads-th after it), as (f, r, q, p), stepped without a
// division.
struct Walk {
  int f, r, q, p;
  int df, dr, dq, dp;
  int nr, nq, np;
  __device__ Walk(int nr_, int nq_, int np_) : nr(nr_), nq(nq_), np(np_) {
    split(threadIdx.x, f, r, q, p);
    split(kThreads, df, dr, dq, dp);
  }
  __device__ void next() {
    p += dp;
    q += dq;
    r += dr;
    f += df;
    if (p >= np) p -= np, ++q;
    if (q >= nq) q -= nq, ++r;
    if (r >= nr) r -= nr, ++f;
  }

 private:
  __device__ void split(int i, int& f_, int& r_, int& q_, int& p_) const {
    p_ = i % np;
    i /= np;
    q_ = i % nq;
    i /= nq;
    r_ = i % nr;
    f_ = i / nr;
  }
};

// Copy frames [f0, f0+nf) x rows [r0, r0+nr) x cols [q0, q0+nq) x packs
// [p0, p0+np) of a [., H, W, CP]-pack tensor into `dst`, in that order:
// 16-byte packs by async copies (wait_copies() waits for them), smaller
// ones by plain loads.
template <typename PackT>
__device__ __forceinline__ void stage(PackT* __restrict__ dst,
                                      const PackT* __restrict__ src, int H,
                                      int W, int CP, int f0, int r0, int q0,
                                      int p0, int nf, int nr, int nq,
                                      int np) {
  const int total = nf * nr * nq * np;
  // Whole rows of all channels (of whole frames when more than one) are
  // one contiguous run of memory.
  const bool run = nq == W && np == CP && (nf == 1 || nr == H);
  const PackT* first = src + ((int64_t)f0 * H + r0) * W * CP;
  Walk at(nr, nq, np);
  for (int i = threadIdx.x; i < total; i += kThreads, at.next()) {
    const PackT* from =
        run ? first + i
            : src + (((int64_t)(f0 + at.f) * H + r0 + at.r) * W + q0 + at.q) *
                        CP +
                  p0 + at.p;
    if constexpr (sizeof(PackT) == 16) {
      copy_async16(dst + i, from);
    } else {
      dst[i] = *from;
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    max_pool_same_fwd_kernel(const Pack<T, P>* __restrict__ x,
                             Pack<T, P>* __restrict__ y, Geometry g,
                             Tiling t) {
  using PackT = Pack<T, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  PackT* in = reinterpret_cast<PackT*>(smem);
  const int cp = g.c / P;
  const Tile tl = tile_of(g, t, cp);
  // The input rows and columns the tile's windows cover, pads left out.
  const int r0 = max(2 * tl.oh0 - g.pt, 0);
  const int r1 = min(2 * (tl.oh0 + tl.nr - 1) - g.pt + 3, g.h);
  const int q0 = max(2 * tl.ow0 - g.pl, 0);
  const int q1 = min(2 * (tl.ow0 + tl.nq - 1) - g.pl + 3, g.w);
  const int nr_in = r1 - r0, nq_in = q1 - q0;
  stage(in, x, g.h, g.w, cp, tl.f0, r0, q0, tl.p0, tl.nf, nr_in, nq_in,
        tl.np);
  wait_copies();
  __syncthreads();

  const int items = tl.nf * tl.nr * tl.nq * tl.np;
  Walk it(tl.nr, tl.nq, tl.np);
  for (int i = threadIdx.x; i < items; i += kThreads, it.next()) {
    const int oh = tl.oh0 + it.r, ow = tl.ow0 + it.q;
    PackT best;
#pragma unroll
    for (int k = 0; k < P; ++k) best.v[k] = from_f<T>(-INFINITY);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = 2 * oh - g.pt + dy;
      if (ih < 0 || ih >= g.h) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = 2 * ow - g.pl + dx;
        if (iw < 0 || iw >= g.w) continue;
        Rule<T, P>::take(
            best, in[((it.f * nr_in + ih - r0) * nq_in + iw - q0) * tl.np +
                     it.p]);
      }
    }
    y[(((int64_t)(tl.f0 + it.f) * g.ho + oh) * g.wo + ow) * cp + tl.p0 +
      it.p] = best;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
    max_pool_same_bwd_kernel(const Pack<T, P>* __restrict__ x,
                             const Pack<T, P>* __restrict__ gy,
                             Pack<T, P>* __restrict__ gx, Geometry g,
                             Tiling t) {
  using PackT = Pack<T, P>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cp = g.c / P;
  const Tile tl = tile_of(g, t, cp);
  // The windows whose argmax the tile needs: its own and the row and
  // column of windows before them (the halo), which overlap its pixels.
  const int wr0 = max(tl.oh0 - 1, 0), wr1 = tl.oh0 + tl.nr;
  const int wq0 = max(tl.ow0 - 1, 0), wq1 = tl.ow0 + tl.nq;
  const int nwr = wr1 - wr0, nwq = wq1 - wq0;
  // The input rows and columns those windows cover, pads left out.
  const int r0 = max(2 * wr0 - g.pt, 0);
  const int r1 = min(2 * (wr1 - 1) - g.pt + 3, g.h);
  const int q0 = max(2 * wq0 - g.pl, 0);
  const int q1 = min(2 * (wq1 - 1) - g.pl + 3, g.w);
  const int nr_in = r1 - r0, nq_in = q1 - q0;
  // The input pixels whose gradient the tile writes: those whose last
  // window (the one with the largest index) is the tile's; the last tile
  // of a row or column also takes the pixels no window covers.
  const int or0 = tl.oh0 == 0 ? 0 : max(2 * tl.oh0 - g.pt, 0);
  const int or1 = tl.oh0 + tl.nr == g.ho
                      ? g.h
                      : min(2 * (tl.oh0 + tl.nr) - g.pt, g.h);
  const int oq0 = tl.ow0 == 0 ? 0 : max(2 * tl.ow0 - g.pl, 0);
  const int oq1 = tl.ow0 + tl.nq == g.wo
                      ? g.w
                      : min(2 * (tl.ow0 + tl.nq) - g.pl, g.w);

  const int n_in = tl.nf * nr_in * nq_in * tl.np;
  const int n_win = tl.nf * nwr * nwq * tl.np;
  PackT* in = reinterpret_cast<PackT*>(smem);
  PackT* go = in + n_in;
  using Index = typename Rule<T, P>::Index;
  Index* arg = reinterpret_cast<Index*>(go + n_win);
  stage(in, x, g.h, g.w, cp, tl.f0, r0, q0, tl.p0, tl.nf, nr_in, nq_in,
        tl.np);
  stage(go, gy, g.ho, g.wo, cp, tl.f0, wr0, wq0, tl.p0, tl.nf, nwr, nwq,
        tl.np);
  wait_copies();
  __syncthreads();

  // Each window's argmax, by the forward's rule.
  Walk wi(nwr, nwq, tl.np);
  for (int i = threadIdx.x; i < n_win; i += kThreads, wi.next()) {
    const int oh = wr0 + wi.r, ow = wq0 + wi.q;
    PackT best;
    Index at;
#pragma unroll
    for (int k = 0; k < P; ++k) best.v[k] = from_f<T>(-INFINITY);
    Rule<T, P>::start(at);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = 2 * oh - g.pt + dy;
      if (ih < 0 || ih >= g.h) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = 2 * ow - g.pl + dx;
        if (iw < 0 || iw >= g.w) continue;
        Rule<T, P>::take(
            best, at,
            in[((wi.f * nr_in + ih - r0) * nq_in + iw - q0) * tl.np + wi.p],
            3 * dy + dx);
      }
    }
    arg[i] = at;
  }
  __syncthreads();

  // Each pixel gathers the gradients of the windows it is the argmax of,
  // a thread a cell of 2x2 pixels (padded rows 2c, 2c+1, columns 2d,
  // 2d+1), whose windows are (c-1 or c) x (d-1 or d): each read once.
  const int cr0 = (or0 + g.pt) >> 1, cr1 = ((or1 + g.pt - 1) >> 1) + 1;
  const int cq0 = (oq0 + g.pl) >> 1, cq1 = ((oq1 + g.pl - 1) >> 1) + 1;
  const int items = tl.nf * (cr1 - cr0) * (cq1 - cq0) * tl.np;
  Walk it(cr1 - cr0, cq1 - cq0, tl.np);
  for (int i = threadIdx.x; i < items; i += kThreads, it.next()) {
    const int c = cr0 + it.r, d = cq0 + it.q;
    Index at[2][2];
    PackT grad[2][2];
    bool has[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int oh = c - 1 + a, ow = d - 1 + b;
        has[a][b] = oh >= wr0 && oh < wr1 && ow >= wq0 && ow < wq1;
        if (has[a][b]) {
          const int w =
              ((it.f * nwr + oh - wr0) * nwq + ow - wq0) * tl.np + it.p;
          at[a][b] = arg[w];
          grad[a][b] = go[w];
        }
      }
    }
    // Pixel (sy, sx) of the cell; its windows in ascending (oh, ow) order
    // are (c-1+a, d-1+b) for a >= sy and b >= sx.
#pragma unroll
    for (int sy = 0; sy < 2; ++sy) {
      const int ih = 2 * c + sy - g.pt;
      if (ih < or0 || ih >= or1) continue;
#pragma unroll
      for (int sx = 0; sx < 2; ++sx) {
        const int iw = 2 * d + sx - g.pl;
        if (iw < oq0 || iw >= oq1) continue;
        typename Rule<T, P>::Sum sum;
#pragma unroll
        for (int k = 0; k < P; ++k) sum.v[k] = 0.f;
#pragma unroll
        for (int a = sy; a < 2; ++a) {
#pragma unroll
          for (int b = sx; b < 2; ++b) {
            // The pixel sits at row 2 - 2a + sy, column 2 - 2b + sx of
            // window (c-1+a, d-1+b).
            if (has[a][b]) {
              Rule<T, P>::add(sum, at[a][b], grad[a][b],
                              3 * (2 - 2 * a + sy) + (2 - 2 * b + sx));
            }
          }
        }
        gx[(((int64_t)(tl.f0 + it.f) * g.h + ih) * g.w + iw) * cp + tl.p0 +
           it.p] = Rule<T, P>::round(sum);
      }
    }
  }
}

// Shared memory a tile of frames x rows x cols x packs takes at most
// (index_bytes: a window's argmax, per pack).
size_t smem_bytes(const Geometry& g, bool backward, int pack_bytes,
                  int index_bytes, int frames, int rows, int cols,
                  int packs) {
  const size_t per_pack = (size_t)frames * packs;
  if (!backward) {
    return per_pack * std::min(2 * rows + 1, g.h) *
           std::min(2 * cols + 1, g.w) * pack_bytes;
  }
  const size_t windows =
      per_pack * std::min(rows + 1, g.ho) * std::min(cols + 1, g.wo);
  return per_pack * std::min(2 * rows + 3, g.h) *
             std::min(2 * cols + 3, g.w) * pack_bytes +
         windows * (pack_bytes + index_bytes);
}

// Whole rows and all channels unless one output row would not fit the
// budget (then fewer channels, then fewer columns); as many rows as fit,
// spread evenly over the tiles; whole frames together while the grid stays
// large enough.
Tiling choose_tiling(const Geometry& g, bool backward, int pack_bytes,
                     int index_bytes, int P) {
  const int cp = g.c / P;
  const size_t budget = backward ? kBwdBudget : kFwdBudget;
  int frames = 1, rows = 1, cols = g.wo, packs = cp;
  auto need = [&] {
    return smem_bytes(g, backward, pack_bytes, index_bytes, frames, rows,
                      cols, packs);
  };
  while (need() > budget && packs > 1) packs = (packs + 1) / 2;
  while (need() > budget && cols > 1) cols = (cols + 1) / 2;
  while (rows < g.ho) {
    ++rows;
    if (need() > budget) {
      --rows;
      break;
    }
  }
  rows = (g.ho + (g.ho + rows - 1) / rows - 1) / ((g.ho + rows - 1) / rows);
  if (rows == g.ho && cols == g.wo && packs == cp) {
    const size_t one = need();
    frames = (int)std::min<size_t>(std::max(g.n / kMinTiles, 1),
                                   std::max<size_t>(budget / one, 1));
    frames = (g.n + (g.n + frames - 1) / frames - 1) /
             ((g.n + frames - 1) / frames);
  }
  Tiling t;
  t.frames = frames;
  t.rows = rows;
  t.cols = cols;
  t.packs = packs;
  t.n_frames = (g.n + frames - 1) / frames;
  t.n_rows = (g.ho + rows - 1) / rows;
  t.n_cols = (g.wo + cols - 1) / cols;
  t.n_packs = (cp + packs - 1) / packs;
  return t;
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* gy, void* out,
                   const Geometry& g, bool backward, cudaStream_t s) {
  using PackT = Pack<T, P>;
  constexpr int kIndex = sizeof(typename Rule<T, P>::Index);
  const Tiling t = choose_tiling(g, backward, sizeof(PackT), kIndex, P);
  const int64_t tiles = (int64_t)t.n_frames * t.n_rows * t.n_cols * t.n_packs;
  if (tiles > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(g, backward, sizeof(PackT), kIndex,
                                 t.frames, t.rows, t.cols, t.packs);
  const PackT* xp = static_cast<const PackT*>(x);
  PackT* op = static_cast<PackT*>(out);
  if (backward) {
    // Above 48 KB a block's shared memory must be asked for (once).
    static const cudaError_t ready = cudaFuncSetAttribute(
        max_pool_same_bwd_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdBudget);
    if (ready != cudaSuccess) return ready;
    max_pool_same_bwd_kernel<T, P><<<(unsigned)tiles, kThreads, smem, s>>>(
        xp, static_cast<const PackT*>(gy), op, g, t);
  } else {
    max_pool_same_fwd_kernel<T, P><<<(unsigned)tiles, kThreads, smem, s>>>(
        xp, op, g, t);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* gy, void* out,
                     const Geometry& g, bool backward, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(gy) |
                         reinterpret_cast<uintptr_t>(out);
  if (g.c % kVec == 0 && addr % 16 == 0) {
    return launch<T, kVec>(x, gy, out, g, backward, s);
  }
  return launch<T, 1>(x, gy, out, g, backward, s);
}

cudaError_t run(const void* x, const void* gy, void* out, int n, int h,
                int w, int c, int ho, int wo, int pt, int pl, int dtype,
                bool backward, void* stream) {
  const Geometry g{n, h, w, c, ho, wo, pt, pl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, gy, out, g, backward, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, gy, out, g, backward, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [n, h, w, c] channels-last contiguous, f32 (dtype 0) or bf16 (dtype
// 1); y [n, ho, wo, c] like x; pt and pl the top and left pads of the
// "SAME" padding. Launches on `stream` and returns cudaGetLastError().
int max_pool_same_fwd(const void* x, void* y, int n, int h, int w, int c,
                      int ho, int wo, int pt, int pl, int dtype,
                      void* stream) {
  return run(x, x, y, n, h, w, c, ho, wo, pt, pl, dtype, false, stream);
}

// The forward's x, its output's gradient gy [n, ho, wo, c] and the input's
// gradient gx like x, all channels-last contiguous and of one dtype.
int max_pool_same_bwd(const void* x, const void* gy, void* gx, int n, int h,
                      int w, int c, int ho, int wo, int pt, int pl, int dtype,
                      void* stream) {
  return run(x, gy, gx, n, h, w, c, ho, wo, pt, pl, dtype, true, stream);
}

const char* max_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
