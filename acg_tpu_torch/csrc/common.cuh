// Shared helpers of the port's Hopper kernels: storage <-> accumulation
// conversions, a fixed-order block reduction, the single-block pass that
// folds per-block partial sums into one scalar, and 16-byte vector
// loads and stores.
//
// Built with --fmad=false: a*b + c is a rounded multiply followed by a
// rounded add, as in PyTorch's separate elementwise ops, so every vector
// a kernel writes is bitwise-equal to its plain PyTorch version.  Only
// the dot products differ, because they are summed in another order
// (per-block tree, then a fixed-order fold of the block partials: no
// float atomics, so reruns are bitwise-reproducible).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

// dtype codes of the C interface (ops/_build.py keeps the same table)
enum AcgDtype { ACG_F64 = 0, ACG_F32 = 1, ACG_BF16 = 2 };

namespace {

constexpr int kBlock = 256;        // threads per block of the row kernels
constexpr int kReduceBlock = 1024; // threads of the partial-sum fold
constexpr int kMaxDiags = 64;      // ops/spmv.py MAX_DIAGS

// widen storage to the accumulation type
__device__ __forceinline__ double ld(double v) { return v; }
__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an accumulation value to storage and write it
__device__ __forceinline__ void st(double* p, double v) { *p = v; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the value a store of v into T would hold, back in accumulation type
__device__ __forceinline__ double rnd(double v, const double*) { return v; }
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sum of v over the block, valid in thread 0; the order is fixed by the
// block shape alone
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = threadIdx.x < nwarps ? warp_sums[threadIdx.x] : T(0);
  if (wid == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// one block folds m partials into *out in a fixed order
template <typename T>
__global__ void __launch_bounds__(kReduceBlock)
reduce_partials_kernel(const T* __restrict__ part, long long m,
                       T* __restrict__ out) {
  T s = T(0);
  for (long long k = threadIdx.x; k < m; k += blockDim.x) s += part[k];
  s = block_sum(s);
  if (threadIdx.x == 0) *out = s;
}

template <typename T>
void reduce_partials(const T* part, long long m, T* out, cudaStream_t s) {
  reduce_partials_kernel<T><<<1, kReduceBlock, 0, s>>>(part, m, out);
}

// the 16 bytes starting `delta` bytes into a ++ b (delta in 0..15, a
// multiple of 2): a branch-free word select and funnel shift
__device__ __forceinline__ uint4 shift16(uint4 a, uint4 b, int delta) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int ws = delta >> 2, bs = (delta & 3) * 8;
  unsigned out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    unsigned lo = w[k], hi = w[k + 1];
#pragma unroll
    for (int m = 1; m < 4; ++m) {
      lo = ws == m ? w[k + m] : lo;
      hi = ws == m ? w[k + m + 1] : hi;
    }
    out[k] = __funnelshift_r(lo, hi, bs);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// v[0..N) = p[0..N); p 16-byte aligned, N * sizeof(T) a multiple of 16;
// STREAM takes the streaming hint (values used once), else read-only
template <bool STREAM, typename T, int N>
__device__ __forceinline__ void ldv(const T* p, T (&v)[N]) {
  constexpr int C = N * static_cast<int>(sizeof(T)) / 16;
  constexpr int K = 16 / static_cast<int>(sizeof(T));
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint4 u = STREAM ? __ldcs(q + c) : __ldg(q + c);
    memcpy(&v[c * K], &u, 16);
  }
}

// as ldv, through plain (coherent) loads: for values the kernel writes
// back in place, which the read-only path may not hold
template <typename T, int N>
__device__ __forceinline__ void ldv_rw(const T* p, T (&v)[N]) {
  constexpr int C = N * static_cast<int>(sizeof(T)) / 16;
  constexpr int K = 16 / static_cast<int>(sizeof(T));
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint4 u = q[c];
    memcpy(&v[c * K], &u, 16);
  }
}

// v[0..N) = p[0..N) for p at any 16-byte phase (a whole number of
// elements): the aligned vectors around the values, each output vector
// funnel-shifted out of two of them.  Reads no byte outside the 16-byte
// vectors that hold p[0] and p[N - 1].  The phase test is uniform where
// every lane's p has the same phase, as in every caller.
template <bool STREAM, typename T, int N>
__device__ __forceinline__ void ldv_any(const T* p, T (&v)[N]) {
  constexpr int C = N * static_cast<int>(sizeof(T)) / 16;
  constexpr int K = 16 / static_cast<int>(sizeof(T));
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int delta = static_cast<int>(a & 15);
  if (delta == 0) {
    ldv<STREAM>(p, v);
    return;
  }
  const uint4* q = reinterpret_cast<const uint4*>(a - delta);
  uint4 lo = STREAM ? __ldcs(q) : __ldg(q);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint4 hi = STREAM ? __ldcs(q + c + 1) : __ldg(q + c + 1);
    const uint4 u = shift16(lo, hi, delta);
    memcpy(&v[c * K], &u, 16);
    lo = hi;
  }
}

template <typename T, int N>
__device__ __forceinline__ void stv(T* p, const T (&v)[N]) {
  constexpr int C = N * static_cast<int>(sizeof(T)) / 16;
  constexpr int K = 16 / static_cast<int>(sizeof(T));
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    uint4 u;
    memcpy(&u, &v[c * K], 16);
    q[c] = u;
  }
}

template <typename I>
__device__ __forceinline__ I mod_pos(I a, int m) {   // a mod m in [0, m)
  const I r = a % m;
  return r < 0 ? r + m : r;
}

inline unsigned int row_blocks(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

}  // namespace
