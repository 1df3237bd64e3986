// Shared helpers of the port's Hopper kernels: storage <-> accumulation
// conversions, a fixed-order block reduction, and the single-block pass
// that folds per-block partial sums into one scalar.
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

// dtype codes of the C interface (ops/_build.py keeps the same table)
enum AcgDtype { ACG_F64 = 0, ACG_F32 = 1, ACG_BF16 = 2 };

namespace {

constexpr int kBlock = 256;        // threads per block of the row kernels
constexpr int kReduceBlock = 1024; // threads of the partial-sum fold

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

inline unsigned int row_blocks(long long n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

}  // namespace
