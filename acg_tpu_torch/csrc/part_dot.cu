// The per-part dots of stacked vectors, the local half of every global
// dot on the multi-part tiers:
//   out[p] = sum_i S(a[p, i]) * S(c[p, i])     for each of the P rows
// with each product rounded to the accumulation type S before it is
// added, as the plain version's a.to(S) * c.to(S) then .sum() computes.
//
// The reference computes this with an XLA dot
// (acg_tpu/parallel/dist.py:1413, no pallas_call).  A PyTorch reduction
// over the last axis of a (P, n) tensor picks its split of the rows by
// P and vectorizes by the rows' alignment, so a part's dot would depend
// on how many parts the tensor stacks -- and a rank of the
// multi-process tier stacks fewer parts than one process does.  Here the
// summation order is fixed by n alone: grid (blocks, P) with the block
// count a function of n, element i of a row summed by thread i mod
// (blocks * kBlock) of that row's blocks in index order, a fixed-shape
// block tree, and the last block of each row (a ticket per row) folding
// the row's block partials in a fixed order.  Scalar loads by index, so
// a row's alignment changes nothing.  One launch per dot; no float
// atomics, so reruns are bitwise-reproducible.
//
// Bound on an H100: memory, 2 * P * n * itemsize bytes at 3.35 TB/s
// (the flagship's 4 f64 parts of 1,048,781 rows: ~67 MB -> ~20 us).
#include "common.cuh"

namespace {

constexpr int kDotPerThread = 4;     // elements per thread at the cap below
constexpr int kDotBlocksMax = 1024;  // blocks per row

inline unsigned int dot_blocks(long long n) {
  const long long per = static_cast<long long>(kBlock) * kDotPerThread;
  const long long b = (n + per - 1) / per;
  return static_cast<unsigned int>(b < 1 ? 1 : (b > kDotBlocksMax
                                                    ? kDotBlocksMax : b));
}

template <typename T, typename S>
__global__ void __launch_bounds__(kBlock)
part_dot_kernel(long long n, const T* __restrict__ a, long long lda,
                const T* __restrict__ c, long long ldc, S* __restrict__ part,
                unsigned int* __restrict__ ticket, S* __restrict__ out) {
  const long long p = blockIdx.y;
  const unsigned int nb = gridDim.x;
  const T* ap = a + p * lda;
  const T* cp = c + p * ldc;
  const long long stride = static_cast<long long>(nb) * blockDim.x;
  S s = S(0);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const S prod = static_cast<S>(ld(ap[i])) * static_cast<S>(ld(cp[i]));
    s += prod;
  }
  s = block_sum(s);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part[p * nb + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(&ticket[p], 1u) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  S t = S(0);
  for (unsigned int k = threadIdx.x; k < nb; k += blockDim.x)
    t += __ldcg(part + p * nb + k);
  t = block_sum(t);
  if (threadIdx.x == 0) {
    out[p] = t;
    ticket[p] = 0u;   // ready for the next launch on this stream
  }
}

template <typename T, typename S>
int launch(long long P, long long n, const void* a, long long lda,
           const void* c, long long ldc, void* part, void* ticket, void* out,
           cudaStream_t s) {
  const dim3 grid(dot_blocks(n), static_cast<unsigned int>(P));
  part_dot_kernel<T, S><<<grid, kBlock, 0, s>>>(
      n, static_cast<const T*>(a), lda, static_cast<const T*>(c), ldc,
      static_cast<S*>(part), static_cast<unsigned int*>(ticket),
      static_cast<S*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_s(int stype, long long P, long long n, const void* a,
             long long lda, const void* c, long long ldc, void* part,
             void* ticket, void* out, cudaStream_t s) {
  if (stype == ACG_F64)
    return launch<T, double>(P, n, a, lda, c, ldc, part, ticket, out, s);
  if (stype == ACG_F32)
    return launch<T, float>(P, n, a, lda, c, ldc, part, ticket, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Blocks per row for n elements: the caller sizes `part` as P times this.
extern "C" int acg_part_dot_blocks(long long n) {
  return static_cast<int>(dot_blocks(n));
}

// a, c: P rows of n elements of vtype, rows lda and ldc elements apart;
// part: P * acg_part_dot_blocks(n) stype scratch values; ticket: P
// unsigned ints, zero on entry and left zero; out: P stype values.
// 0 < P <= 65535.
extern "C" int acg_part_dot(int vtype, int stype, long long P, long long n,
                            const void* a, long long lda, const void* c,
                            long long ldc, void* part, void* ticket,
                            void* out, void* stream) {
  if (P <= 0 || P > 65535 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vtype == ACG_F64)
    return launch_s<double>(stype, P, n, a, lda, c, ldc, part, ticket, out,
                            s);
  if (vtype == ACG_F32)
    return launch_s<float>(stype, P, n, a, lda, c, ldc, part, ticket, out, s);
  if (vtype == ACG_BF16)
    return launch_s<__nv_bfloat16>(stype, P, n, a, lda, c, ldc, part, ticket,
                                   out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
