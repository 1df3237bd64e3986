// K1 (and its dot epilogue, K2): y = A x for square DIA planes,
//   y[i] = sum_d planes[d][i] * x[i + off_d],   (y, x . y) with the dot.
//
// Replaces acg_tpu/ops/pallas_kernels.py: _dia_spmv_clustered (the
// "fast"/"clustered" routes of dia_spmv, pallas_call at :379, and
// dia_spmv_dot with with_dot=True) and _dia_spmv_padded (the ragged
// route, pallas_call at :423).  One kernel covers all three: there is no
// tile, window or route restriction, so any N and any offsets work,
// including the 3D +-n^2 diagonals and bands too wide for a TPU window.
//
// Bound on an H100: memory.  Each row reads D plane values and writes
// one y, and x is read once from DRAM: (D + 2) * N * itemsize bytes at
// 3.35 TB/s (5-point flagship, f64: ~235 MB -> ~70 us).  The D shifted x
// reads of neighbouring rows hit L1/L2 (offsets +-1 in the same block,
// +-n within a few blocks), which stands in for the TPU kernel's VMEM
// window; the arithmetic (2 flops per plane value) is far below the
// card's rate.  One thread per row, planes read coalesced; staging x in
// shared memory is later work.
//
// Accumulates in the accumulation type (double for f64, float for f32,
// bf16 and bf16 planes with f32 x) in offsets order, skipping columns
// outside [0, N), and rounds y once on store.  With the dot, each block
// writes its partial of x . y (unrounded y times x, as the TPU kernel
// does) and one block folds the partials in a fixed order.
#include "common.cuh"

namespace {

template <typename PT, typename XT, typename AT, bool DOT>
__global__ void __launch_bounds__(kBlock)
dia_spmv_kernel(const PT* __restrict__ planes,
                const long long* __restrict__ offs, int nd, long long n,
                const XT* __restrict__ x, XT* __restrict__ y,
                AT* __restrict__ part) {
  extern __shared__ long long soff[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) soff[d] = offs[d];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  AT prod = AT(0);
  if (i < n) {
    AT acc = AT(0);
    for (int d = 0; d < nd; ++d) {
      const long long j = i + soff[d];
      if (j >= 0 && j < n) {
        acc = acc + static_cast<AT>(ld(planes[d * n + i])) *
                        static_cast<AT>(ld(x[j]));
      }
    }
    st(&y[i], acc);
    if (DOT) prod = acc * static_cast<AT>(ld(x[i]));
  }
  if (DOT) {
    prod = block_sum(prod);
    if (threadIdx.x == 0) part[blockIdx.x] = prod;
  }
}

template <typename PT, typename XT, typename AT>
int launch(const void* planes, const void* offs, int nd, long long n,
           const void* x, void* y, void* part, void* dot, cudaStream_t s) {
  const unsigned int grid = row_blocks(n);
  const size_t smem = static_cast<size_t>(nd) * sizeof(long long);
  const PT* P = static_cast<const PT*>(planes);
  const long long* O = static_cast<const long long*>(offs);
  const XT* X = static_cast<const XT*>(x);
  XT* Y = static_cast<XT*>(y);
  if (dot == nullptr) {
    dia_spmv_kernel<PT, XT, AT, false>
        <<<grid, kBlock, smem, s>>>(P, O, nd, n, X, Y, nullptr);
  } else {
    AT* part_ = static_cast<AT*>(part);
    dia_spmv_kernel<PT, XT, AT, true>
        <<<grid, kBlock, smem, s>>>(P, O, nd, n, X, Y, part_);
    reduce_partials<AT>(part_, grid, static_cast<AT*>(dot), s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: (nd, n) contiguous; offs: (nd,) int64 on the device; x, y: (n,);
// part: (ceil(n / 256),) accumulation-type scratch and dot: one
// accumulation-type value, both ignored when dot is null.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int acg_dia_spmv(int ptype, int xtype, const void* planes,
                            const void* offs, int nd, long long n,
                            const void* x, void* y, void* part, void* dot,
                            void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptype == ACG_F64 && xtype == ACG_F64)
    return launch<double, double, double>(planes, offs, nd, n, x, y, part,
                                          dot, s);
  if (ptype == ACG_F32 && xtype == ACG_F32)
    return launch<float, float, float>(planes, offs, nd, n, x, y, part, dot,
                                       s);
  if (ptype == ACG_BF16 && xtype == ACG_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(planes, offs, nd, n,
                                                       x, y, part, dot, s);
  if (ptype == ACG_BF16 && xtype == ACG_F32)
    return launch<__nv_bfloat16, float, float>(planes, offs, nd, n, x, y,
                                               part, dot, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
