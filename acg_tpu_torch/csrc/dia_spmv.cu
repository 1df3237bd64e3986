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
//
// Batched over parts (the multi-part solver's local-block SpMV,
// acg_tpu/parallel/dist.py:791-793, one dia_spmv per shard): planes
// (nd, P, N), x and y (P, N), grid.y = P.  Each part has its own edges
// [0, N): a shifted read never reaches the neighbouring part's entries,
// so a non-finite value in one part cannot reach another through a zero
// plane value, and every part's rows are that shard's dia_mv.  P = 1 is
// the single-vector entry.  The dot epilogue is single-part only.
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
  // this block's part: its vector rows and its slice of every plane
  const long long p = blockIdx.y;
  const long long pstride = static_cast<long long>(gridDim.y) * n;
  x += p * n;
  y += p * n;
  planes += p * n;
  AT prod = AT(0);
  if (i < n) {
    AT acc = AT(0);
    for (int d = 0; d < nd; ++d) {
      const long long j = i + soff[d];
      if (j >= 0 && j < n) {
        acc = acc + static_cast<AT>(ld(planes[d * pstride + i])) *
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
int launch(const void* planes, const void* offs, int nd, int nparts,
           long long n, const void* x, void* y, void* part, void* dot,
           cudaStream_t s) {
  if (dot != nullptr && nparts != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int nblk = row_blocks(n);
  const dim3 grid(nblk, static_cast<unsigned int>(nparts));
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
    reduce_partials<AT>(part_, nblk, static_cast<AT*>(dot), s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes: (nd, nparts, n) contiguous; offs: (nd,) int64 on the device;
// x, y: (nparts, n); part: (ceil(n / 256),) accumulation-type scratch and
// dot: one accumulation-type value, both ignored when dot is null (the
// dot needs nparts == 1).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int acg_dia_spmv(int ptype, int xtype, const void* planes,
                            const void* offs, int nd, int nparts,
                            long long n, const void* x, void* y, void* part,
                            void* dot, void* stream) {
  if (n <= 0 || nparts <= 0) return 0;
  if (nparts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptype == ACG_F64 && xtype == ACG_F64)
    return launch<double, double, double>(planes, offs, nd, nparts, n, x, y,
                                          part, dot, s);
  if (ptype == ACG_F32 && xtype == ACG_F32)
    return launch<float, float, float>(planes, offs, nd, nparts, n, x, y,
                                       part, dot, s);
  if (ptype == ACG_BF16 && xtype == ACG_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(
        planes, offs, nd, nparts, n, x, y, part, dot, s);
  if (ptype == ACG_BF16 && xtype == ACG_F32)
    return launch<__nv_bfloat16, float, float>(planes, offs, nd, nparts, n,
                                               x, y, part, dot, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
