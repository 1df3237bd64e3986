// K7: matrix-free Poisson SpMV, y = A x for the constant-coefficient
// 1D/2D/3D Poisson stencil on an n^dim grid, with every coefficient
// made in registers: 2*dim on the diagonal, -1 off it, and nothing where
// the row's grid coordinate (gidx / n^a) % n sits on that axis' edge.
//
// Replaces acg_tpu/ops/pallas_kernels.py: _stencil_poisson_call (entry
// stencil_spmv, pallas_call at :759).  The TPU kernel streams x through
// a VMEM window per row tile and has one route (the single-window band,
// N a multiple of the tile); here one thread per row takes any N and
// any n, so nothing falls back to the operator's plain apply.
//
// Bound on an H100: memory.  No plane exists anywhere: a row reads x
// once from DRAM and writes y (16 B/row in f64, 8 in f32: 67 MB, 20 us
// for f64 at 2048^2; 2.15 GB, 641 us at 512^3), against (2*dim + 3)
// values per row for K1 on assembled planes.  The 2*dim shifted x reads
// of neighbouring rows hit L1/L2 (+-1 in the same block, +-n within a
// few blocks, +-n^2 of a 512^3 grid 2 MB away).  The grid coordinates
// come from one divide by n per axis: a multiply-high by a magic number
// (Granlund and Montgomery's round-up method) while every global row
// index fits 31 bits, 64-bit division beyond.
//
// Accumulates in the vector type in the assembled dia_mv's ascending
// offset order (-n^(dim-1) ... -1, 0, 1 ... n^(dim-1)), each term one
// rounded product and one rounded add (--fmad=false): -1 * x[j] and
// 2*dim * x[i] are the products the assembled planes give, and a masked
// term adds nothing where the planes add a zero product.  So y is
// bitwise-equal to the plain shifted-view apply and to K1 on the
// assembled planes of the same operator.
//
// Stacked over parts (the multi-part local block, acg_tpu/parallel/
// dist.py:116-139 for format "matfree"): x and y (P, nrows), per-part
// row0 and nowned on the device, grid.y = P.  Part p computes
// dia_mv(stencil_planes(..., row0=row0[p], nowned=nowned[p]), x[p]):
// the edge mask from the global row row0[p] + i, and the owned-window
// mask i < nowned[p] and 0 <= i + off < nowned[p] (couplings out of the
// part live in the ghost block; padding rows are zero).
#include <stdint.h>

#include "common.cuh"

namespace {

// q / d for q < 2^31 by a multiply-high and a shift (the unsigned
// round-up method of Granlund and Montgomery)
struct Div32 {
  unsigned int d, magic, shift;
  __device__ __forceinline__ long long div(long long q) const {
    const unsigned int u = static_cast<unsigned int>(q);
    return static_cast<long long>((__umulhi(u, magic) + u) >> shift);
  }
};

struct Div64 {
  long long d;
  __device__ __forceinline__ long long div(long long q) const {
    return q / d;
  }
};

Div32 make_div32(long long d) {
  unsigned int shift = 0;
  while ((1ull << shift) < static_cast<unsigned long long>(d)) ++shift;
  const unsigned long long one = 1;
  const unsigned long long magic =
      ((one << 32) * ((one << shift) - static_cast<unsigned long long>(d))) /
          static_cast<unsigned long long>(d) + 1;
  return Div32{static_cast<unsigned int>(d), static_cast<unsigned int>(magic),
               shift};
}

template <typename T, int DIM, typename DIV, bool OWNED>
__global__ void __launch_bounds__(kBlock)
stencil_spmv_kernel(long long n, DIV div_n, long long nrows,
                    const long long* __restrict__ row0,
                    const long long* __restrict__ nowned,
                    const T* __restrict__ x, T* __restrict__ y) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= nrows) return;
  const long long p = blockIdx.y;
  x += p * nrows;
  y += p * nrows;
  long long gidx = i;
  long long nown = nrows;
  if (OWNED) {
    gidx += row0[p];
    nown = nowned[p];
    if (i >= nown) {   // a padding row: every plane is zero there
      y[i] = T(0);
      return;
    }
  }
  // the row's grid coordinate on each axis, and each axis' stride n^a
  long long coord[DIM];
  long long stride[DIM];
  long long q = gidx;
  long long s = 1;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const long long qn = div_n.div(q);
    coord[a] = q - qn * n;
    q = qn;
    stride[a] = s;
    s *= n;
  }
  const T mone = T(-1);
  T acc = T(0);
#pragma unroll
  for (int a = DIM - 1; a >= 0; --a) {   // offsets -n^(DIM-1) ... -1
    if (coord[a] > 0 && (!OWNED || i - stride[a] >= 0)) {
      acc = acc + mone * ld(x[i - stride[a]]);
    }
  }
  acc = acc + T(2 * DIM) * ld(x[i]);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {        // offsets 1 ... n^(DIM-1)
    if (coord[a] < n - 1 && (!OWNED || i + stride[a] < nown)) {
      acc = acc + mone * ld(x[i + stride[a]]);
    }
  }
  st(&y[i], acc);
}

template <typename T, int DIM, typename DIV>
void launch_dim(long long n, DIV div_n, int nparts, long long nrows,
                const void* row0, const void* nowned, const void* x, void* y,
                cudaStream_t s) {
  const dim3 grid(row_blocks(nrows), static_cast<unsigned int>(nparts));
  const long long* R = static_cast<const long long*>(row0);
  const long long* O = static_cast<const long long*>(nowned);
  const T* X = static_cast<const T*>(x);
  T* Y = static_cast<T*>(y);
  if (row0 != nullptr) {
    stencil_spmv_kernel<T, DIM, DIV, true>
        <<<grid, kBlock, 0, s>>>(n, div_n, nrows, R, O, X, Y);
  } else {
    stencil_spmv_kernel<T, DIM, DIV, false>
        <<<grid, kBlock, 0, s>>>(n, div_n, nrows, R, O, X, Y);
  }
}

template <typename T, typename DIV>
int launch(int dim, long long n, DIV div_n, int nparts, long long nrows,
           const void* row0, const void* nowned, const void* x, void* y,
           cudaStream_t s) {
  if (dim == 1) {
    launch_dim<T, 1>(n, div_n, nparts, nrows, row0, nowned, x, y, s);
  } else if (dim == 2) {
    launch_dim<T, 2>(n, div_n, nparts, nrows, row0, nowned, x, y, s);
  } else if (dim == 3) {
    launch_dim<T, 3>(n, div_n, nparts, nrows, row0, nowned, x, y, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dim, long long n, int nparts, long long nrows,
             const void* row0, const void* nowned, const void* x, void* y,
             cudaStream_t s) {
  // the largest global row index is n^dim - 1
  long long total = 1;
  for (int a = 0; a < dim; ++a) total *= n;
  if (total <= 0x7fffffffLL) {
    return launch<T>(dim, n, make_div32(n), nparts, nrows, row0, nowned, x,
                     y, s);
  }
  return launch<T>(dim, n, Div64{n}, nparts, nrows, row0, nowned, x, y, s);
}

}  // namespace

// x, y: (nparts, nrows) contiguous; row0, nowned: (nparts,) int64 on the
// device, or both null for the whole grid on one part (nparts == 1 and
// nrows == n^dim).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int acg_stencil_spmv(int xtype, int dim, long long n, int nparts,
                                long long nrows, const void* row0,
                                const void* nowned, const void* x, void* y,
                                void* stream) {
  if (nrows <= 0 || nparts <= 0) return 0;
  if (nparts > 65535 || n < 2 || (row0 == nullptr) != (nowned == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xtype == ACG_F64)
    return dispatch<double>(dim, n, nparts, nrows, row0, nowned, x, y, s);
  if (xtype == ACG_F32)
    return dispatch<float>(dim, n, nparts, nrows, row0, nowned, x, y, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
