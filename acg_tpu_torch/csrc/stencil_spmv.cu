// K7: matrix-free Poisson SpMV, y = A x for the constant-coefficient
// 1D/2D/3D Poisson stencil on an n^dim grid, with every coefficient
// made in registers: 2*dim on the diagonal, -1 off it, and nothing where
// the row's grid coordinate (gidx / n^a) % n sits on that axis' edge.
//
// Replaces acg_tpu/ops/pallas_kernels.py: _stencil_poisson_call (entry
// stencil_spmv, pallas_call at :759).  The TPU kernel streams x through
// a VMEM window per row tile and has one route (the single-window band,
// N a multiple of the tile); this kernel takes any N and any n, so
// nothing falls back to the operator's plain apply.
//
// Bound on an H100: memory.  No plane exists anywhere: a row reads x
// once from DRAM and writes y (16 B/row in f64, 8 in f32: 67 MB, 20 us
// for f64 at 2048^2; 2.15 GB, 641 us at 512^3), against (2*dim + 3)
// values per row for K1 on assembled planes.  The shifted x reads of
// neighbouring rows come from L1/L2.  With one row a thread (the first
// design) each thread brought in one 4- or 8-byte value behind a 64-bit
// divide chain and 2*dim + 1 branches, so too few bytes were in flight
// to reach the bound (f32 at 0.43 of it at 2048^2).  So, as K1:
//  - each thread owns R = 16 / sizeof(T) rows (2 f64, 4 f32), a block a
//    tile of 256 R rows of one part.  x[i, i + R) arrives in one 16-byte
//    read-only load and y leaves in one 16-byte store;
//  - the -1 and +1 neighbours are the thread's own values and, at its
//    ends, one scalar load that the neighbouring lane's vector brought
//    into L1 (a warp shuffle in its place timed no faster on the H100);
//  - the +-n^a terms (a >= 1) arrive as 16-byte vectors, funnel-shifted
//    out of the two aligned vectors around them where n^a * sizeof(T)
//    is not a multiple of 16 (ldv_any);
//  - the grid coordinate is divided out once a thread, for its first
//    row (a multiply-high by a host-made magic number while every index
//    fits 31 bits, 64-bit division beyond); the other rows step coord[0]
//    and carry into the next axis;
//  - x is read through L1/L2 for the shifted terms, tile by tile: a 3D
//    form that walks each block along the outermost axis with three
//    planes in registers (2.5D blocking) timed slower on the H100 at
//    512^3, as it keeps fewer loads in flight;
//  - interior tiles -- more than n^(dim-1) rows inside the grid and, for
//    the stacked form, inside the part's owned window -- drop the
//    outermost axis' checks and the window's, and mask the inner axes'
//    terms with selects, not branches.  Every other row (tiles near an
//    end, the ragged last tile, the head of a part that starts off a
//    16-byte boundary, pointers off 16 bytes) runs one row at a time
//    with every check, as the first design did.
// On an H100 80GB HBM3 (700 W) this runs at 1.07-1.21x the time of a
// PyTorch copy of the same bytes; the rest is the shifted re-reads
// through L2 and the launch's ramp.
//
// Accumulates in the vector type in the assembled dia_mv's ascending
// offset order (-n^(dim-1) ... -1, 0, 1 ... n^(dim-1)), each term one
// rounded product and one rounded add (--fmad=false): -1 * x[j] and
// 2*dim * x[i] are the products the assembled planes give, and a masked
// term adds nothing where the planes add a zero product (the sum starts
// at +0, so it is never -0).  So y is bitwise-equal to the plain
// shifted-view apply and to K1 on the assembled planes of the operator.
//
// Stacked over parts (the multi-part local block, acg_tpu/parallel/
// dist.py:116-139 for format "matfree"): x and y (P, nrows), per-part
// row0 and nowned on the device, grid.y = P.  Part p computes
// dia_mv(stencil_planes(..., row0=row0[p], nowned=nowned[p]), x[p]):
// the edge mask from the global row row0[p] + i, and the owned-window
// mask i < nowned[p] and 0 <= i + off < nowned[p] (couplings out of the
// part live in the ghost block; padding rows are zero).
#include "common.cuh"

namespace {

// rows a thread: one 16-byte vector of x (two or four a thread timed
// slower on the H100)
template <typename T>
__host__ __device__ constexpr int rows_a_thread() {
  return 16 / static_cast<int>(sizeof(T));
}

// q / d for 0 <= q < 2^31 by a multiply-high and a shift (the unsigned
// round-up method of Granlund and Montgomery)
struct Div32 {
  unsigned int magic, shift;
  __device__ __forceinline__ int div(int q) const {
    const unsigned int u = static_cast<unsigned int>(q);
    return static_cast<int>((__umulhi(u, magic) + u) >> shift);
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
  return Div32{static_cast<unsigned int>(magic), shift};
}

// one row with every check: the global row's coordinate on each axis,
// the grid-edge masks and, stacked, the owned-window masks as branches
template <typename T, int DIM, typename I, typename DIV, bool OWNED>
__device__ __forceinline__ void row_checked(I row, I gidx, I nown, I n,
                                            DIV dv, const T* __restrict__ x,
                                            T* __restrict__ y) {
  if (OWNED && row >= nown) {   // a padding row: every plane is zero there
    y[row] = T(0);
    return;
  }
  I coord[DIM];
  I stride[DIM];
  I q = gidx;
  I s = 1;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const I qn = dv.div(q);
    coord[a] = q - qn * n;
    q = qn;
    stride[a] = s;
    s *= n;
  }
  const T mone = T(-1);
  T acc = T(0);
#pragma unroll
  for (int a = DIM - 1; a >= 0; --a) {   // offsets -n^(DIM-1) ... -1
    if (coord[a] > 0 && (!OWNED || row - stride[a] >= 0)) {
      acc = acc + mone * __ldg(x + row - stride[a]);
    }
  }
  acc = acc + T(2 * DIM) * __ldg(x + row);
#pragma unroll
  for (int a = 0; a < DIM; ++a) {        // offsets 1 ... n^(DIM-1)
    if (coord[a] < n - 1 && (!OWNED || row + stride[a] < nown)) {
      acc = acc + mone * __ldg(x + row + stride[a]);
    }
  }
  y[row] = acc;
}

template <typename T, int DIM, typename I, typename DIV, bool OWNED>
__global__ void __launch_bounds__(kBlock)
stencil_spmv_kernel(I n, DIV dv, I nrows, const long long* __restrict__ row0,
                    const long long* __restrict__ nowned,
                    const T* __restrict__ x, T* __restrict__ y, int vec_ok) {
  constexpr int R = rows_a_thread<T>();
  constexpr int TT = kBlock * R;
  constexpr int NI = DIM > 1 ? DIM - 1 : 1;   // inner axes 0 .. DIM-2

  I S = 1;                                   // n^(DIM-1)
#pragma unroll
  for (int a = 1; a < DIM; ++a) S *= n;
  const I N = S * n;
  const I gp = static_cast<I>(blockIdx.y) * nrows;   // the part's first row
  x += gp;
  y += gp;
  I r0 = 0;
  I nown = nrows;
  if (OWNED) {
    r0 = static_cast<I>(row0[blockIdx.y]);
    nown = static_cast<I>(nowned[blockIdx.y]);
  }
  // rows before the part's first 16-byte-aligned group of x and y
  const I h = vec_ok ? mod_pos<I>(-gp, R) : I(0);
  const I t0 = h + static_cast<I>(blockIdx.x) * TT;
  const I i = t0 + static_cast<I>(threadIdx.x) * R;

  // the head: rows [0, h) of the part, one per thread of block 0
  if (blockIdx.x == 0 && static_cast<I>(threadIdx.x) < h &&
      static_cast<I>(threadIdx.x) < nrows) {
    const I row = static_cast<I>(threadIdx.x);
    row_checked<T, DIM, I, DIV, OWNED>(row, r0 + row, nown, n, dv, x, y);
  }

  // every row of the tile more than S rows inside the grid and the
  // owned window: all reads in range, the outermost axis never masked
  const bool interior = vec_ok && t0 >= S && t0 + TT - 1 + S < nown &&
                        r0 + t0 >= S && r0 + t0 + TT - 1 + S < N;
  if (interior) {
    // the first row's coordinate on the inner axes
    I c[NI];
    {
      I q = r0 + i;
#pragma unroll
      for (int a = 0; a < DIM - 1; ++a) {
        const I qn = dv.div(q);
        c[a] = q - qn * n;
        q = qn;
      }
    }
    T xc[R];
    ldv<false>(x + i, xc);
    // x[i - 1] and x[i + R]: the neighbouring lanes' end values, from L1
    const T xm = __ldg(x + i - 1);
    const T xp = __ldg(x + i + R);
    // x[i -+ n^a, i -+ n^a + R) for the axes a >= 1
    T xlo[NI][R];
    T xhi[NI][R];
    {
      I s = 1;
#pragma unroll
      for (int a = 1; a < DIM; ++a) {
        s *= n;
        ldv_any<false>(x + i - s, xlo[a - 1]);
        ldv_any<false>(x + i + s, xhi[a - 1]);
      }
    }
    const T mone = T(-1);
    const T diag = T(2 * DIM);
    T yv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T acc = T(0);
#pragma unroll
      for (int a = DIM - 1; a >= 1; --a) {   // -n^(DIM-1) ... -n
        const T v = xlo[a - 1][r];
        if (a == DIM - 1) {
          acc = acc + mone * v;
        } else {
          acc = c[a < NI ? a : 0] > 0 ? acc + mone * v : acc;
        }
      }
      const T vm = r == 0 ? xm : xc[r > 0 ? r - 1 : 0];
      if (DIM == 1) {
        acc = acc + mone * vm;
      } else {
        acc = c[0] > 0 ? acc + mone * vm : acc;
      }
      acc = acc + diag * xc[r];
      const T vp = r == R - 1 ? xp : xc[r < R - 1 ? r + 1 : 0];
      if (DIM == 1) {
        acc = acc + mone * vp;
      } else {
        acc = c[0] < n - 1 ? acc + mone * vp : acc;
      }
#pragma unroll
      for (int a = 1; a < DIM; ++a) {        // n ... n^(DIM-1)
        const T v = xhi[a - 1][r];
        if (a == DIM - 1) {
          acc = acc + mone * v;
        } else {
          acc = c[a < NI ? a : 0] < n - 1 ? acc + mone * v : acc;
        }
      }
      yv[r] = acc;
      if (DIM > 1) {   // the next row's inner coordinates
        c[0] += 1;
        const bool wrap = c[0] == n;
        c[0] = wrap ? I(0) : c[0];
        if (DIM > 2) {
          c[NI - 1] += wrap ? I(1) : I(0);
          c[NI - 1] = c[NI - 1] == n ? I(0) : c[NI - 1];
        }
      }
    }
    stv(y + i, yv);
  } else {
    for (int r = 0; r < R; ++r) {
      const I row = i + r;
      if (row >= nrows) break;
      row_checked<T, DIM, I, DIV, OWNED>(row, r0 + row, nown, n, dv, x, y);
    }
  }
}

template <typename T, int DIM, typename I, typename DIV>
void launch_dim(long long n, DIV dv, int nparts, long long nrows,
                const void* row0, const void* nowned, const void* x, void* y,
                cudaStream_t s) {
  constexpr long long TT = kBlock * rows_a_thread<T>();
  const dim3 grid(static_cast<unsigned int>((nrows + TT - 1) / TT),
                  static_cast<unsigned int>(nparts));
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long* R0 = static_cast<const long long*>(row0);
  const long long* O = static_cast<const long long*>(nowned);
  const T* X = static_cast<const T*>(x);
  T* Y = static_cast<T*>(y);
  if (row0 != nullptr) {
    stencil_spmv_kernel<T, DIM, I, DIV, true><<<grid, kBlock, 0, s>>>(
        static_cast<I>(n), dv, static_cast<I>(nrows), R0, O, X, Y, vec_ok);
  } else {
    stencil_spmv_kernel<T, DIM, I, DIV, false><<<grid, kBlock, 0, s>>>(
        static_cast<I>(n), dv, static_cast<I>(nrows), R0, O, X, Y, vec_ok);
  }
}

template <typename T, typename I, typename DIV>
int launch(int dim, long long n, DIV dv, int nparts, long long nrows,
           const void* row0, const void* nowned, const void* x, void* y,
           cudaStream_t s) {
  if (dim == 1) {
    launch_dim<T, 1, I>(n, dv, nparts, nrows, row0, nowned, x, y, s);
  } else if (dim == 2) {
    launch_dim<T, 2, I>(n, dv, nparts, nrows, row0, nowned, x, y, s);
  } else if (dim == 3) {
    launch_dim<T, 3, I>(n, dv, nparts, nrows, row0, nowned, x, y, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dim, long long n, int nparts, long long nrows,
             const void* row0, const void* nowned, const void* x, void* y,
             cudaStream_t s) {
  if (dim < 1 || dim > 3) return static_cast<int>(cudaErrorInvalidValue);
  // 32-bit indices while every global row, stacked row and the reads
  // around them (a tile and n^(dim-1) past either end) fit 31 bits
  long long S = 1;
  for (int a = 1; a < dim; ++a) S *= n;
  const long long total = S * n;
  const long long stacked = static_cast<long long>(nparts) * nrows;
  const long long TT = kBlock * rows_a_thread<T>();
  const long long big = (total > stacked ? total : stacked) + 2 * S + 2 * TT;
  if (big < 0x7fffffffLL) {
    return launch<T, int>(dim, n, make_div32(n), nparts, nrows, row0, nowned,
                          x, y, s);
  }
  return launch<T, long long>(dim, n, Div64{n}, nparts, nrows, row0, nowned,
                              x, y, s);
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
