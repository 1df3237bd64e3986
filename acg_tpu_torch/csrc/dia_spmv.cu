// K1 (and its dot epilogue, K2): y = A x for square DIA planes,
//   y[i] = sum_d planes[d][i] * x[i + off_d],   (y, x . y) with the dot.
//
// Replaces acg_tpu/ops/pallas_kernels.py: _dia_spmv_clustered (the
// "fast"/"clustered" routes of dia_spmv, pallas_call at :379, and
// dia_spmv_dot with with_dot=True) and _dia_spmv_padded (the ragged
// route, pallas_call at :423).  One kernel covers all three: any N and
// any offsets, including the 3D +-n^2 diagonals and bands far wider than
// a shared-memory window.
//
// Bound on an H100: memory.  Each row reads D plane values and writes
// one y, and x is read once from DRAM: (D + 2) * N * itemsize bytes at
// 3.35 TB/s (5-point flagship, f64: ~235 MB -> ~70 us); the arithmetic
// (2 flops per plane value) is far below the card's rate.  So the design
// is about moving those bytes in as few, wide, independent loads:
//  - each thread owns R rows, R = 16 / sizeof(plane): every plane value
//    arrives in a 16-byte vector load (R = 2 f64, 4 f32, 8 bf16) with the
//    streaming hint (each is used once), and y leaves in 16-byte stores;
//    a block owns a tile of T = 256 R rows of one part.  A plane row
//    that starts off x's 16-byte phase (d * P * n not a whole number of
//    vectors: odd n) is funnel-shifted out of the two aligned vectors
//    around it, so the loads stay 16 bytes wide;
//  - interior tiles (whole, aligned, every diagonal's columns inside the
//    part) run the diagonal loop with no bounds check and no branch, so
//    the loads of several diagonals are in flight together; x comes in
//    R read-only scalar loads a diagonal, whose neighbouring rows the
//    other lanes of the warp share through L1.  Tiles at a part's edges
//    (within max |offset| rows of them), the ragged last tile, the head
//    of under R rows before a part's first aligned row, and pointers off
//    16 bytes run one row per step with checks;
//  - x is not staged in shared memory: the +-n reads come from L2 and
//    the central diagonals' re-reads from L1 either way, and a staged
//    variant timed slower on every shape measured on the H100;
//  - index arithmetic is 32-bit while nd * P * n and the offsets fit 31
//    bits (the plan says so), 64-bit beyond.
// The plan (ops/kernels.py dia_tile_plan: R, T, the index width) is
// computed once per offsets / n / dtypes in Python and passed by value,
// the offsets with it.
//
// Accumulates in the accumulation type (double for f64, float for f32,
// bf16 and bf16 planes with f32 x) in offsets order, skipping columns
// outside [0, n), and rounds y once on store.  With the dot, each block
// writes its partial of x . y (unrounded y times x, as the TPU kernel
// does) over its tile and one block folds the partials in a fixed
// order.
//
// Batched over parts (the multi-part solver's local-block SpMV,
// acg_tpu/parallel/dist.py:791-793, one dia_spmv per shard): planes
// (nd, P, n), x and y (P, n), grid.y = P.  Each part has its own edges
// [0, n): a shifted read never reaches the neighbouring part's entries,
// so a non-finite value in one part cannot reach another through a zero
// plane value, and every part's rows are that shard's dia_mv.  P = 1 is
// the single-vector entry.  The dot epilogue is single-part only.
#include "common.cuh"

namespace {

// the launch plan, packed by ops/kernels.py DiaTilePlan.packed()
struct DiaPlan {
  int rows;        // R, rows per thread
  int tile;        // T = kBlock * R, rows per block
  int nd;          // diagonals
  int bits;        // 32 or 64: index arithmetic
  long long lo;    // least offset
  long long hi;    // greatest offset
  long long off[kMaxDiags];    // offsets, in accumulation order
};
constexpr int kPlanHead = 4;

// one row, every diagonal checked: the head, ragged and unaligned tiles
template <typename PT, typename XT, typename AT, typename I>
__device__ __forceinline__ AT row_checked(const DiaPlan& pl,
                                          const PT* __restrict__ planes,
                                          I pn, const XT* __restrict__ x,
                                          I gp, I n, I i) {
  AT acc = AT(0);
  for (int d = 0; d < pl.nd; ++d) {
    const I j = i + static_cast<I>(pl.off[d]);
    if (j >= 0 && j < n) {
      acc = acc + static_cast<AT>(ld(planes[static_cast<I>(d) * pn + gp + i])) *
                      static_cast<AT>(ld(x[gp + j]));
    }
  }
  return acc;
}

// v[0..N) = p[ph..ph + N) for p 16-byte aligned, 0 < ph < N: the two
// vectors around the values and a funnel shift (a plane row that starts
// off x's 16-byte phase)
template <typename T, int N>
__device__ __forceinline__ void ldv_shifted(const T* p, int ph, T (&v)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte vector");
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 u = shift16(__ldcs(q), __ldcs(q + 1),
                          ph * static_cast<int>(sizeof(T)));
  memcpy(v, &u, 16);
}

template <typename PT, typename XT, typename AT, typename I, bool DOT>
__global__ void __launch_bounds__(kBlock)
dia_spmv_kernel(const __grid_constant__ DiaPlan pl,
                const PT* __restrict__ planes, long long n_,
                const XT* __restrict__ x, XT* __restrict__ y,
                AT* __restrict__ part, int vec_ok) {
  constexpr int R = 16 / static_cast<int>(sizeof(PT));
  constexpr int T = kBlock * R;

  const I n = static_cast<I>(n_);
  const I p = static_cast<I>(blockIdx.y);
  const I gp = p * n;                              // the part's first row
  const I pn = static_cast<I>(gridDim.y) * n;      // plane row stride
  // rows before the part's first 16-byte-aligned group of x
  const I h = vec_ok ? mod_pos<I>(-gp, R) : I(0);
  const I t0 = h + static_cast<I>(blockIdx.x) * T;
  const I i = t0 + static_cast<I>(threadIdx.x) * R;
  // an interior tile: whole, and every diagonal's columns inside the part
  const bool interior = vec_ok && t0 + T <= n &&
                        t0 + static_cast<I>(pl.lo) >= 0 &&
                        t0 + T - 1 + static_cast<I>(pl.hi) < n;
  AT prod = AT(0);

  // the head: rows [0, h) of the part, one per thread of block 0
  if (blockIdx.x == 0 && static_cast<I>(threadIdx.x) < h &&
      static_cast<I>(threadIdx.x) < n) {
    const I r = static_cast<I>(threadIdx.x);
    const AT a = row_checked<PT, XT, AT, I>(pl, planes, pn, x, gp, n, r);
    st(&y[gp + r], a);
    if (DOT) prod = a * static_cast<AT>(ld(x[gp + r]));
  }

  if (interior) {
    // no bounds checks: R rows, each diagonal one 16-byte plane vector
    AT acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = AT(0);
#pragma unroll 4
    for (int d = 0; d < pl.nd; ++d) {
      const I o = static_cast<I>(pl.off[d]);
      // plane row d starts d * P * n values in: its phase against x's
      const int ph = static_cast<int>((static_cast<I>(d) * pn) & (R - 1));
      const PT* prow = planes + static_cast<I>(d) * pn + gp + i;
      PT pv[R];
      if (ph == 0) {
        ldv<true>(prow, pv);
      } else {
        ldv_shifted(prow - ph, ph, pv);
      }
      XT xv[R];
      const XT* xs = x + gp + i + o;
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = __ldg(xs + r);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = acc[r] + static_cast<AT>(ld(pv[r])) *
                              static_cast<AT>(ld(xv[r]));
      }
    }
    XT yv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) st(&yv[r], acc[r]);
    stv(y + gp + i, yv);
    if (DOT) {
      XT xs[R];
      ldv<false>(x + gp + i, xs);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        prod = prod + acc[r] * static_cast<AT>(ld(xs[r]));
      }
    }
  } else {
    // edge, ragged or unaligned tiles: one row at a time, checked
    for (int r = 0; r < R; ++r) {
      const I row = i + r;
      if (row >= n) break;
      const AT a = row_checked<PT, XT, AT, I>(pl, planes, pn, x, gp, n, row);
      st(&y[gp + row], a);
      if (DOT) prod = prod + a * static_cast<AT>(ld(x[gp + row]));
    }
  }
  if (DOT) {
    prod = block_sum(prod);
    if (threadIdx.x == 0) part[blockIdx.x] = prod;
  }
}

template <typename PT, typename XT, typename AT, typename I>
int launch_typed(const DiaPlan& pl, const void* planes, int nparts,
                 long long n, const void* x, void* y, void* part, void* dot,
                 cudaStream_t s) {
  const long long T = pl.tile;
  const unsigned int nblk = static_cast<unsigned int>((n + T - 1) / T);
  const dim3 grid(nblk, static_cast<unsigned int>(nparts));
  const int vec_ok = ((reinterpret_cast<uintptr_t>(planes) |
                       reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const PT* p = static_cast<const PT*>(planes);
  const XT* xx = static_cast<const XT*>(x);
  XT* yy = static_cast<XT*>(y);
  if (dot == nullptr) {
    dia_spmv_kernel<PT, XT, AT, I, false><<<grid, kBlock, 0, s>>>(
        pl, p, n, xx, yy, nullptr, vec_ok);
  } else {
    dia_spmv_kernel<PT, XT, AT, I, true><<<grid, kBlock, 0, s>>>(
        pl, p, n, xx, yy, static_cast<AT*>(part), vec_ok);
    reduce_partials<AT>(static_cast<AT*>(part), nblk, static_cast<AT*>(dot),
                        s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename PT, typename XT, typename AT>
int launch(const DiaPlan& pl, const void* planes, int nparts, long long n,
           const void* x, void* y, void* part, void* dot, cudaStream_t s) {
  if (dot != nullptr && nparts != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int R = 16 / static_cast<int>(sizeof(PT));
  if (pl.rows != R || pl.tile != kBlock * R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pl.bits == 32)
    return launch_typed<PT, XT, AT, int>(pl, planes, nparts, n, x, y, part,
                                         dot, s);
  return launch_typed<PT, XT, AT, long long>(pl, planes, nparts, n, x, y,
                                             part, dot, s);
}

}  // namespace

// planes: (nd, nparts, n) contiguous; plan: the host int64 array of
// ops/kernels.py DiaTilePlan.packed() for these offsets, n, nparts and
// dtypes (rows, tile, nd, bits, then the nd offsets); x, y:
// (nparts, n); part: (ceil(n / tile),) accumulation-type scratch and
// dot: one accumulation-type value, both ignored when dot is null (the
// dot needs nparts == 1).  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int acg_dia_spmv(int ptype, int xtype, const void* planes,
                            const long long* plan, int nparts, long long n,
                            const void* x, void* y, void* part, void* dot,
                            void* stream) {
  if (n <= 0 || nparts <= 0) return 0;
  if (nparts > 65535) return static_cast<int>(cudaErrorInvalidValue);
  DiaPlan pl;
  pl.rows = static_cast<int>(plan[0]);
  pl.tile = static_cast<int>(plan[1]);
  pl.nd = static_cast<int>(plan[2]);
  pl.bits = static_cast<int>(plan[3]);
  if (pl.nd < 1 || pl.nd > kMaxDiags || (pl.bits != 32 && pl.bits != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pl.lo = pl.hi = plan[kPlanHead];
  for (int d = 0; d < pl.nd; ++d) {
    pl.off[d] = plan[kPlanHead + d];
    pl.lo = pl.off[d] < pl.lo ? pl.off[d] : pl.lo;
    pl.hi = pl.off[d] > pl.hi ? pl.off[d] : pl.hi;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptype == ACG_F64 && xtype == ACG_F64)
    return launch<double, double, double>(pl, planes, nparts, n, x, y, part,
                                          dot, s);
  if (ptype == ACG_F32 && xtype == ACG_F32)
    return launch<float, float, float>(pl, planes, nparts, n, x, y, part,
                                       dot, s);
  if (ptype == ACG_BF16 && xtype == ACG_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, float>(pl, planes, nparts, n,
                                                       x, y, part, dot, s);
  if (ptype == ACG_BF16 && xtype == ACG_F32)
    return launch<__nv_bfloat16, float, float>(pl, planes, nparts, n, x, y,
                                               part, dot, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
