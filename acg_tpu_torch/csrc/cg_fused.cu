// K3 and K4: the two streamed passes of the fused classic-CG iteration.
//
// K3, phase A -- replaces acg_tpu/ops/pallas_kernels.py: cg_phase_a
// (pallas_call at :572):
//   beta = gamma / gamma_prev          (gamma_prev = inf gives beta = 0)
//   p    = r + beta * p_old
//   t    = A p                          (DIA planes, as K1)
//   (p, t)
// The TPU kernel folds the p update into the SpMV's halo windows: p is
// recomputed over each VMEM window of r and p_old.  Here each thread
// recomputes, in registers, the shifted p values its rows need from r
// and p_old, once per (offset, row), with the rounding of the stored p
// (reusing its own p for the offsets 0 and +-1 timed no faster).
// beta is read from device scalars, so no host sync sits between
// iterations.
// Bound on an H100: memory, (D + 4) * N * itemsize bytes -- D planes, r
// and p_old read, p and t written -- at 3.35 TB/s (flagship f32:
// ~151 MB -> ~45 us; bf16 ~22 us).  The first design (one row a thread,
// a scalar load of every plane value, two scalar loads behind a bounds
// check for each shifted p value) was bound by latency and instruction
// issue, not bytes: bf16 took barely less than f32 although it moves
// half the bytes.  So phase A takes K1's structure:
//  - each thread owns R = 16 / sizeof(plane) rows (4 f32, 8 bf16 and
//    mixed), a block a tile of 256 R rows; every plane value arrives in
//    a 16-byte load with the streaming hint;
//  - at each offset, r and p_old arrive as 16-byte vectors (two of them
//    for f32 vectors under bf16 planes), funnel-shifted out of the
//    aligned vectors around them where the offset or a plane row sits
//    off the 16-byte phase (ldv_any); p and t leave in 16-byte stores;
//  - interior tiles (whole, aligned, every offset's columns inside
//    [0, N)) run the offset loop with no check and no branch; the
//    ragged last tile, tiles within max |offset| rows of an end and
//    pointers off 16 bytes run one row at a time with checks;
//  - the offsets are read from the device into shared memory; the plan
//    (ops/kernels.py dia_tile_plan: R, the tile, the index width) comes
//    from Python, 32-bit indices while nd * N and the offsets fit.
// The dot stays a per-block partial, folded by a second one-block launch
// in a fixed order (folding in the launch's last block, behind an
// integer ticket and a __threadfence, timed slower on the H100).  On an
// H100 80GB HBM3 (700 W) phase A moves its bytes at K1's rate; the
// fold's launch (~4 us) is most of what is left.
//
// K4, phase B -- replaces acg_tpu/ops/pallas_kernels.py: cg_phase_b
// (pallas_call at :627):
//   alpha = gamma / (p, t);  x += alpha p;  r -= alpha t;  gamma' = (r, r)
// updating x and r in place.  Bound: memory, 6 * N * itemsize bytes
// (x, p, r, t read; x, r written; flagship f32: ~101 MB -> ~30 us; bf16
// ~15 us).  The first design (one row a thread, scalar 2- or 4-byte
// loads and stores, a block sum for every 256 rows) was bound by
// latency and instruction issue: bf16 took 87 % of f32's time for half
// the bytes.  So phase B takes phase A's structure, with no offsets:
//  - each thread owns R = 16 / sizeof(vector) rows (4 f32, 8 bf16), a
//    block a tile of 256 R rows, so one partial of (r, r) a tile;
//  - x, p, r and t arrive as 16-byte loads, x and r leave as 16-byte
//    stores; x and r, written back in place, through plain loads, p
//    through the read-only path (the next phase A reads it again as
//    p_old), t with the streaming hint (phase B is its last reader);
//  - whole tiles with all four pointers 16-byte aligned run with no
//    check and no branch; the ragged last tile and any call with a
//    pointer off 16 bytes run one row at a time with checks;
//  - a false live flag (uniform over the launch) skips the x, p and t
//    loads and every store.
//
// Scalars are f32 as on the TPU (gamma, gamma_prev, (p, t) and gamma'
// are one-element f32 device tensors).  Vectors are f32 or bf16 and the
// planes f32 or bf16; arithmetic is in f32 with each vector rounded once
// on store (the TPU kernels instead cast beta/alpha to a bf16 vector
// dtype and round every operation there -- for f32 the two agree
// bitwise).  Phase A accumulates t over the offsets in the planes'
// order, so p and t are bitwise-equal to the plain version.  The dots
// are summed per block and folded by one block in a fixed order.
//
// `live` (a one-byte device flag, or null for always) freezes a
// converged solve without a host branch: phase A then takes p = p_old,
// and phase B writes nothing (its gamma' is recomputed from the
// unchanged r, so it equals the frozen gamma bitwise).
#include "common.cuh"

namespace {

// p at row j in f32: r[j] + beta p_old[j] rounded as its store rounds
// it, or p_old[j] in a frozen solve
template <typename VT>
__device__ __forceinline__ float p_at(bool on, float beta, VT rj, VT pj,
                                      const VT* tag) {
  return on ? rnd(ld(rj) + beta * ld(pj), tag) : ld(pj);
}

template <typename PT, typename VT, typename I>
__global__ void __launch_bounds__(kBlock)
cg_phase_a_kernel(const PT* __restrict__ planes,
                  const long long* __restrict__ offs, int nd, long long n_,
                  const VT* __restrict__ r, const VT* __restrict__ p_old,
                  const float* __restrict__ gamma,
                  const float* __restrict__ gamma_prev,
                  const unsigned char* __restrict__ live,
                  VT* __restrict__ p, VT* __restrict__ t,
                  float* __restrict__ part, int vec_ok) {
  constexpr int R = 16 / static_cast<int>(sizeof(PT));
  constexpr int T = kBlock * R;
  __shared__ I soff[kMaxDiags];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    soff[d] = static_cast<I>(offs[d]);
  }
  __syncthreads();
  I lo = soff[0];
  I hi = soff[0];
  for (int d = 1; d < nd; ++d) {
    lo = soff[d] < lo ? soff[d] : lo;
    hi = soff[d] > hi ? soff[d] : hi;
  }
  const I n = static_cast<I>(n_);
  const bool on = live == nullptr || live[0] != 0;
  const float beta = *gamma / *gamma_prev;
  const I t0 = static_cast<I>(blockIdx.x) * T;
  const I i = t0 + static_cast<I>(threadIdx.x) * R;
  const bool interior = vec_ok && t0 + T <= n && t0 + lo >= 0 &&
                        t0 + T - 1 + hi < n;
  float prod = 0.0f;
  if (interior) {
    // the thread's own p, then t over the offsets with no checks
    float pc[R];
    {
      VT rv[R], pv[R];
      ldv<false>(r + i, rv);
      ldv<false>(p_old + i, pv);
#pragma unroll
      for (int k = 0; k < R; ++k) pc[k] = p_at(on, beta, rv[k], pv[k], p);
    }
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.0f;
#pragma unroll 1
    for (int d = 0; d < nd; ++d) {
      const I o = soff[d];
      PT pl[R];
      VT rv[R], pv[R];
      ldv_any<true>(planes + static_cast<I>(d) * n + i, pl);
      ldv_any<false>(r + i + o, rv);
      ldv_any<false>(p_old + i + o, pv);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] = acc[k] + ld(pl[k]) * p_at(on, beta, rv[k], pv[k], p);
      }
    }
    VT pw[R], tw[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      st(&pw[k], pc[k]);
      st(&tw[k], acc[k]);
      prod = prod + acc[k] * pc[k];
    }
    stv(p + i, pw);
    stv(t + i, tw);
  } else {
    // edge, ragged or unaligned tiles: one row at a time, checked
    for (int k = 0; k < R; ++k) {
      const I row = i + k;
      if (row >= n) break;
      float acc = 0.0f;
      for (int d = 0; d < nd; ++d) {
        const I j = row + soff[d];
        if (j >= 0 && j < n) {
          acc = acc + ld(planes[static_cast<I>(d) * n + row]) *
                          p_at(on, beta, r[j], p_old[j], p);
        }
      }
      const float pi = p_at(on, beta, r[row], p_old[row], p);
      st(&p[row], pi);
      st(&t[row], acc);
      prod = prod + acc * pi;
    }
  }
  prod = block_sum(prod);
  if (threadIdx.x == 0) part[blockIdx.x] = prod;
}

template <typename VT>
__global__ void __launch_bounds__(kBlock)
cg_phase_b_kernel(long long n, VT* __restrict__ x, const VT* __restrict__ p,
                  VT* __restrict__ r, const VT* __restrict__ t,
                  const float* __restrict__ gamma,
                  const float* __restrict__ pdott,
                  const unsigned char* __restrict__ live,
                  float* __restrict__ part, int vec_ok) {
  constexpr int R = 16 / static_cast<int>(sizeof(VT));
  constexpr long long T = kBlock * R;
  const bool on = live == nullptr || live[0] != 0;
  const float alpha = *gamma / *pdott;
  const long long t0 = static_cast<long long>(blockIdx.x) * T;
  const long long i = t0 + static_cast<long long>(threadIdx.x) * R;
  float prod = 0.0f;
  if (vec_ok && t0 + T <= n) {
    VT rv[R];
    ldv_rw(r + i, rv);
    if (on) {
      VT xv[R], pv[R], tv[R];
      ldv_rw(x + i, xv);
      ldv<false>(p + i, pv);
      ldv<true>(t + i, tv);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        st(&xv[k], ld(xv[k]) + alpha * ld(pv[k]));
        st(&rv[k], ld(rv[k]) - alpha * ld(tv[k]));
      }
      stv(x + i, xv);
      stv(r + i, rv);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) prod = prod + ld(rv[k]) * ld(rv[k]);
  } else {
    // the ragged last tile, or a pointer off 16 bytes: row by row
    for (int k = 0; k < R; ++k) {
      const long long row = i + k;
      if (row >= n) break;
      float rn = ld(r[row]);
      if (on) {
        st(&x[row], ld(x[row]) + alpha * ld(p[row]));
        rn = rnd(rn - alpha * ld(t[row]), r);
        st(&r[row], rn);
      }
      prod = prod + rn * rn;
    }
  }
  prod = block_sum(prod);
  if (threadIdx.x == 0) part[blockIdx.x] = prod;
}

template <typename PT, typename VT, typename I>
int launch_a(const void* planes, const void* offs, int nd, long long n,
             const void* r, const void* p_old, const void* gamma,
             const void* gamma_prev, const void* live, void* p, void* t,
             void* part, void* out, cudaStream_t s) {
  constexpr long long T = kBlock * (16 / static_cast<int>(sizeof(PT)));
  const unsigned int grid = static_cast<unsigned int>((n + T - 1) / T);
  const int vec_ok = ((reinterpret_cast<uintptr_t>(planes) |
                       reinterpret_cast<uintptr_t>(r) |
                       reinterpret_cast<uintptr_t>(p_old) |
                       reinterpret_cast<uintptr_t>(p) |
                       reinterpret_cast<uintptr_t>(t)) & 15) == 0;
  cg_phase_a_kernel<PT, VT, I><<<grid, kBlock, 0, s>>>(
      static_cast<const PT*>(planes), static_cast<const long long*>(offs),
      nd, n, static_cast<const VT*>(r), static_cast<const VT*>(p_old),
      static_cast<const float*>(gamma), static_cast<const float*>(gamma_prev),
      static_cast<const unsigned char*>(live), static_cast<VT*>(p),
      static_cast<VT*>(t), static_cast<float*>(part), vec_ok);
  reduce_partials<float>(static_cast<float*>(part), grid,
                         static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT, typename VT>
int launch_a_plan(int rows, int bits, const void* planes, const void* offs,
                  int nd, long long n, const void* r, const void* p_old,
                  const void* gamma, const void* gamma_prev,
                  const void* live, void* p, void* t, void* part, void* out,
                  cudaStream_t s) {
  if (rows != 16 / static_cast<int>(sizeof(PT))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bits == 32)
    return launch_a<PT, VT, int>(planes, offs, nd, n, r, p_old, gamma,
                                 gamma_prev, live, p, t, part, out, s);
  return launch_a<PT, VT, long long>(planes, offs, nd, n, r, p_old, gamma,
                                     gamma_prev, live, p, t, part, out, s);
}

template <typename VT>
int launch_b(int rows, long long n, void* x, const void* p, void* r,
             const void* t, const void* gamma, const void* pdott,
             const void* live, void* part, void* out, cudaStream_t s) {
  constexpr int R = 16 / static_cast<int>(sizeof(VT));
  if (rows != R) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid =
      static_cast<unsigned int>((n + kBlock * R - 1) / (kBlock * R));
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(p) |
                       reinterpret_cast<uintptr_t>(r) |
                       reinterpret_cast<uintptr_t>(t)) & 15) == 0;
  cg_phase_b_kernel<VT><<<grid, kBlock, 0, s>>>(
      n, static_cast<VT*>(x), static_cast<const VT*>(p), static_cast<VT*>(r),
      static_cast<const VT*>(t), static_cast<const float*>(gamma),
      static_cast<const float*>(pdott),
      static_cast<const unsigned char*>(live), static_cast<float*>(part),
      vec_ok);
  reduce_partials<float>(static_cast<float*>(part), grid,
                         static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Phase A.  planes (nd, n), offs (nd,) int64, r, p_old, p, t (n,);
// gamma, gamma_prev, out: one f32 each; live: one byte or null; rows and
// bits: the plan's rows a thread (16 / sizeof(plane)) and index width
// (ops/kernels.py dia_tile_plan); part: (plan nblocks,) f32 scratch.
// out <- (p, t).
extern "C" int acg_cg_phase_a(int ptype, int vtype, const void* planes,
                              const void* offs, int nd, long long n,
                              int rows, int bits, const void* r,
                              const void* p_old, const void* gamma,
                              const void* gamma_prev, const void* live,
                              void* p, void* t, void* part, void* out,
                              void* stream) {
  if (n <= 0 || nd < 1 || nd > kMaxDiags || (bits != 32 && bits != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptype == ACG_F32 && vtype == ACG_F32)
    return launch_a_plan<float, float>(rows, bits, planes, offs, nd, n, r,
                                       p_old, gamma, gamma_prev, live, p, t,
                                       part, out, s);
  if (ptype == ACG_BF16 && vtype == ACG_F32)
    return launch_a_plan<__nv_bfloat16, float>(rows, bits, planes, offs, nd,
                                               n, r, p_old, gamma,
                                               gamma_prev, live, p, t, part,
                                               out, s);
  if (ptype == ACG_BF16 && vtype == ACG_BF16)
    return launch_a_plan<__nv_bfloat16, __nv_bfloat16>(
        rows, bits, planes, offs, nd, n, r, p_old, gamma, gamma_prev, live,
        p, t, part, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Phase B.  x, r updated in place; p, t read; gamma, pdott, out: one f32
// each; live: one byte or null; rows: the plan's rows a thread (16 /
// sizeof(vector), ops/kernels.py cg_phase_b_plan); part: (plan nblocks,)
// f32 scratch.  out <- (r, r).
extern "C" int acg_cg_phase_b(int vtype, long long n, int rows, void* x,
                              const void* p, void* r, const void* t,
                              const void* gamma, const void* pdott,
                              const void* live, void* part, void* out,
                              void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vtype == ACG_F32)
    return launch_b<float>(rows, n, x, p, r, t, gamma, pdott, live, part,
                           out, s);
  if (vtype == ACG_BF16)
    return launch_b<__nv_bfloat16>(rows, n, x, p, r, t, gamma, pdott, live,
                                   part, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
