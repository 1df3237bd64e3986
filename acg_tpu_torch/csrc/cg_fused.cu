// K3 and K4: the two streamed passes of the fused classic-CG iteration.
//
// K3, phase A -- replaces acg_tpu/ops/pallas_kernels.py: cg_phase_a
// (pallas_call at :572):
//   beta = gamma / gamma_prev          (gamma_prev = inf gives beta = 0)
//   p    = r + beta * p_old
//   t    = A p                          (DIA planes, as K1)
//   (p, t)
// The TPU kernel folds the p update into the SpMV's halo windows.  Here
// each thread recomputes the D shifted p values it needs as
// r[j] + beta * p_old[j] straight from global memory (L1/L2 hits for the
// stencil's near offsets); staging the window in shared memory is later
// work.  beta is read from device scalars, so no host sync sits between
// iterations.
// Bound on an H100: memory, (D + 4) * N * itemsize bytes -- D planes, r
// and p_old read, p and t written -- at 3.35 TB/s (flagship f32:
// ~151 MB -> ~45 us).
//
// K4, phase B -- replaces acg_tpu/ops/pallas_kernels.py: cg_phase_b
// (pallas_call at :627):
//   alpha = gamma / (p, t);  x += alpha p;  r -= alpha t;  gamma' = (r, r)
// updating x and r in place.  Bound: memory, 6 * N * itemsize bytes
// (x, p, r, t read; x, r written; flagship f32: ~101 MB -> ~30 us).
//
// Scalars are f32 as on the TPU (gamma, gamma_prev, (p, t) and gamma'
// are one-element f32 device tensors).  Vectors are f32 or bf16 and the
// planes f32 or bf16; arithmetic is in f32 with each vector rounded once
// on store (the TPU kernels instead cast beta/alpha to a bf16 vector
// dtype and round every operation there -- for f32 the two agree
// bitwise).  The dots are summed per block and folded by one block in a
// fixed order.
//
// `live` (a one-byte device flag, or null for always) freezes a
// converged solve without a host branch: phase A then takes p = p_old,
// and phase B writes nothing (its gamma' is recomputed from the
// unchanged r, so it equals the frozen gamma bitwise).
#include "common.cuh"

namespace {

template <typename PT, typename VT>
__global__ void __launch_bounds__(kBlock)
cg_phase_a_kernel(const PT* __restrict__ planes,
                  const long long* __restrict__ offs, int nd, long long n,
                  const VT* __restrict__ r, const VT* __restrict__ p_old,
                  const float* __restrict__ gamma,
                  const float* __restrict__ gamma_prev,
                  const unsigned char* __restrict__ live,
                  VT* __restrict__ p, VT* __restrict__ t,
                  float* __restrict__ part) {
  extern __shared__ long long soff[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) soff[d] = offs[d];
  __syncthreads();
  const bool on = live == nullptr || live[0] != 0;
  const float beta = *gamma / *gamma_prev;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  float prod = 0.0f;
  if (i < n) {
    float acc = 0.0f;
    for (int d = 0; d < nd; ++d) {
      const long long j = i + soff[d];
      if (j >= 0 && j < n) {
        const float pj = on ? rnd(ld(r[j]) + beta * ld(p_old[j]), p)
                            : ld(p_old[j]);
        acc = acc + ld(planes[d * n + i]) * pj;
      }
    }
    const float pi = on ? rnd(ld(r[i]) + beta * ld(p_old[i]), p)
                        : ld(p_old[i]);
    st(&p[i], pi);
    st(&t[i], acc);
    prod = acc * pi;
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
                  float* __restrict__ part) {
  const bool on = live == nullptr || live[0] != 0;
  const float alpha = *gamma / *pdott;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  float prod = 0.0f;
  if (i < n) {
    float rn = ld(r[i]);
    if (on) {
      st(&x[i], ld(x[i]) + alpha * ld(p[i]));
      rn = rnd(rn - alpha * ld(t[i]), r);
      st(&r[i], rn);
    }
    prod = rn * rn;
  }
  prod = block_sum(prod);
  if (threadIdx.x == 0) part[blockIdx.x] = prod;
}

template <typename PT, typename VT>
int launch_a(const void* planes, const void* offs, int nd, long long n,
             const void* r, const void* p_old, const void* gamma,
             const void* gamma_prev, const void* live, void* p, void* t,
             void* part, void* out, cudaStream_t s) {
  const unsigned int grid = row_blocks(n);
  const size_t smem = static_cast<size_t>(nd) * sizeof(long long);
  cg_phase_a_kernel<PT, VT><<<grid, kBlock, smem, s>>>(
      static_cast<const PT*>(planes), static_cast<const long long*>(offs),
      nd, n, static_cast<const VT*>(r), static_cast<const VT*>(p_old),
      static_cast<const float*>(gamma), static_cast<const float*>(gamma_prev),
      static_cast<const unsigned char*>(live), static_cast<VT*>(p),
      static_cast<VT*>(t), static_cast<float*>(part));
  reduce_partials<float>(static_cast<float*>(part), grid,
                         static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int launch_b(long long n, void* x, const void* p, void* r, const void* t,
             const void* gamma, const void* pdott, const void* live,
             void* part, void* out, cudaStream_t s) {
  const unsigned int grid = row_blocks(n);
  cg_phase_b_kernel<VT><<<grid, kBlock, 0, s>>>(
      n, static_cast<VT*>(x), static_cast<const VT*>(p), static_cast<VT*>(r),
      static_cast<const VT*>(t), static_cast<const float*>(gamma),
      static_cast<const float*>(pdott),
      static_cast<const unsigned char*>(live), static_cast<float*>(part));
  reduce_partials<float>(static_cast<float*>(part), grid,
                         static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Phase A.  planes (nd, n), offs (nd,) int64, r, p_old, p, t (n,);
// gamma, gamma_prev, out: one f32 each; live: one byte or null;
// part: (ceil(n / 256),) f32 scratch.  out <- (p, t).
extern "C" int acg_cg_phase_a(int ptype, int vtype, const void* planes,
                              const void* offs, int nd, long long n,
                              const void* r, const void* p_old,
                              const void* gamma, const void* gamma_prev,
                              const void* live, void* p, void* t, void* part,
                              void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptype == ACG_F32 && vtype == ACG_F32)
    return launch_a<float, float>(planes, offs, nd, n, r, p_old, gamma,
                                  gamma_prev, live, p, t, part, out, s);
  if (ptype == ACG_BF16 && vtype == ACG_F32)
    return launch_a<__nv_bfloat16, float>(planes, offs, nd, n, r, p_old,
                                          gamma, gamma_prev, live, p, t,
                                          part, out, s);
  if (ptype == ACG_BF16 && vtype == ACG_BF16)
    return launch_a<__nv_bfloat16, __nv_bfloat16>(planes, offs, nd, n, r,
                                                  p_old, gamma, gamma_prev,
                                                  live, p, t, part, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Phase B.  x, r updated in place; p, t read; gamma, pdott, out: one f32
// each; live: one byte or null; part: (ceil(n / 256),) f32.  out <- (r, r).
extern "C" int acg_cg_phase_b(int vtype, long long n, void* x, const void* p,
                              void* r, const void* t, const void* gamma,
                              const void* pdott, const void* live,
                              void* part, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vtype == ACG_F32)
    return launch_b<float>(n, x, p, r, t, gamma, pdott, live, part, out, s);
  if (vtype == ACG_BF16)
    return launch_b<__nv_bfloat16>(n, x, p, r, t, gamma, pdott, live, part,
                                   out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
