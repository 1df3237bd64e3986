// K5: the Ghysels-Vanroose 6-vector update of pipelined CG, one pass:
//   z = q + beta z;  t = w + beta t;  p = r + beta p
//   x = x + alpha p; r = r - alpha t; w = w - alpha z
//
// Replaces acg_tpu/ops/pallas_kernels.py: fused_pipelined_update
// (pallas_call at :676).  The JAX solver keeps this update in XLA, which
// fuses it with the next iteration's dots; eager PyTorch has no such
// fusion, and as plain ops the update is 12 elementwise launches moving
// ~30 vector passes, against the 13 passes (7 reads, 6 writes) of this
// kernel.  So the port's pipelined loop calls it on CUDA.
//
// It computes what the JAX loop body computes (solvers/jax_cg.py:963-973),
// not the standalone TPU kernel: alpha and beta stay in the accumulation
// type (double for f64, float for f32 and bf16) and each output is
// rounded once on store; x, r and w take the rounded p, t and z.
// Updates x, r, w, p, t, z in place.  `live` (one byte, or null for
// always) set to 0 leaves all six untouched -- the frozen state of a
// converged solve, without a host branch.  `bad` (one byte, or null:
// the breakdown flag of a detecting loop, solvers/jax_cg.py:866-875)
// set to 1 writes back the old x, r and w (p, t and z still update, as
// the JAX body's `where(bad, old, new)` leaves them): a select, never a
// zeroed alpha, since NaN * 0 is NaN.
//
// Bound on an H100: memory, 13 * N * itemsize bytes at 3.35 TB/s
// (flagship f64: ~436 MB -> ~130 us); one thread per row, all loads
// coalesced.
#include "common.cuh"

namespace {

template <typename VT, typename AT>
__global__ void __launch_bounds__(kBlock)
pipelined_update_kernel(long long n, VT* __restrict__ x, VT* __restrict__ r,
                        VT* __restrict__ w, VT* __restrict__ p,
                        VT* __restrict__ t, VT* __restrict__ z,
                        const VT* __restrict__ q, const AT* __restrict__ alpha,
                        const AT* __restrict__ beta,
                        const unsigned char* __restrict__ live,
                        const unsigned char* __restrict__ bad) {
  if (live != nullptr && live[0] == 0) return;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const AT a = *alpha;
  const AT b = *beta;
  const AT xi = ld(x[i]), ri = ld(r[i]), wi = ld(w[i]);
  const AT zn = rnd(static_cast<AT>(ld(q[i])) + b * ld(z[i]), z);
  const AT tn = rnd(wi + b * ld(t[i]), t);
  const AT pn = rnd(ri + b * ld(p[i]), p);
  if (bad != nullptr && bad[0] != 0) {
    // the loads round-trip exactly: the old values, bit for bit
    st(&x[i], xi);
    st(&r[i], ri);
    st(&w[i], wi);
  } else {
    st(&x[i], xi + a * pn);
    st(&r[i], ri - a * tn);
    st(&w[i], wi - a * zn);
  }
  st(&p[i], pn);
  st(&t[i], tn);
  st(&z[i], zn);
}

template <typename VT, typename AT>
int launch(long long n, void* x, void* r, void* w, void* p, void* t, void* z,
           const void* q, const void* alpha, const void* beta,
           const void* live, const void* bad, cudaStream_t s) {
  pipelined_update_kernel<VT, AT><<<row_blocks(n), kBlock, 0, s>>>(
      n, static_cast<VT*>(x), static_cast<VT*>(r), static_cast<VT*>(w),
      static_cast<VT*>(p), static_cast<VT*>(t), static_cast<VT*>(z),
      static_cast<const VT*>(q), static_cast<const AT*>(alpha),
      static_cast<const AT*>(beta), static_cast<const unsigned char*>(live),
      static_cast<const unsigned char*>(bad));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r, w, p, t, z (n,) updated in place, q (n,) read; alpha, beta: one
// accumulation-type value each (double for f64 vectors, float otherwise);
// live, bad: one byte each or null.
extern "C" int acg_pipelined_update(int vtype, long long n, void* x, void* r,
                                    void* w, void* p, void* t, void* z,
                                    const void* q, const void* alpha,
                                    const void* beta, const void* live,
                                    const void* bad, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vtype == ACG_F64)
    return launch<double, double>(n, x, r, w, p, t, z, q, alpha, beta, live,
                                  bad, s);
  if (vtype == ACG_F32)
    return launch<float, float>(n, x, r, w, p, t, z, q, alpha, beta, live,
                                bad, s);
  if (vtype == ACG_BF16)
    return launch<__nv_bfloat16, float>(n, x, r, w, p, t, z, q, alpha, beta,
                                        live, bad, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
