"""Host reference CG solvers (numpy, float64): the correctness oracles.

A copy of ``acg_tpu/solvers/host_cg.py`` (the reference's textbook host
solver ``acg/cg.c``), with the same numpy arithmetic op for op, so x and
the statistics come out bitwise-equal to the JAX package's:

* :class:`HostCGSolver` -- serial CG (PCG under ``precond``, through
  :class:`~acg_tpu_torch.precond.HostPrecond`), all four stopping
  criteria, the update order of ``acgsolver_solve`` (``cg.c:198-407``):

      r0 = b - A x0;  p = r;  gamma = (r,r)
      repeat:  t = A p
               alpha = gamma / (p,t)
               x += alpha p;  r -= alpha t
               gamma' = (r,r);  beta = gamma'/gamma;  p = r + beta p

* :class:`NativeHostCGSolver` -- the same recurrence in the native C++
  core (``native/src/cg.cpp``, :mod:`acg_tpu_torch._native`).
* :class:`HostDistCGSolver` -- the multi-part host CG over subdomains
  (``acgsolver_solvempi``, ``cg.c:408``).
* :func:`host_batched_cg` / :func:`host_block_cg` -- the eager
  multi-RHS oracles of the batched tier.

They compute on the host by definition: no device array is involved.
``HostCGSolver`` records its convergence trace through
:class:`~acg_tpu_torch.telemetry.EagerTraceRecorder` (``trace``) and
prints the heartbeat line (``progress``).  The JAX package's recovery,
health and checkpoint hooks come with the robustness modules; until
then the port refuses them by name.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from acg_tpu_torch import metrics, observatory
from acg_tpu_torch.errors import IndefiniteMatrixError, NotConvergedError
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.solvers.stats import (SolverStats, StoppingCriteria,
                                         cg_flops_per_iteration)
from acg_tpu_torch.telemetry import EagerTraceRecorder, add_timing

# the hooks of the JAX package's HostCGSolver the port does not have
# yet, and the modules they come with
_LATER_HOOKS = {"recovery": "robustness (solvers/resilience.py)",
                "health": "robustness (health.py)",
                "ckpt": "robustness (checkpoint.py)"}


def as_csr(A: SymCsrMatrix | sp.spmatrix,
           epsilon: float = 0.0) -> sp.csr_matrix:
    """Normalise a solver matrix argument to scipy CSR with the
    ``--epsilon`` diagonal shift applied (``symcsrmatrix.c:760-862``)."""
    if isinstance(A, SymCsrMatrix):
        return A.to_csr(epsilon)
    A = sp.csr_matrix(A)
    if epsilon:
        A = (A + epsilon * sp.eye(A.shape[0], format="csr")).tocsr()
    return A


class HostCGSolver:
    """Serial host CG over a :class:`SymCsrMatrix` (the ``acgsolver``
    role); ``precond`` (a :class:`~acg_tpu_torch.precond.PrecondSpec` or
    its text) makes it the eager PCG oracle.  ``trace`` (window size; 0 =
    off) records each iteration's ``(rnrm2, alpha, beta, pAp)`` into
    ``last_trace``/``stats.trace`` (under ``precond`` the rnrm2 slot is
    the preconditioned norm sqrt((r, z)), as the device rings record
    it); ``progress`` (iterations; 0 = off) prints the heartbeat line
    every that many iterations.  ``recovery``, ``health`` and ``ckpt``
    keep the JAX package's signature and are refused when given."""

    def __init__(self, A: SymCsrMatrix | sp.spmatrix, epsilon: float = 0.0,
                 recovery=None, trace: int = 0, progress: int = 0,
                 precond=None, health=None, ckpt=None):
        given = {"recovery": recovery is not None,
                 "health": health is not None, "ckpt": ckpt is not None}
        refused = [f"{k} (comes with the {_LATER_HOOKS[k]} modules)"
                   for k, on in given.items() if on]
        if refused:
            raise ValueError("HostCGSolver: not yet ported: "
                             + ", ".join(refused))
        self.trace = int(trace)
        self.progress = int(progress)
        if self.trace < 0 or self.progress < 0:
            raise ValueError("trace/progress must be >= 0 (iteration "
                             "counts; 0 disables)")
        self.last_trace = None
        self.A = as_csr(A, epsilon)
        self.n = self.A.shape[0]
        self.nnz_full = self.A.nnz
        from acg_tpu_torch.precond import parse_precond
        self.precond_spec = parse_precond(precond)
        self._mhost = None
        self.stats = SolverStats(unknowns=self.n)

    def _op(self, name, t, n_bytes, flops):
        self.stats.ops[name].add(1, t, n_bytes)
        self.stats.nflops += flops

    def solve(self, b: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        A, n = self.A, self.n
        b = np.asarray(b, dtype=np.float64)
        x = (np.array(x0, dtype=np.float64, copy=True) if x0 is not None
             else np.zeros(n))
        dbl = 8
        M = None
        if self.precond_spec is not None:
            from acg_tpu_torch.precond import (HostPrecond, bytes_per_apply,
                                               flops_per_apply, state_bytes)
            if self._mhost is None:
                self._mhost = HostPrecond(self.precond_spec, A)
            M = self._mhost
            self._mflops = flops_per_apply(self.precond_spec, self.n,
                                           3.0 * self.nnz_full)
            # kind-aware per-apply traffic (cheby streams the CSR
            # degree-many times), matching the device tiers' census
            self._mbytes = bytes_per_apply(
                self.precond_spec, self.n, 8,
                self.nnz_full * (8 + 4) + 2 * self.n * 8,
                state_bytes(M.state))

        recorder = (EagerTraceRecorder(self.trace) if self.trace
                    else None)

        def finish_trace():
            if recorder is not None:
                st.trace = self.last_trace = recorder.finish()

        tstart = time.perf_counter()
        st.bnrm2 = float(np.linalg.norm(b))
        st.x0nrm2 = float(np.linalg.norm(x))

        t0 = time.perf_counter()
        r = b - A @ x
        self._op("gemv", time.perf_counter() - t0,
                 self.nnz_full * (dbl + 4) + 2 * n * dbl,
                 3.0 * self.nnz_full)

        napply = [0]

        def papply(r):
            """One timed preconditioner apply; cheby bills its
            degree-many SpMVs per apply, as the device tiers count."""
            t0 = time.perf_counter()
            z = M.apply(r)
            napply[0] += 1
            per = (self.precond_spec.degree
                   if self.precond_spec.kind == "cheby" else 1)
            self.stats.ops["precond"].add(per, time.perf_counter() - t0,
                                          int(self._mbytes))
            self.stats.nflops += self._mflops
            return z

        if M is not None:
            z = papply(r)
            p = z.copy()
            gamma = float(r @ z)
            rr = float(r @ r)
            self._op("dot", 0.0, 2 * n * dbl, 2.0 * n)
        else:
            p = r.copy()
            gamma = rr = float(r @ r)
        self._op("copy", 0.0, 2 * n * dbl, 0.0)

        t0 = time.perf_counter()
        self._op("nrm2", time.perf_counter() - t0, n * dbl, 2.0 * n)
        st.r0nrm2 = st.rnrm2 = float(np.sqrt(rr))
        st.dxnrm2 = np.inf

        res_tol = max(crit.residual_atol,
                      crit.residual_rtol * st.r0nrm2)
        st.niterations = 0
        st.nsolves += 1
        converged = (not crit.unbounded) and self._test(crit, st, res_tol)
        k = 0

        while not converged and k < crit.maxits:
            t0 = time.perf_counter()
            t = A @ p
            self._op("gemv", time.perf_counter() - t0,
                     self.nnz_full * (dbl + 4) + 2 * n * dbl,
                     3.0 * self.nnz_full)

            t0 = time.perf_counter()
            pdott = float(p @ t)
            self._op("dot", time.perf_counter() - t0, 2 * n * dbl, 2.0 * n)
            if pdott == 0.0:
                if gamma == 0.0:
                    # r = p = 0: exactly converged (reachable in
                    # fixed-iteration mode past convergence); iterating
                    # further is a 0/0, not an indefiniteness
                    break
                # (p, Ap) == 0 for p != 0: not positive definite; abort
                # like the reference (cg.c:304) instead of dividing
                st.tsolve += time.perf_counter() - tstart
                st.converged = False
                st.fexcept_arrays = [x, r]
                # the partial window leading into the breakdown
                finish_trace()
                raise IndefiniteMatrixError(
                    f"(p, Ap) = 0 at iteration {k}")
            alpha = gamma / pdott

            t0 = time.perf_counter()
            x += alpha * p
            r -= alpha * t
            self._op("axpy", time.perf_counter() - t0, 3 * n * dbl, 2.0 * n)
            self._op("axpy", 0.0, 3 * n * dbl, 2.0 * n)

            if M is not None:
                z = papply(r)
                t0 = time.perf_counter()
                gamma_next = float(r @ z)
                rr = float(r @ r)
                self._op("dot", time.perf_counter() - t0, 2 * n * dbl,
                         2.0 * n)
                self._op("nrm2", 0.0, n * dbl, 2.0 * n)
            else:
                t0 = time.perf_counter()
                gamma_next = rr = float(r @ r)
                self._op("nrm2", time.perf_counter() - t0, n * dbl,
                         2.0 * n)
            beta = gamma_next / gamma
            gamma = gamma_next
            if crit.needs_diff:
                # ||x_{k+1} - x_k|| = |alpha| * ||p_k|| (the pre-update p)
                st.dxnrm2 = abs(alpha) * float(np.linalg.norm(p))

            t0 = time.perf_counter()
            p = (z if M is not None else r) + beta * p
            self._op("axpy", time.perf_counter() - t0, 3 * n * dbl, 2.0 * n)

            k += 1
            st.niterations = k
            st.ntotaliterations += 1
            st.rnrm2 = float(np.sqrt(rr))
            if recorder is not None:
                # under precond the rings record the preconditioned
                # norm sqrt((r, z)) in the rnrm2 slot
                gq = gamma if M is not None else rr
                recorder.record(float(np.sqrt(gq)) if gq >= 0 else gq,
                                alpha, beta, pdott)
            if self.progress and k % self.progress == 0:
                import sys

                sys.stderr.write(observatory.heartbeat_line(
                    "host-cg", k, st.rnrm2) + "\n")
            if not crit.unbounded:
                converged = self._test(crit, st, res_tol)

        t_solve = time.perf_counter() - tstart
        st.tsolve += t_solve
        add_timing(st, "solve", t_solve)
        st.converged = converged or crit.unbounded
        metrics.record_solve(t_solve, st.niterations, st.converged,
                             solver="host-cg")
        if M is not None:
            st.precond.update({"kind": str(self.precond_spec),
                               "applies": napply[0],
                               "flops_per_apply": self._mflops})
            if self.precond_spec.kind == "cheby":
                st.precond["lambda_min"] = float(M.state[0])
                st.precond["lambda_max"] = float(M.state[1])
            metrics.record_precond(
                self.precond_spec.kind,
                napply[0] * (self.precond_spec.degree
                             if self.precond_spec.kind == "cheby" else 1))
        st.fexcept_arrays = [x, r]
        finish_trace()
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{k} iterations, residual {st.rnrm2:.3e} > {res_tol:.3e}")
        return x

    @staticmethod
    def _test(crit: StoppingCriteria, st: SolverStats, res_tol: float) -> bool:
        if res_tol > 0 and st.rnrm2 < res_tol:
            return True
        if crit.diff_atol > 0 and st.dxnrm2 < crit.diff_atol:
            return True
        if (crit.diff_rtol > 0
                and st.dxnrm2 < crit.diff_rtol * max(st.x0nrm2, 1e-300)):
            return True
        return False


class NativeHostCGSolver:
    """Host CG through the native C++ core (``native/src/cg.cpp``): the
    same recurrences and stopping criteria as :class:`HostCGSolver` (the
    two oracles cross-check each other), with the OpenMP SpMV loop at C
    speed.  Raises when the native library is not available."""

    def __init__(self, A: SymCsrMatrix | sp.spmatrix, epsilon: float = 0.0):
        from acg_tpu_torch import _native

        if not _native.available():
            raise RuntimeError(
                f"native core unavailable ({_native.build_error}; it is "
                f"built from native/src with g++) -- use --solver host")
        self._native = _native
        self.A = as_csr(A, epsilon)
        self.n = self.A.shape[0]
        self.nnz_full = self.A.nnz
        self.stats = SolverStats(unknowns=self.n)

    def solve(self, b: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        A, n = self.A, self.n
        b = np.asarray(b, dtype=np.float64)

        tstart = time.perf_counter()
        (x, r, niter, rnrm2, r0nrm2, dxnrm2, converged,
         indefinite) = self._native.cg_solve(
            A.indptr, A.indices, A.data, b, x0, crit.maxits,
            crit.residual_atol, crit.residual_rtol,
            crit.diff_atol, crit.diff_rtol)
        st.tsolve += time.perf_counter() - tstart

        st.nsolves += 1
        st.niterations = niter
        st.ntotaliterations += niter
        st.bnrm2 = float(np.linalg.norm(b))
        st.x0nrm2 = float(np.linalg.norm(x0)) if x0 is not None else 0.0
        st.r0nrm2, st.rnrm2 = r0nrm2, rnrm2
        st.dxnrm2 = dxnrm2
        st.converged = converged
        dbl = 8
        st.nflops += (cg_flops_per_iteration(self.nnz_full, n) * niter
                      + 3.0 * self.nnz_full + 2.0 * n)
        st.ops["gemv"].add(niter + 1, 0.0,
                           (self.nnz_full * (dbl + 8) + 2 * n * dbl)
                           * (niter + 1))
        st.ops["dot"].add(2 * niter, 0.0, 2 * n * dbl * 2 * niter)
        st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
        # scan x AND the final residual, like HostCGSolver
        st.fexcept_arrays = [x, r]
        if indefinite:
            raise IndefiniteMatrixError(f"(p, Ap) = 0 at iteration {niter}")
        if not converged and raise_on_divergence:
            raise NotConvergedError(
                f"{niter} iterations, residual {rnrm2:.3e}")
        return x


class HostDistCGSolver:
    """Distributed host CG over subdomains (``acgsolver_solvempi``,
    ``cg.c:408``), single-controller: per-part ghost-aware
    :class:`~acg_tpu_torch.vector.PVector` BLAS-1 with reductions summed
    across parts (the ``MPI_Allreduce`` role) and the halo exchange of
    :func:`~acg_tpu_torch.graph.halo_exchange_host`.  The host oracle of
    the stacked :class:`~acg_tpu_torch.parallel.dist.DistCGSolver` -- the
    same data layout, no device."""

    def __init__(self, subs):
        self.subs = subs
        self.n = sum(s.nowned for s in subs)
        self.nnz_total = sum(int(s.A_local.nnz + s.A_ghost.nnz) for s in subs)
        self.stats = SolverStats(unknowns=self.n)

    def _spmv(self, ps):
        """Distributed SpMV: halo(p) then local + off-diagonal blocks
        (``acgsymcsrmatrix_dsymvmpi``, ``symcsrmatrix.c:1353-1397``)."""
        from acg_tpu_torch.graph import dsymv_dist_host
        return dsymv_dist_host(self.subs, [p.data for p in ps])

    def solve(self, b_global: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        from acg_tpu_torch.graph import gather_vector, scatter_vector
        from acg_tpu_torch.vector import PVector

        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        subs = self.subs
        b_global = np.asarray(b_global, dtype=np.float64)

        def pvecs(global_vec):
            return [PVector(v, s.nghost) for s, v in
                    zip(subs, scatter_vector(subs, global_vec))]

        def gdot(us, vs):
            return float(sum(u.dot(v) for u, v in zip(us, vs)))

        bs = pvecs(b_global)
        xs = pvecs(np.asarray(x0, dtype=np.float64) if x0 is not None
                   else np.zeros(self.n))

        tstart = time.perf_counter()
        st.bnrm2 = float(np.sqrt(gdot(bs, bs)))
        st.x0nrm2 = float(np.sqrt(gdot(xs, xs)))
        ts = self._spmv(xs)
        rs = [PVector(b.owned - t, 0) for b, t in zip(bs, ts)]
        ps = [PVector(np.concatenate([r.owned, np.zeros(s.nghost)]), s.nghost)
              for r, s in zip(rs, subs)]
        gamma = gdot(rs, rs)
        st.r0nrm2 = st.rnrm2 = float(np.sqrt(gamma))
        st.dxnrm2 = np.inf
        res_tol = max(crit.residual_atol, crit.residual_rtol * st.r0nrm2)
        st.niterations = 0
        st.nsolves += 1
        converged = (not crit.unbounded) and HostCGSolver._test(
            crit, st, res_tol)
        k = 0
        while not converged and k < crit.maxits:
            ts = self._spmv(ps)
            tvs = [PVector(t, 0) for t in ts]
            pdott = float(sum(np.dot(p.owned, t) for p, t in zip(ps, ts)))
            alpha = gamma / pdott
            if crit.needs_diff:
                st.dxnrm2 = abs(alpha) * float(
                    np.sqrt(gdot(ps, ps)))
            for x, r, p, t in zip(xs, rs, ps, tvs):
                x.axpy(alpha, p)
                r.axpy(-alpha, t)
            gamma_next = gdot(rs, rs)
            beta = gamma_next / gamma
            gamma = gamma_next
            for p, r in zip(ps, rs):
                p.aypx(beta, r)
            k += 1
            st.niterations = k
            st.ntotaliterations += 1
            st.rnrm2 = float(np.sqrt(gamma))
            if not crit.unbounded:
                converged = HostCGSolver._test(crit, st, res_tol)

        st.tsolve += time.perf_counter() - tstart
        st.converged = converged or crit.unbounded
        st.nflops += (3.0 * self.nnz_total + 10.0 * self.n) * max(k, 1)
        x = gather_vector(subs, [x.data for x in xs], self.n)
        st.fexcept_arrays = [x]
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{k} iterations, residual {st.rnrm2:.3e} > {res_tol:.3e}")
        return x


# -- batched/block eager oracles (the ground-truth parity targets) --------

def host_batched_cg(A, B, x0=None, criteria: StoppingCriteria | None = None
                    ) -> tuple:
    """Eager f64 multi-RHS twin of the batched device tier: the classic
    recurrence run per column (a plain numpy loop: no fusion, no masks),
    the parity target of the batched solvers.  Returns ``(X,
    niterations, rnrm2)`` with per-RHS arrays."""
    crit = criteria or StoppingCriteria()
    A = as_csr(A)
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    n, nrhs = B.shape
    X = (np.zeros((n, nrhs)) if x0 is None
         else np.array(x0, dtype=np.float64, copy=True))
    iters = np.zeros(nrhs, dtype=np.int64)
    rn = np.zeros(nrhs)
    for j in range(nrhs):
        x = X[:, j].copy()
        r = B[:, j] - A @ x
        p = r.copy()
        gamma = float(r @ r)
        res_tol = max(crit.residual_atol,
                      crit.residual_rtol * np.sqrt(gamma))
        k = 0
        while (crit.unbounded or gamma >= res_tol * res_tol) \
                and k < crit.maxits:
            t = A @ p
            alpha = gamma / float(p @ t)
            x += alpha * p
            r -= alpha * t
            gamma_next = float(r @ r)
            beta = gamma_next / gamma
            gamma = gamma_next
            p = r + beta * p
            k += 1
        X[:, j] = x
        iters[j] = k
        rn[j] = np.sqrt(gamma)
    return X, iters, rn


def host_block_cg(A, B, x0=None, criteria: StoppingCriteria | None = None
                  ) -> tuple:
    """Eager f64 block-CG oracle (O'Leary 1980): one shared Krylov block,
    B x B Gram solves per iteration, rank deflation by relative Tikhonov
    jitter -- the recurrence of the device block tier
    (:mod:`acg_tpu_torch.solvers.batched`) in plain numpy.  Returns
    ``(X, niterations, rnrm2, block_iterations)``."""
    crit = criteria or StoppingCriteria()
    A = as_csr(A)
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    n, nrhs = B.shape
    X = (np.zeros((n, nrhs)) if x0 is None
         else np.array(x0, dtype=np.float64, copy=True))
    eps = np.finfo(np.float64).eps

    def deflated_solve(M, G):
        tr = np.trace(M) / M.shape[0]
        jitter = 64.0 * eps * max(abs(tr), eps)
        return np.linalg.solve(M + jitter * np.eye(M.shape[0]), G)

    R = B - A @ X
    rr = np.einsum("nb,nb->b", R, R)
    res_tol = np.maximum(crit.residual_atol,
                         crit.residual_rtol * np.sqrt(rr))
    done = (np.zeros(nrhs, bool) if crit.unbounded
            else rr < res_tol * res_tol)
    iters = np.zeros(nrhs, dtype=np.int64)
    P = R.copy()
    G = R.T @ R
    k = 0
    while k < crit.maxits and not done.all():
        Q = A @ P
        W = P.T @ Q
        alpha = deflated_solve(W, G)
        X = X + P @ alpha
        R = R - Q @ alpha
        rr = np.einsum("nb,nb->b", R, R)
        iters += (~done).astype(np.int64)
        if not crit.unbounded:
            done = done | (~done & (rr < res_tol * res_tol))
        G_new = R.T @ R
        beta = deflated_solve(G, G_new)
        P = R + P @ beta
        G = G_new
        k += 1
    return X, iters, np.sqrt(rr), k
