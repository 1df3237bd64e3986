"""Mixed-precision iterative refinement: f64 accuracy from f32 solves.

The counterpart of ``acg_tpu/solvers/refine.py``:

    repeat (outer, on the host, numpy f64):
        r = b - A x                 # true f64 residual (scipy SpMV)
        solve A dx = r on the card in the inner solver's dtype, to a
                                    # loose inner tolerance
        x += dx
    until ||r|| / ||r0|| < rtol, the passes stall, or the budget is spent

Each outer pass cuts the error by about the inner solve's relative
accuracy, so a few passes reach 1e-12 with f32 inner solves.  The outer
SpMV uses the host CSR the CLI already builds.
"""

from __future__ import annotations

import time

import numpy as np

from acg_tpu_torch.errors import NotConvergedError
from acg_tpu_torch.solvers.stats import SolverStats, StoppingCriteria


class RefinedSolver:
    """Iterative refinement around any inner solver with a
    ``solve(b, x0=None, criteria=..., raise_on_divergence=..., warmup=...)``
    method (:class:`~acg_tpu_torch.solvers.cg.TorchCGSolver` or
    :class:`~acg_tpu_torch.parallel.dist.DistCGSolver`).

    ``inner_rtol`` is each pass's relative tolerance; ``inner_maxits``
    caps each pass (default: the remaining budget).  The statistics hold
    the total inner iterations, and ``stats.nrefine`` counts the outer
    passes.  ``full_csr`` may be a callable ``matvec(x) -> A @ x`` in f64
    instead (then pass ``n``, and ``nnz`` for the flop count)."""

    def __init__(self, inner, full_csr, inner_rtol: float = 1e-5,
                 inner_maxits: int | None = None, n: int | None = None,
                 nnz: int | None = None):
        self.inner = inner
        if callable(full_csr) and not hasattr(full_csr, "shape"):
            if n is None:
                raise ValueError("matvec form needs n")
            self._matvec = full_csr
            self._n = int(n)
            self._nnz2 = 2.0 * (nnz or 0)
        else:
            self.csr = full_csr
            self._matvec = full_csr.__matmul__
            self._n = full_csr.shape[0]
            self._nnz2 = 2.0 * full_csr.nnz
        self.inner_rtol = float(inner_rtol)
        self.inner_maxits = inner_maxits
        self.stats = SolverStats(unknowns=self._n)
        self.stats.nrefine = 0

    def solve(self, b, x0=None, criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True,
              warmup: int = 0) -> np.ndarray:
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        b = np.asarray(b, dtype=np.float64)
        x = (np.zeros_like(b) if x0 is None
             else np.asarray(x0, dtype=np.float64).copy())

        if warmup > 0:
            # warm the inner solver outside the timed region, with a
            # residual tolerance like the real passes
            self.inner.solve(b, x0=None, criteria=StoppingCriteria(
                maxits=1, residual_rtol=self.inner_rtol),
                raise_on_divergence=False, warmup=warmup - 1)
            warmup = 0
        t0 = time.perf_counter()
        r = b - self._matvec(x)
        r0nrm2 = float(np.linalg.norm(r))
        st.bnrm2 = float(np.linalg.norm(b))
        st.x0nrm2 = float(np.linalg.norm(x))
        st.r0nrm2 = r0nrm2
        res_tol = max(crit.residual_atol, crit.residual_rtol * r0nrm2)
        # no residual target: spend the budget and report converged, as
        # the direct solvers do (diff criteria mean nothing across passes)
        unbounded = res_tol <= 0

        total_inner = 0
        npasses = 0
        rnrm2 = r0nrm2
        stalled = False
        inner_flops0 = self.inner.stats.nflops
        converged = (not unbounded) and rnrm2 < res_tol
        # 40 passes is far beyond any f64 target; a diverging or stalled
        # pass ends the loop earlier
        while not converged and not stalled and npasses < 40 \
                and total_inner < crit.maxits:
            budget = crit.maxits - total_inner
            inner_crit = StoppingCriteria(
                maxits=min(self.inner_maxits or budget, budget),
                residual_rtol=self.inner_rtol)
            dx = self.inner.solve(r, criteria=inner_crit,
                                  raise_on_divergence=False, warmup=warmup)
            warmup = 0
            x_prev, rnrm2_prev = x, rnrm2
            x = x + np.asarray(dx, np.float64)
            npasses += 1
            total_inner += self.inner.stats.niterations
            r = b - self._matvec(x)
            rnrm2 = float(np.linalg.norm(r))
            if rnrm2 > rnrm2_prev:
                # a diverging pass: keep the better iterate, so the
                # reported residual describes the returned solution
                x, rnrm2 = x_prev, rnrm2_prev
                stalled = True
            elif rnrm2 >= 0.5 * rnrm2_prev:
                stalled = True  # the inner accuracy is exhausted
            converged = (not unbounded) and rnrm2 < res_tol

        if unbounded:
            converged = True

        st.tsolve += time.perf_counter() - t0
        st.nsolves += 1
        st.nrefine = npasses
        st.niterations = total_inner
        st.ntotaliterations += total_inner
        st.rnrm2 = rnrm2
        st.dxnrm2 = float("inf")
        st.converged = bool(converged)
        st.nflops += (self.inner.stats.nflops - inner_flops0
                      + self._nnz2 * npasses)
        st.fexcept_arrays = [x]
        if not converged and raise_on_divergence:
            raise NotConvergedError(
                f"refinement stalled after {npasses} passes "
                f"({total_inner} inner iterations), residual {rnrm2:.3e}")
        return x
