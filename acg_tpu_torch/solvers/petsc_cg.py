"""External cross-implementation baseline solver (the PETSc KSPCG role).

The reference ships a PETSc-backed solver (``acg/cgpetsc.c:78-378``,
SURVEY.md component #21) as an *independent oracle*: a CG implementation
nobody in this codebase wrote, run over the same matrix, to cross-check
results and performance.  The port, like the JAX package,
restores the role with ``scipy.sparse.linalg.cg`` -- an external,
independently-maintained CG (KSPCG analog; ``KSPPIPECG`` maps to the same
call, as scipy has no pipelined variant -- recorded in the stats header).

A copy of ``acg_tpu/solvers/petsc_cg.py``.  Same solve/stats contract as
:class:`acg_tpu_torch.solvers.host_cg.HostCGSolver`
so the CLI's ``--solver petsc`` slot (``cuda/acg-cuda.c:321-377``) drops in.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from acg_tpu_torch.errors import AcgError, ErrorCode, NotConvergedError
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.solvers.stats import SolverStats, StoppingCriteria


class PetscBaselineSolver:
    """scipy.sparse.linalg.cg over the assembled matrix (KSPCG analog)."""

    def __init__(self, A: SymCsrMatrix | sp.spmatrix, epsilon: float = 0.0,
                 pipelined: bool = False):
        from acg_tpu_torch.solvers.host_cg import as_csr
        self.A = as_csr(A, epsilon)
        self.n = self.A.shape[0]
        self.pipelined = pipelined  # KSPPIPECG alias; same scipy call
        self.stats = SolverStats(unknowns=self.n)

    def solve(self, b: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        crit = criteria or StoppingCriteria()
        if crit.needs_diff:
            raise AcgError(ErrorCode.INVALID_VALUE,
                           "--solver petsc supports residual criteria only "
                           "(as the reference's KSP convergence test)")
        st = self.stats
        st.criteria = crit
        A, n = self.A, self.n
        b = np.asarray(b, dtype=np.float64)
        x_init = (np.array(x0, dtype=np.float64, copy=True)
                  if x0 is not None else np.zeros(n))

        st.bnrm2 = float(np.linalg.norm(b))
        st.x0nrm2 = float(np.linalg.norm(x_init))
        r0 = b - A @ x_init
        st.r0nrm2 = float(np.linalg.norm(r0))

        # our criteria are relative to ||r0|| (cg.h:136-149); scipy's rtol
        # is relative to ||b||, so pass everything through atol
        res_tol = max(crit.residual_atol, crit.residual_rtol * st.r0nrm2)
        niters = 0

        def count(_xk):
            nonlocal niters
            niters += 1

        tstart = time.perf_counter()
        x, info = spla.cg(A, b, x0=x_init, rtol=0.0,
                          atol=res_tol if res_tol > 0 else 1e-300,
                          maxiter=crit.maxits, callback=count)
        elapsed = time.perf_counter() - tstart
        st.tsolve += elapsed

        r = b - A @ x
        st.rnrm2 = float(np.linalg.norm(r))
        st.dxnrm2 = np.inf
        st.nsolves += 1
        st.niterations = niters
        st.ntotaliterations += niters
        st.converged = (info == 0) or crit.unbounded
        # timing-only statistics, like the reference's PETSc slot
        # (KSPSolve wall time, cgpetsc.c:335-378): the analytic CG flop
        # count is real work and stays, but no per-op byte/time rows are
        # fabricated -- scipy's internals are not instrumented here
        st.nflops += (3.0 * self.A.nnz + 10.0 * n) * max(niters, 1)
        st.fexcept_arrays = [x, r]
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{niters} iterations, residual {st.rnrm2:.3e} > {res_tol:.3e}")
        return x
