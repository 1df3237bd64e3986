"""Solver statistics and report formatting.

A copy of ``acg_tpu/solvers/stats.py`` restricted to the sections the
single-device path fills: iteration counts, analytic flop/byte totals
and per-op-class breakdowns (``cg.h:88-98``, ``cgcuda.h:107-116``),
reported in the fixed text block of ``acgsolvercuda_fwrite``
(``cgcuda.c:1927-1975``), plus the ``timings:`` section of pipeline
phases.  Line-compatible with the JAX package's block, so scripts that
grep ``total solver time`` work on both.
"""

from __future__ import annotations

import dataclasses
import io

from acg_tpu_torch.errors import fexcept_str

OP_CLASSES = ("gemv", "dot", "nrm2", "axpy", "copy", "allreduce", "halo")
# report labels match the reference output block
_OP_LABELS = {"allreduce": "MPI_Allreduce", "halo": "MPI_HaloExchange"}

# canonical pipeline-phase order for the ``timings:`` section
PHASE_ORDER = ("ingest", "partition", "transfer", "compile", "solve",
               "writeback")


@dataclasses.dataclass
class StoppingCriteria:
    """Stopping criteria, all four of the reference's (``cg.h:136-149``):

      * maxits - iteration cap
      * residual_atol:  ||b - Ax|| < atol
      * residual_rtol:  ||b - Ax|| / ||b - Ax0|| < rtol
      * diff_atol:      ||alpha p|| < atol   (difference in iterates)
      * diff_rtol:      ||alpha p|| / ||x|| < rtol
    A tolerance of 0 disables that criterion.
    """

    maxits: int = 100
    residual_atol: float = 0.0
    residual_rtol: float = 0.0
    diff_atol: float = 0.0
    diff_rtol: float = 0.0

    @property
    def needs_diff(self) -> bool:
        return self.diff_atol > 0 or self.diff_rtol > 0

    @property
    def unbounded(self) -> bool:
        """True when no tolerance is set: run exactly maxits iterations."""
        return (self.residual_atol == 0 and self.residual_rtol == 0
                and self.diff_atol == 0 and self.diff_rtol == 0)


@dataclasses.dataclass
class OpStats:
    n: int = 0
    t: float = 0.0
    bytes: int = 0

    def add(self, n=1, t=0.0, bytes=0):
        self.n += n
        self.t += t
        self.bytes += bytes


@dataclasses.dataclass
class SolverStats:
    """Accumulated solver state + statistics (the ``acgsolver*`` struct role)."""

    unknowns: int = 0
    nsolves: int = 0
    ntotaliterations: int = 0
    niterations: int = 0
    nflops: float = 0.0
    tsolve: float = 0.0
    bnrm2: float = 0.0
    x0nrm2: float = 0.0
    r0nrm2: float = 0.0
    rnrm2: float = 0.0
    dxnrm2: float = 0.0
    converged: bool = False
    criteria: StoppingCriteria = dataclasses.field(default_factory=StoppingCriteria)
    ops: dict = dataclasses.field(
        default_factory=lambda: {k: OpStats() for k in OP_CLASSES})
    fexcept_arrays: list = dataclasses.field(default_factory=list)
    # pipeline-phase seconds (the CLI's phase timer and the solver's
    # transfer/compile/solve); rendered only when a phase was recorded
    timings: dict = dataclasses.field(default_factory=dict)

    def fwrite(self, f=None, indent: int = 0) -> str:
        """Solver report, line-compatible with ``acgsolvercuda_fwrite``."""
        out = io.StringIO()
        pad = " " * indent
        c = self.criteria

        def p(line):
            out.write(pad + line + "\n")

        tother = self.tsolve - sum(o.t for o in self.ops.values())
        p(f"unknowns: {self.unknowns:,}")
        p(f"solves: {self.nsolves:,}")
        p(f"total iterations: {self.ntotaliterations:,}")
        p(f"total flops: {1.0e-9 * self.nflops:,.3f} Gflop")
        rate = 1.0e-9 * self.nflops / self.tsolve if self.tsolve > 0 else 0.0
        p(f"total flop rate: {rate:,.3f} Gflop/s")
        p(f"total solver time: {self.tsolve:,.6f} seconds")
        p("performance breakdown:")
        for op in OP_CLASSES:
            s = self.ops[op]
            gbs = 1.0e-9 * s.bytes / s.t if s.t > 0 else 0.0
            label = _OP_LABELS.get(op, op)
            p(f"  {label}: {s.t:,.6f} seconds {s.n:,} times {s.bytes:,} B "
              f"{gbs:,.3f} GB/s")
        p(f"  other: {tother:,.6f} seconds")
        p("last solve:")
        p("  stopping criterion:")
        p(f"    maximum iterations: {c.maxits:,}")
        p(f"    tolerance for residual: {c.residual_atol:.15g}")
        p(f"    tolerance for relative residual: {c.residual_rtol:.15g}")
        p(f"    tolerance for difference in solution iterates: {c.diff_atol:.15g}")
        p(f"    tolerance for relative difference in solution iterates: {c.diff_rtol:.15g}")
        p(f"  iterations: {self.niterations:,}")
        p(f"  right-hand side 2-norm: {self.bnrm2:.15g}")
        p(f"  initial guess 2-norm: {self.x0nrm2:.15g}")
        p(f"  initial residual 2-norm: {self.r0nrm2:.15g}")
        p(f"  residual 2-norm: {self.rnrm2:.15g}")
        p(f"  difference in solution iterates 2-norm: {self.dxnrm2:.15g}")
        p(f"  floating-point exceptions: {fexcept_str(*self.fexcept_arrays)}")
        if self.timings:
            p("timings:")
            for name in PHASE_ORDER:
                if name in self.timings:
                    p(f"  {name}: {self.timings[name]:,.6f} seconds")
        text = out.getvalue()
        if f is not None:
            f.write(text)
        return text


def cg_flops_per_iteration(nnz_full: int, n: int, pipelined: bool = False) -> float:
    """Analytic flop count per CG iteration (reference counts 3 flops per
    stored nonzero per SpMV -- symmetric entries counted twice -- and 2n per
    dot/axpy, ``cgcuda.c:812,901``)."""
    spmv = 3.0 * nnz_full
    if not pipelined:
        # t=Ap; dots: (p,t),(r,r); axpys: x,r,p
        return spmv + 2 * 2.0 * n + 3 * 2.0 * n
    # pipelined: q=Aw; dots (r,r),(w,r); 6 vector updates + scalar recurrences
    return spmv + 2 * 2.0 * n + 6 * 2.0 * n
