"""Solver statistics and report formatting.

A copy of ``acg_tpu/solvers/stats.py`` restricted to the sections the
port's solvers fill: iteration counts, analytic flop/byte totals and
per-op-class breakdowns (``cg.h:88-98``, ``cgcuda.h:107-116``), reported
in the fixed text block of ``acgsolvercuda_fwrite``
(``cgcuda.c:1927-1975``), plus the ``timings:`` section of pipeline
phases, the ``precond:`` section of preconditioned solves, the
``batch:`` section of batched multi-RHS solves, the ``resilience:``
line of solves that broke down, the robustness tier's ``soak:``,
``health:`` and ``ckpt:`` sections, and the observability tier's
``tracing:`` (profiler-capture analysis, timeline summary) and ``slo:``
sections, and the decision layers' ``costmodel:``, ``memory:`` and
``plan:`` sections (``--explain``, ``--autotune``).  Line-compatible
with the JAX package's block, so scripts that grep ``total solver
time`` work on both.  :meth:`SolverStats.to_dict` is the
``--stats-json`` twin with the reference's keys in its order.
"""

from __future__ import annotations

import dataclasses
import io
import math

from acg_tpu_torch.errors import fexcept_str

OP_CLASSES = ("gemv", "dot", "nrm2", "axpy", "copy", "allreduce", "halo",
              "precond")
# report labels match the reference output block
_OP_LABELS = {"allreduce": "MPI_Allreduce", "halo": "MPI_HaloExchange"}
# op classes the reference block does not know: their row renders only
# when something was counted, so unpreconditioned reports keep the
# reference's lines
_OPTIONAL_OPS = ("precond",)

# canonical pipeline-phase order for the ``timings:`` section
PHASE_ORDER = ("ingest", "partition", "transfer", "compile", "solve",
               "ckpt", "writeback")


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
    # the armed preconditioner's kind, applies and spectral interval;
    # rendered (after timings) only when a preconditioned solve ran
    precond: dict = dataclasses.field(default_factory=dict)
    # the batched multi-RHS tier's per-RHS evidence (solvers.batched);
    # rendered after precond only when a batched solve ran
    batch: dict = dataclasses.field(default_factory=dict)
    # breakdown recovery (solvers.resilience): detections and restarts,
    # and the event log printed under the resilience: line
    nbreakdowns: int = 0
    nrestarts: int = 0
    recovery_log: list = dataclasses.field(default_factory=list)
    # the observability tier (acg_tpu_torch.telemetry, .tracing,
    # .observatory): timestamped events, the last solve's convergence
    # trace (a telemetry.ConvergenceTrace), the profiler-capture
    # analysis and timeline summary, and the --slo verdict
    events: list = dataclasses.field(default_factory=list)
    trace: object = None
    tracing: dict = dataclasses.field(default_factory=dict)
    slo: dict = dataclasses.field(default_factory=dict)
    # the sections of the reference's tiers the port does not have yet:
    # always empty, kept so to_dict() carries the reference's keys
    nfallbacks: int = 0
    nrollbacks: int = 0
    costmodel: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    soak: dict = dataclasses.field(default_factory=dict)
    health: dict = dataclasses.field(default_factory=dict)
    ckpt: dict = dataclasses.field(default_factory=dict)
    plan: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        """Machine-readable twin of :meth:`fwrite` -- the ``stats`` key
        of a ``--stats-json`` document, keys in the reference's order
        (``acg_tpu/solvers/stats.py:169-228``).  The convergence trace's
        records are the ``--convergence-log`` JSONL data lines."""
        c = self.criteria
        d = {
            "unknowns": self.unknowns,
            "nsolves": self.nsolves,
            "ntotaliterations": self.ntotaliterations,
            "niterations": self.niterations,
            "nflops": self.nflops,
            "tsolve": self.tsolve,
            "bnrm2": self.bnrm2,
            "x0nrm2": self.x0nrm2,
            "r0nrm2": self.r0nrm2,
            "rnrm2": self.rnrm2,
            "dxnrm2": self.dxnrm2,
            "converged": bool(self.converged),
            "criteria": {
                "maxits": c.maxits,
                "residual_atol": c.residual_atol,
                "residual_rtol": c.residual_rtol,
                "diff_atol": c.diff_atol,
                "diff_rtol": c.diff_rtol,
            },
            "ops": {op: {"n": s.n, "t": s.t, "bytes": s.bytes}
                    for op, s in self.ops.items()},
            "fexcept": fexcept_str(*self.fexcept_arrays),
            "resilience": {
                "nbreakdowns": self.nbreakdowns,
                "nrestarts": self.nrestarts,
                "nfallbacks": self.nfallbacks,
                "nrollbacks": self.nrollbacks,
                "log": list(self.recovery_log),
            },
            "events": list(self.events),
            "timings": dict(self.timings),
            "costmodel": dict(self.costmodel),
            "memory": dict(self.memory),
            "soak": dict(self.soak),
            "precond": dict(self.precond),
            "health": dict(self.health),
            "ckpt": dict(self.ckpt),
            "tracing": dict(self.tracing),
            "slo": dict(self.slo),
            "batch": dict(self.batch),
            "plan": dict(self.plan),
        }
        if self.trace is not None:
            d["trace"] = self.trace.to_dict()
        # JSON has no Inf/NaN literal; dxnrm2 is inf when no diff
        # criterion ran
        for k in ("bnrm2", "x0nrm2", "r0nrm2", "rnrm2", "dxnrm2",
                  "nflops", "tsolve"):
            if not math.isfinite(d[k]):
                d[k] = repr(d[k])
        return d

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
            if op in _OPTIONAL_OPS and s.n == 0:
                continue
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
        # the resilience lines appear only when something happened, so a
        # clean solve's block keeps the reference's lines; the rollback
        # count appends only when rollbacks happened
        if (self.nbreakdowns or self.nrestarts or self.nfallbacks
                or self.nrollbacks):
            rb = (f", {self.nrollbacks} rollbacks" if self.nrollbacks
                  else "")
            p(f"  resilience: {self.nbreakdowns} breakdowns detected, "
              f"{self.nrestarts} restarts, {self.nfallbacks} fallbacks"
              + rb)
            for ev in self.recovery_log:
                p(f"    {ev}")
        if self.timings:
            p("timings:")
            seen = []
            for name in PHASE_ORDER:
                if name in self.timings:
                    seen.append(name)
                    p(f"  {name}: {self.timings[name]:,.6f} seconds")
            for name, secs in self.timings.items():
                if name not in seen:
                    p(f"  {name}: {secs:,.6f} seconds")
        # the perfmodel sections (analytic and counted costs, the comm
        # ledger, the device footprint) and the planner's plan-vs-actual
        # row, where the reference's block prints them
        if self.costmodel:
            p("costmodel:")
            _write_section(p, self.costmodel, 1)
        if self.memory:
            p("memory:")
            _write_section(p, self.memory, 1)
        if self.soak:
            p("soak:")
            _write_section(p, self.soak, 1)
        if self.precond:
            p("precond:")
            _write_section(p, self.precond, 1)
        if self.health:
            p("health:")
            _write_section(p, self.health, 1)
        if self.ckpt:
            p("ckpt:")
            _write_section(p, self.ckpt, 1)
        if self.tracing:
            p("tracing:")
            _write_section(p, self.tracing, 1)
        if self.slo:
            p("slo:")
            _write_section(p, self.slo, 1)
        if self.batch:
            p("batch:")
            _write_section(p, self.batch, 1)
        if self.plan:
            p("plan:")
            _write_section(p, self.plan, 1)
        text = out.getvalue()
        if f is not None:
            f.write(text)
        return text


def _write_section(p, d: dict, depth: int) -> None:
    """Nested renderer of a named section: scalars one per line,
    sub-dicts indented, lists summarised by length."""
    ind = "  " * depth
    for k, v in d.items():
        if isinstance(v, dict):
            p(f"{ind}{k}:")
            _write_section(p, v, depth + 1)
        elif isinstance(v, (list, tuple)):
            p(f"{ind}{k}: [{len(v)} entries -- see --stats-json]")
        elif isinstance(v, float):
            p(f"{ind}{k}: {v:,.6g}")
        else:
            p(f"{ind}{k}: {v}")


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
