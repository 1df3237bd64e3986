"""The ``python -m acg_tpu_torch`` command line.

The counterpart of ``acg_tpu/cli.py``: read or generate the matrix,
assemble the symmetric CSR, partition its rows, build the right-hand
side (optionally a manufactured solution), run the solver, print the
statistics block to stderr and write the solution.  With one part
(``--comm none``, or ``--nparts`` resolving to 1) the solver is the
single-device :class:`~acg_tpu_torch.solvers.cg.TorchCGSolver`; with
``--nparts N > 1`` it is the multi-part
:class:`~acg_tpu_torch.parallel.dist.DistCGSolver`, every part stacked
on the one device, with the halo transport of ``--comm``.
``--operator`` solves with a matrix-free stencil (or a registered user
operator) in place of the assembled matrix, and ``gen:poisson*`` specs
above ``ACG_TPU_GEN_DIRECT_MIN`` rows (default 2^24) skip the host
matrix altogether: planes or operator on the device, ``b = ones``
(the single-device gen-direct tier).  ``--precond`` makes the classic
and pipelined solvers preconditioned, ``--precise-dots`` computes their
scalars with compensated dots, ``--replace-every`` runs the bf16 tier
with periodic f32 residual replacement, and ``--refine`` wraps the
solve in f64 iterative refinement on the host.  ``--algorithm
sstep:S|pipelined:L`` runs a communication-avoiding recurrence
(:mod:`acg_tpu_torch.recurrence`) on one part or on stacked parts.
``--nrhs B`` solves B right-hand sides in one batched solve
(:class:`~acg_tpu_torch.solvers.batched.BatchedCGSolver`, ``--block-cg``
for block CG; on ``--nparts N > 1`` the stacked
:class:`~acg_tpu_torch.parallel.dist_batched.BatchedDistCGSolver`), and
``--solver host|host-native|petsc`` runs a host oracle
(:mod:`acg_tpu_torch.solvers.host_cg`, ``petsc_cg``).  A matrix file
with a ``.perm.mtx`` sidecar (``mtx2bin --partition``) is solved with b,
x0 and x in the original row order.  Flag names and defaults follow the
JAX package's CLI; flags of tiers the port does not have yet
(``--serve``, ``--trace``, ...) are not accepted.

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
exits with an error instead of solving on the CPU (the host oracles
too: the device is resolved before anything else).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

DTYPES = {"f64": (torch.float64, torch.float64),
          "f32": (torch.float32, torch.float32),
          "mixed": (torch.bfloat16, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16)}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="acg-tpu-torch",
        description="Conjugate gradient solver for symmetric positive "
                    "definite linear systems Ax=b on one CUDA device "
                    "(PyTorch port of acg-tpu), on one part or several "
                    "parts stacked on the device.")
    p.add_argument("A", help="matrix in Matrix Market format (.mtx, .mtx.gz, "
                             "binary), or a generator spec "
                             "gen:poisson2d:N | gen:poisson3d:N | "
                             "gen:irregular:N[:AVGDEG]")
    p.add_argument("b", nargs="?", default=None,
                   help="right-hand side vector (default: ones)")
    p.add_argument("x0", nargs="?", default=None,
                   help="initial guess (default: zeros)")
    p.add_argument("--solver", default="acg",
                   choices=["acg", "acg-pipelined", "acg-device",
                            "acg-pipelined-device", "host", "host-native",
                            "petsc"],
                   help="solver variant (default: acg); the -device names "
                        "run the same solvers.  host = the numpy f64 "
                        "oracle (multi-part under --nparts N > 1), "
                        "host-native = the same CG in the native C++ "
                        "core, petsc = scipy's CG (the external oracle); "
                        "these three compute on the host")
    p.add_argument("--algorithm", default="auto", metavar="ALG",
                   help="CG recurrence: 'classic' | 'pipelined' "
                        "(Ghysels-Vanroose, = --solver acg-pipelined) | "
                        "'sstep:S' (communication-avoiding s-step CG: "
                        "ONE fused Gram allreduce per S iterations, "
                        "monomial basis below S=4, Chebyshev at S>=4) | "
                        "'pipelined:L' (deep-pipelined p(l)-CG: ONE "
                        "fused allreduce per iteration consumed L "
                        "iterations later; restarted on the method's "
                        "square-root breakdown).  'auto' follows "
                        "--solver.  The CA recurrences ride the "
                        "single-device, gen-direct and multi-part tiers "
                        "and run unpreconditioned over f32/f64 vectors")
    p.add_argument("--comm", default="xla",
                   choices=["none", "xla", "dma", "mpi", "nccl", "nvshmem"],
                   help="halo transport of the multi-part solver: xla = "
                        "plain PyTorch (the all_to_all as a transpose), "
                        "dma = one-sided puts on the hand-written kernel; "
                        "mpi/nccl alias xla, nvshmem aliases dma; none = "
                        "one part")
    p.add_argument("--nparts", type=int, default=0,
                   help="number of parts, all stacked on the one device "
                        "(default: the CUDA device count, 1 on the CPU; "
                        "0 with --comm none means 1)")
    p.add_argument("--partition", metavar="FILE", default=None,
                   help="read the row partition vector from FILE")
    p.add_argument("--partition-method", default="auto",
                   choices=["auto", "graph", "band"],
                   help="row partition strategy: graph = edge-cut "
                        "minimisation (METIS/bisection), band = contiguous "
                        "nnz-balanced ranges (keeps banded matrices in "
                        "DIA form); auto picks band for banded matrices "
                        "(default)")
    p.add_argument("--partition-binary", "--binary-partition",
                   action="store_true", dest="partition_binary",
                   help="partition vector file is in binary Matrix Market "
                        "format")
    p.add_argument("--output-comm-matrix", action="store_true",
                   help="write the part-to-part communication volume "
                        "matrix to stdout as Matrix Market")
    p.add_argument("--binary", action="store_true",
                   help="matrix/vector files are in binary Matrix Market format")
    p.add_argument("--gzip", "--gunzip", "--ungzip", action="store_true",
                   dest="gzip",
                   help="accepted for drop-in compatibility; gzip input is "
                        "auto-detected from the magic bytes regardless")
    p.add_argument("--max-iterations", type=int, default=100, metavar="N",
                   help="maximum number of iterations (default: 100)")
    p.add_argument("--residual-atol", type=float, default=0.0, metavar="TOL",
                   help="stop when the residual norm is below TOL")
    p.add_argument("--residual-rtol", type=float, default=1e-9, metavar="TOL",
                   help="stop when the relative residual is below TOL "
                        "(default: 1e-9)")
    p.add_argument("--diff-atol", type=float, default=0.0, metavar="TOL",
                   help="stop when the difference in solution iterates is "
                        "below TOL")
    p.add_argument("--diff-rtol", type=float, default=0.0, metavar="TOL",
                   help="stop on relative difference in solution iterates")
    p.add_argument("--epsilon", type=float, default=0.0,
                   help="diagonal shift: solve (A + epsilon*I)x = b")
    p.add_argument("--warmup", type=int, default=10, metavar="N",
                   help="warmup solves before the timed solve (default: 10)")
    p.add_argument("--manufactured-solution", action="store_true",
                   help="use a random unit-norm solution and b = A*xsol; "
                        "report error norms")
    p.add_argument("--dtype", default="f64", choices=list(DTYPES),
                   help="device precision (default: f64).  'mixed' = bf16 "
                        "matrix storage + f32 vectors/scalars; 'bf16' "
                        "stores vectors in bf16 too (f32 scalars)")
    p.add_argument("--kernels", default="auto",
                   choices=["auto", "xla", "pallas", "fused"],
                   help="hot-loop kernel tier: xla = plain PyTorch ops; "
                        "pallas = the hand-written CUDA DIA SpMV or, with "
                        "--operator, the stencil SpMV (and the pipelined "
                        "update kernel); fused = classic CG on the "
                        "two-phase kernel pair; auto = the hand kernels "
                        "for DIA matrices (every dtype) and Poisson "
                        "operators on CUDA")
    p.add_argument("--spmv-format", default="auto",
                   choices=["auto", "dia", "ell", "coo"],
                   help="force the device sparse format; auto picks by "
                        "sparsity structure")
    p.add_argument("--replace-every", type=int, default=0, metavar="K",
                   help="with --dtype bf16: periodic f32 residual "
                        "replacement every K iterations (classic CG; "
                        "single-part and multi-part tiers) -- the "
                        "sound-bf16 contract: f32-class residuals for one "
                        "mixed SpMV per K iterations (0 = off)")
    p.add_argument("--precond", default="none", metavar="KIND",
                   help="preconditioner: none | jacobi (inverse-diagonal "
                        "scaling, no extra communication) | bjacobi[:BS] "
                        "(Cholesky of the BSxBS local diagonal blocks, "
                        "batched triangular solves, no halo traffic; "
                        "default BS 32) | cheby:K (degree-K Chebyshev "
                        "polynomial: K extra SpMVs per iteration through "
                        "the tier's own SpMV and halo exchange, "
                        "lambda_max from a power iteration at setup).  "
                        "Turns the classic/pipelined solvers into PCG / "
                        "pipelined PCG on every tier (default: none)")
    p.add_argument("--operator", default="none", metavar="SPEC",
                   help="matrix-free operator tier: solve with A as an "
                        "apply instead of stored planes (no matrix reads "
                        "per iteration; iterates bitwise-equal to the "
                        "assembled DIA tier).  'stencil' derives the "
                        "built-in stencil from the gen: matrix spec (+ "
                        "--aniso); stencil:poisson1d|poisson2d|poisson3d:N "
                        "and stencil:aniso2d:N:EPS name it explicitly "
                        "(validated against the matrix being solved); "
                        "user:NAME runs an operator registered with "
                        "register_operator (in-process callers).  'none' "
                        "(default) keeps the assembled path")
    p.add_argument("--aniso", type=float, default=None, metavar="EPS",
                   help="with gen:poisson2d:N: generate the anisotropic "
                        "(stretched-grid) Poisson family instead, "
                        "y-spacings graded by stretch factor EPS in (0, 1]")
    p.add_argument("--nrhs", type=int, default=0, metavar="B",
                   help="batched multi-RHS tier: solve B right-hand sides "
                        "against the one matrix in a single batched solve "
                        "-- one multi-column SpMV an iteration, every "
                        "per-RHS dot one column reduction, per-RHS "
                        "convergence masks (converged columns freeze).  b "
                        "may be an n x B dense array file; without a b "
                        "file, B seeded random unit-norm columns (--seed); "
                        "with --manufactured-solution, B manufactured "
                        "columns.  Per-RHS evidence lands in a 'batch:' "
                        "stats section.  With --nparts N > 1 the parts "
                        "stack on the device and the halo moves (maxcnt, "
                        "B) windows in one exchange.  B=1 (or flag "
                        "absent) runs the single-RHS solvers")
    p.add_argument("--block-cg", action="store_true",
                   help="with --nrhs B: the block-CG recurrence instead "
                        "of the masked batched one -- one shared Krylov "
                        "block, B x B Gram solves with rank deflation; "
                        "fewer total iterations than B independent solves "
                        "on ill-conditioned families (--aniso).  One part "
                        "(--nparts 1 / --comm none)")
    p.add_argument("--precise-dots", action="store_true",
                   help="compensated (double-float) dot products for the "
                        "CG scalars; lets f32 storage converge past the "
                        "~1e-6 relative-residual stall")
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision iterative refinement: f64 outer "
                        "residual on the host, --dtype inner solves on the "
                        "device; reaches f64 tolerances at f32 device "
                        "speed")
    p.add_argument("--refine-rtol", type=float, default=1e-5, metavar="TOL",
                   help="relative tolerance of each inner refinement solve "
                        "(default: 1e-5)")
    p.add_argument("--refine-inner-maxits", type=int, default=None,
                   metavar="N",
                   help="cap each inner refinement solve at N iterations "
                        "(default: the remaining --max-iterations budget)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to solve (default: cuda; cpu only when "
                        "asked for)")
    p.add_argument("--seed", type=int, default=42,
                   help="random seed for manufactured solutions and "
                        "generated matrices")
    p.add_argument("--numfmt", default="%.17g", metavar="FMT",
                   help="printf-style format for numeric output")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="do not write the solution vector to stdout")
    p.add_argument("-o", "--output", metavar="FILE", default=None,
                   help="write the solution to FILE (binary Matrix Market "
                        "array) instead of stdout")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="print stage timings to stderr")
    from acg_tpu_torch import __version__
    p.add_argument("--version", action="version",
                   version=f"acg-tpu-torch {__version__}")
    p.add_argument("--buildinfo", action="store_true",
                   help="print the runtime feature matrix (torch, the "
                        "card, the kernel and native-core builds) and "
                        "exit")
    return p


def _buildinfo(out) -> int:
    """The runtime feature matrix (``acg_tpu/cli.py:801``'s twin for the
    port): torch and its CUDA, the card, ``nvcc``, the kernel build
    directory, the native host core and libmetis."""
    import subprocess

    from acg_tpu_torch import __version__, _native
    from acg_tpu_torch.ops import _build
    from acg_tpu_torch.partition import metis_available

    card = "unavailable"
    if torch.cuda.is_available():
        card = torch.cuda.get_device_name(0)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
            if smi.returncode == 0 and smi.stdout.strip():
                card = smi.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            card += " (power limit unavailable: no nvidia-smi)"
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    kdir = _build.library_path().parent
    rows = [
        ("acg-tpu-torch", __version__),
        ("torch", torch.__version__),
        ("torch CUDA", torch.version.cuda or "none (CPU build)"),
        ("device", card),
        ("nvcc", nvcc or "not found (the CUDA kernels cannot be built)"),
        ("kernel build directory",
         f"{kdir} ({'built' if kdir.exists() else 'not built yet'})"),
        ("native core (libacg_core)", _native.describe()),
        ("libmetis", "yes" if metis_available() else
         "no (built-in bisection fallback)"),
        ("float64", "native on CUDA"),
    ]
    for k, v in rows:
        out.write(f"{k}: {v}\n")
    return 0


def _log(args, msg, t0=None):
    if args.verbose:
        if t0 is not None:
            sys.stderr.write(f"{msg} done in "
                             f"{time.perf_counter() - t0:.6f} seconds\n")
        else:
            sys.stderr.write(msg + "\n")


def _validate_numfmt(fmt: str) -> str:
    """Validate ``--numfmt`` through the fmtspec parser: exactly one
    floating-point conversion, no ``*`` width/precision, no hexfloat;
    C length modifiers (``%lg``) are accepted and stripped."""
    import dataclasses

    from acg_tpu_torch import fmtspec

    try:
        spec = fmtspec.parse(fmt)
    except fmtspec.FmtSpecError as e:
        raise SystemExit(f"acg-tpu-torch: invalid --numfmt {fmt!r}: {e}")
    if (not spec.is_float or spec.needs_star_args
            or spec.conversion in "aA"):
        raise SystemExit(
            f"acg-tpu-torch: invalid --numfmt {fmt!r}: need a single "
            f"floating-point conversion (e.g. %.17g, %e, %12.6f)")
    return str(dataclasses.replace(spec, length=""))


def _parse_gen_spec(spec: str):
    """``gen:poisson2d:N | gen:poisson3d:N | gen:irregular:N[:AVGDEG]``
    -> (kind, dim, n, N, avg_degree)."""
    parts = spec.split(":")
    kind = parts[1] if len(parts) > 1 else ""
    try:
        if kind in ("poisson2d", "poisson3d"):
            if len(parts) != 3:
                raise ValueError
            dim = 2 if kind == "poisson2d" else 3
            n = int(parts[2])
            if n <= 0:
                raise ValueError
            return ("poisson", dim, n, n ** dim, None)
        if kind == "irregular":
            if len(parts) not in (3, 4):
                raise ValueError
            n = int(parts[2])
            avg = float(parts[3]) if len(parts) == 4 else 16.0
            if n <= 0 or avg <= 0:
                raise ValueError
            return ("irregular", 0, n, n, avg)
        raise ValueError
    except ValueError:
        raise SystemExit(
            f"acg-tpu-torch: invalid generator spec {spec!r}: expected "
            f"gen:poisson2d:N | gen:poisson3d:N | gen:irregular:N[:AVGDEG]")


def synthesize_host_matrix(spec_str: str, aniso=None, seed: int = 42):
    """``gen:`` spec -> host :class:`~acg_tpu_torch.matrix.SymCsrMatrix`
    (``aniso``: the stretched-grid 2D family)."""
    from acg_tpu_torch.io.generators import (aniso_poisson2d_coo,
                                             irregular_spd_coo,
                                             poisson2d_coo, poisson3d_coo)
    from acg_tpu_torch.matrix import SymCsrMatrix

    kind, dim, n, N, avg = _parse_gen_spec(spec_str)
    if kind == "poisson" and aniso is not None:
        r, c, v, N = aniso_poisson2d_coo(n, aniso)
    elif kind == "poisson":
        r, c, v, N = (poisson2d_coo if dim == 2 else poisson3d_coo)(n)
    else:
        r, c, v, N = irregular_spd_coo(n, avg_degree=avg, seed=seed)
    return SymCsrMatrix.from_coo(N, r, c, v)


def _validate_operator(args) -> None:
    """Parse ``--operator`` and refuse what an armed operator could never
    serve, before anything expensive (``acg_tpu/cli.py:2944-3002``)."""
    from acg_tpu_torch.ops.operator import parse_operator_spec

    try:
        args._operator_spec = parse_operator_spec(args.operator)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    if args._operator_spec is not None:
        unsupported = [flag for flag, on in [
            (f"--solver {args.solver} (the host/external oracles run "
             f"assembled matrices)",
             args.solver in ("host", "host-native", "petsc")),
            (f"--dtype {args.dtype} (operators generate plane values "
             f"in the storage dtype; bf16 has no matrix traffic left "
             f"to halve)", args.dtype in ("bf16", "mixed")),
            (f"--spmv-format {args.spmv_format} (forcing an assembled "
             f"device format contradicts matrix-free)",
             args.spmv_format != "auto"),
            ("--block-cg (the block-Gram tier keeps assembled "
             "matrices)", args.block_cg),
            ("--nrhs on the mesh (the batched dist tier keeps "
             "assembled local blocks; --nrhs rides matrix-free on the "
             "single-device tier: --comm none / --nparts 1)",
             args._batched and not (args.comm == "none"
                                    or args.nparts in (0, 1))),
            ("--epsilon (the stencil computes the UNshifted system; a "
             "shifted solve needs the assembled path)",
             bool(args.epsilon)),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --operator {args.operator} does not "
                f"support: {', '.join(unsupported)}")
        if (args._operator_spec[0] in ("auto", "poisson", "aniso2d")
                and not args.A.startswith("gen:")):
            raise SystemExit(
                "acg-tpu-torch: --operator stencil* pairs with a gen: "
                "matrix spec (a file matrix is assembled by definition "
                "and the stencil could silently compute a different "
                "system); register a user:NAME operator for file-backed "
                "systems")
    if args.aniso is not None:
        if not 0.0 < args.aniso <= 1.0:
            raise SystemExit("acg-tpu-torch: --aniso EPS must be in (0, 1]")
        if not args.A.startswith("gen:poisson2d:"):
            raise SystemExit(
                "acg-tpu-torch: --aniso generates the stretched-grid 2D "
                "Poisson family and needs a gen:poisson2d:N matrix spec")


def _validate_batched(args) -> None:
    """Validate ``--nrhs``/``--block-cg`` and refuse what the batched
    solvers cannot serve, before anything expensive (``acg_tpu/cli.py:
    2906-2944``, for the flags the port has).  ``--nrhs 1`` and no flag
    take the single-RHS path."""
    if args.nrhs < 0:
        raise SystemExit("acg-tpu-torch: --nrhs must be >= 0")
    if args.block_cg and args.nrhs < 2:
        raise SystemExit(
            "acg-tpu-torch: --block-cg shares one Krylov block across B "
            "right-hand sides; add --nrhs B (B >= 2)")
    args._batched = args.nrhs >= 2
    if args._batched:
        unsupported = [flag for flag, on in [
            (f"--solver {args.solver} (use the device solvers; the "
             f"host batched oracle is a library API)",
             args.solver in ("host", "host-native", "petsc")),
            ("--refine", args.refine),
            ("--replace-every", args.replace_every > 0),
            (f"--kernels {args.kernels} (batched runs the XLA "
             f"multi-vector SpMV)", args.kernels in ("pallas", "fused")),
            ("--comm dma (the batched mesh tier runs the XLA "
             "all_to_all transport)", args.comm in ("dma", "nvshmem")),
            ("--diff-atol/--diff-rtol (residual criteria only)",
             args.diff_atol > 0 or args.diff_rtol > 0),
            ("--output-comm-matrix", args.output_comm_matrix),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --nrhs {args.nrhs} does not support: "
                f"{', '.join(unsupported)}")


def _validate_algorithm(args) -> None:
    """Parse ``--algorithm`` and refuse what an armed communication-
    avoiding recurrence could never serve, before anything expensive
    (``acg_tpu/cli.py:2707-2750``, for the flags the port has):
    classic and pipelined rewrite ``--solver``."""
    from acg_tpu_torch.recurrence import parse_algorithm

    try:
        args._algorithm = parse_algorithm(args.algorithm)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    if (args._algorithm is not None
            and not args._algorithm.communication_avoiding):
        if args._algorithm.kind == "pipelined" and args.solver == "acg":
            args.solver = "acg-pipelined"
        elif (args._algorithm.kind == "classic"
              and args.solver == "acg-pipelined"):
            args.solver = "acg"
        args._algorithm = None
    if args._algorithm is not None:
        unsupported = [flag for flag, on in [
            (f"--solver {args.solver} (the host/external oracles run "
             f"the classic recurrence)",
             args.solver in ("host", "host-native", "petsc")),
            ("--nrhs/--block-cg (no batched CA recurrences yet)",
             args.nrhs >= 2 or args.block_cg),
            ("--refine", args.refine),
            ("--replace-every", args.replace_every > 0),
            ("--precise-dots", args.precise_dots),
            (f"--precond {args.precond} (the CA recurrences run "
             f"unpreconditioned)", args._precond is not None),
            ("--kernels fused", args.kernels == "fused"),
            ("--diff-atol/--diff-rtol (residual criteria only)",
             args.diff_atol > 0 or args.diff_rtol > 0),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --algorithm {args._algorithm} does not "
                f"support: {', '.join(unsupported)}")


def _validate_precision(args) -> None:
    """Parse ``--precond`` and refuse the configurations an armed
    preconditioner could never serve, before anything expensive
    (``acg_tpu/cli.py:2683-2706``)."""
    from acg_tpu_torch.precond import parse_precond

    try:
        args._precond = parse_precond(args.precond)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    if args._precond is not None:
        unsupported = [flag for flag, on in [
            ("--replace-every (the replacement segments restructure "
             "the recurrences M^-1 threads through)",
             args.replace_every > 0),
            ("--kernels fused (the two-phase kernels fold the whole "
             "iteration; no preconditioner hook)",
             args.kernels == "fused"),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --precond {args.precond} does not "
                f"support: {', '.join(unsupported)}")


def _solver_options(args) -> dict:
    """The precision, preconditioning and recurrence keywords both
    solver tiers take."""
    return dict(precise_dots=args.precise_dots,
                replace_every=args.replace_every, precond=args._precond,
                algorithm=args._algorithm)


def _fold_inner_timings(solver) -> None:
    """Under ``--refine`` the wrapper's statistics are the ones printed:
    they take the device solver's phase timings."""
    inner = getattr(solver, "inner", None)
    if inner is None:
        return
    for k, v in inner.stats.timings.items():
        solver.stats.timings[k] = solver.stats.timings.get(k, 0.0) + v
    inner.stats.timings.clear()


def _build_cli_operator(args, n: int, dtype, device):
    """The armed ``--operator`` for this solve, validated against the
    matrix being solved."""
    from acg_tpu_torch.ops.operator import build_operator

    gen = _parse_gen_spec(args.A) if args.A.startswith("gen:") else None
    try:
        return build_operator(args._operator_spec, dtype, gen=gen,
                              aniso=args.aniso, nrows=n, device=device)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")


def _gen_direct_min() -> int:
    """Row threshold above which gen:poisson specs skip the host matrix
    (``ACG_TPU_GEN_DIRECT_MIN``, read as the JAX package reads it, so
    tests can take the direct path at small sizes)."""
    import os

    return int(os.environ.get("ACG_TPU_GEN_DIRECT_MIN", 2 ** 24))


def _solve_generated_direct(args, dim, n, N, device, dtype,
                            vec_dtype) -> int:
    """The single-device gen-direct tier (``acg_tpu/cli.py:1148-1274``):
    no host matrix -- the Poisson DIA planes built on the device
    (``poisson_dia_device``), or the armed operator, and ``b = ones`` on
    the device.  This is what makes ``gen:poisson3d:512`` (134M rows)
    reachable at all."""
    from acg_tpu_torch.errors import BreakdownError, NotConvergedError
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.spmv import DiaMatrix
    from acg_tpu_torch.solvers.cg import TorchCGSolver
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    unsupported = [flag for flag, on in [
        (f"--solver {args.solver}",
         args.solver in ("host", "host-native", "petsc")),
        ("b/x0 input files", bool(args.b or args.x0)),
        ("--output-comm-matrix", args.output_comm_matrix),
        (f"--spmv-format {args.spmv_format}",
         args.spmv_format not in ("auto", "dia")),
        ("--nrhs/--block-cg (the batched tiers need the host-CSR "
         "ingest path; lower ACG_TPU_GEN_DIRECT_MIN only for "
         "single-RHS solves)", args._batched),
    ] if on]
    if unsupported:
        raise SystemExit(
            f"acg-tpu-torch: {args.A}: direct on-device assembly "
            f"(N={N:,} rows) does not support: {', '.join(unsupported)} "
            f"(these need a host-side matrix; use a file or a smaller "
            f"gen: spec)")
    # multi-part, manufactured and refined configurations run the
    # sharded assembly and solve (parallel/sharded_dia), as in acg_tpu
    if args.nparts > 1 or args.manufactured_solution or args.refine:
        if args._operator_spec is not None:
            raise SystemExit(
                "acg-tpu-torch: --operator does not reach the sharded "
                "gen-direct tier (parallel/sharded_dia runs stored "
                "planes); use the host-ingest mesh path (raise "
                "ACG_TPU_GEN_DIRECT_MIN above N) or a single-part solve")
        return _solve_generated_sharded(args, dim, n, N, device, dtype,
                                        vec_dtype)

    t0 = time.perf_counter()
    if args._operator_spec is not None:
        # matrix-free at gen-direct sizes: nothing is assembled at all
        A = _build_cli_operator(args, N, dtype, device)
        _log(args, f"gen-direct: {args.A} (N={N}) as the operator "
                   f"{A.identity()}, no host matrix:", t0)
    else:
        planes, offsets, _ = poisson_dia_device(n, dim, dtype=dtype,
                                                device=device,
                                                epsilon=args.epsilon)
        A = DiaMatrix(data=planes, offsets=offsets, nrows=N, ncols_padded=N)
        _log(args, f"gen-direct: {args.A} (N={N}) DIA planes assembled on "
                   f"the device, no host matrix:", t0)
    ingest = time.perf_counter() - t0
    try:
        solver = TorchCGSolver(A, pipelined="pipelined" in args.solver,
                               kernels=args.kernels, vector_dtype=vec_dtype,
                               device=device, **_solver_options(args))
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    solver.stats.timings["ingest"] = ingest
    b = torch.ones(N, dtype=vec_dtype, device=device)
    criteria = StoppingCriteria(
        maxits=args.max_iterations,
        residual_atol=args.residual_atol, residual_rtol=args.residual_rtol,
        diff_atol=args.diff_atol, diff_rtol=args.diff_rtol)
    t0 = time.perf_counter()
    try:
        x = solver.solve(b, criteria=criteria, warmup=args.warmup,
                         host_result=bool(not args.quiet or args.output))
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        solver.stats.fwrite(sys.stderr)
        return 1
    _log(args, "solve:", t0)
    solver.stats.fwrite(sys.stderr)
    _emit_solution(args, x)
    return 0


def _solve_generated_sharded(args, dim, n, N, device, dtype,
                             vec_dtype) -> int:
    """The sharded gen-direct tier (``acg_tpu/cli.py:2291-2470``): the
    planes built on the device and solved over ``--nparts`` row parts
    (one by default), b = ones or a manufactured b drawn on the device
    with the analytic spot check, and ``--refine`` as df64 refinement on
    the device (``parallel/sharded_dia``)."""
    from acg_tpu_torch.errors import BreakdownError, NotConvergedError
    from acg_tpu_torch.parallel.sharded_dia import (
        build_sharded_poisson_solver, spot_check_manufactured)
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    if (args.refine and args.dtype not in ("f32", "mixed")
            and not (args.dtype == "bf16" and args.replace_every)):
        raise SystemExit(
            "acg-tpu-torch: sharded --refine runs df64 outer residuals "
            "over f32 inner solves; use --dtype f32/mixed, or --dtype bf16 "
            "with --replace-every (sound-bf16 inner solves)")
    if args.kernels == "fused":
        raise SystemExit(
            "acg-tpu-torch: the sharded direct-assembly path supports "
            "--kernels auto/xla (roll formulation) or pallas (per-shard "
            "clustered kernel + ppermute halo); 'fused' rides the "
            "single-device and explicit-mesh (--nparts) tiers")
    if args.replace_every and (args.diff_atol > 0 or args.diff_rtol > 0):
        raise SystemExit(
            "acg-tpu-torch: --replace-every supports residual criteria "
            "only (--diff-atol/--diff-rtol have no meaning across "
            "replacement segments)")
    nparts = args.nparts or _default_nparts(device)
    t0 = time.perf_counter()
    try:
        solver = build_sharded_poisson_solver(
            n, dim, nparts=nparts, dtype=dtype, vector_dtype=vec_dtype,
            pipelined="pipelined" in args.solver,
            epsilon=args.epsilon, kernels=args.kernels, device=device,
            **_solver_options(args))
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    _log(args, f"gen-direct: {args.A} (N={N}) sharded DIA planes assembled "
               f"on the device ({nparts} parts, {solver.kernels}), no host "
               f"matrix:", t0)
    solver.stats.timings["ingest"] = time.perf_counter() - t0

    xsol = None
    if args.manufactured_solution:
        t0 = time.perf_counter()
        if args.refine:
            # b in double-float: an f32-rounded b would cap the reachable
            # error at ~1e-7
            xsol, b = solver.manufactured_df(seed=args.seed)
        else:
            xsol, b = solver.manufactured(seed=args.seed)
        _log(args, "manufactured solution (on the device):", t0)
        if solver.stencil is not None:
            # the analytic stencil rows on the host share nothing with the
            # solve's SpMV; bf16 b is rounded to 8 bits by construction
            bh = b[0] if isinstance(b, tuple) else b
            tol = 1e-2 if bh.dtype == torch.bfloat16 else 1e-5
            dev = spot_check_manufactured(solver, xsol, b)
            sys.stderr.write(f"manufactured-b spot check (analytic "
                             f"stencil rows): max rel dev {dev:.3e}\n")
            if not dev < tol:
                sys.stderr.write("acg-tpu-torch: manufactured b FAILED the "
                                 "independent spot check\n")
                return 1
    else:
        b = solver.ones_b()
    criteria = StoppingCriteria(
        maxits=args.max_iterations,
        residual_atol=args.residual_atol, residual_rtol=args.residual_rtol,
        diff_atol=args.diff_atol, diff_rtol=args.diff_rtol)
    t0 = time.perf_counter()
    xl = None
    try:
        if args.refine:
            x, xl = solver.solve_refined(
                b, criteria=criteria, inner_rtol=args.refine_rtol,
                inner_maxits=args.refine_inner_maxits, warmup=args.warmup)
            _log(args, f"refine: {solver.stats.nrefine} passes, "
                       f"{solver.stats.niterations} inner iterations")
        else:
            x = solver.solve(b, criteria=criteria, warmup=args.warmup,
                             host_result=False)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        solver.stats.fwrite(sys.stderr)
        return 1
    _log(args, "solve:", t0)
    errs = None
    if xsol is not None:
        errs = (solver.error_norms_df(x, xl, xsol) if xl is not None
                else solver.error_norms(x, xsol))
    solver.stats.fwrite(sys.stderr)
    if errs is not None:
        sys.stderr.write(f"initial error 2-norm: {errs[0]:.15g}\n")
        sys.stderr.write(f"error 2-norm: {errs[1]:.15g}\n")
    if args.output is not None or not args.quiet:
        # a refined solution is the df64 pair: its f64 sum carries the
        # accuracy --refine computed
        xv = x.to(torch.float32) if x.dtype == torch.bfloat16 else x
        x_host = xv.cpu().numpy().astype(np.float64)
        if xl is not None:
            x_host = x_host + xl.cpu().numpy().astype(np.float64)
        _emit_solution(args, x_host)
    return 0


def _emit_solution(args, x, perm=None) -> None:
    """``--output FILE`` writes a binary array vector (readable with
    ``read_mtx(binary=True)``) regardless of ``--quiet``; otherwise the
    text form goes to stdout unless ``--quiet``.  ``perm`` (the
    ``.perm.mtx`` sidecar) maps the rows back to the original order; a
    batched ``(n, B)`` block is written as one dense array file with B
    columns (``acg_tpu/cli.py:2245-2266``)."""
    if args.output is None and args.quiet:
        return
    from acg_tpu_torch.io.mtxfile import (multi_vector_mtx, vector_mtx,
                                          write_mtx)

    x = np.asarray(x)
    if perm is not None:
        xo = np.empty_like(x)
        xo[perm] = x
        x = xo
    wrap = (multi_vector_mtx if x.ndim == 2 and x.shape[1] > 1
            else lambda v: vector_mtx(np.asarray(v).reshape(-1)))
    if args.output is not None:
        write_mtx(args.output, wrap(np.asarray(x, np.float64)),
                  binary=True)
    else:
        write_mtx(sys.stdout.buffer, wrap(x), numfmt=args.numfmt)


def _load_perm_sidecar(matrix_path: str, n: int):
    """The permuted-to-original row map written by ``mtx2bin
    --partition``, or None (``acg_tpu/cli.py:2269``).  A sidecar whose
    size disagrees with the matrix is stale (e.g. the matrix was
    regenerated for a different size at the same path): fail loudly
    rather than scramble the output."""
    import os

    from acg_tpu_torch.io.mtxfile import read_mtx

    path = matrix_path + ".perm.mtx"
    if not os.path.exists(path):
        return None
    perm = np.asarray(read_mtx(path, binary=True).vals
                      ).reshape(-1).astype(np.int64) - 1
    if perm.size != n or (np.sort(perm) != np.arange(n)).any():
        raise SystemExit(
            f"acg-tpu-torch: {path} is not a permutation of {n} rows -- "
            f"stale sidecar from an earlier mtx2bin run?  Regenerate with "
            f"mtx2bin --expand [--partition] or delete it")
    return perm


def _read_vector(path, binary, n, what):
    from acg_tpu_torch.io.mtxfile import read_mtx

    v = np.asarray(read_mtx(path, binary=binary).vals,
                   dtype=np.float64).reshape(-1)
    if v.size != n:
        raise SystemExit(f"acg-tpu-torch: {what} has {v.size} entries, "
                         f"need {n}")
    return v


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--buildinfo" in argv:
        return _buildinfo(sys.stdout)
    args = make_parser().parse_args(argv)
    args.numfmt = _validate_numfmt(args.numfmt)
    from acg_tpu_torch.errors import AcgError

    try:
        return _main(args)
    except (OSError, AcgError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        return 1


def _main(args) -> int:
    from acg_tpu_torch._device import resolve_device
    from acg_tpu_torch.errors import (AcgError, BreakdownError,
                                      NotConvergedError)
    from acg_tpu_torch.io.mtxfile import read_mtx
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.cg import TorchCGSolver
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    # stage 0: the device, before anything expensive (the reference's
    # validation order)
    _validate_precision(args)
    _validate_algorithm(args)
    _validate_batched(args)
    _validate_operator(args)
    try:
        device = resolve_device(args.device)
    except AcgError as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        return 1
    dtype, vec_dtype = DTYPES[args.dtype]
    phases = {}

    # stage 1: read (or synthesize) the matrix
    t_ingest = time.perf_counter()
    if args.A.startswith("gen:"):
        kind, dim, n, N, _ = _parse_gen_spec(args.A)
        if (kind == "poisson" and N > _gen_direct_min()
                and args.aniso is None):
            # too large for the host matrix: the gen-direct tier (the
            # aniso family keeps the host route, as in acg_tpu)
            return _solve_generated_direct(args, dim, n, N, device, dtype,
                                           vec_dtype)
        t0 = time.perf_counter()
        _log(args, f"synthesizing {args.A} (N={N})")
        A = synthesize_host_matrix(args.A, aniso=args.aniso, seed=args.seed)
        _log(args, "synthesize matrix:", t0)
    else:
        t0 = time.perf_counter()
        _log(args, f"reading matrix from {args.A}")
        try:
            A = SymCsrMatrix.from_mtx(read_mtx(args.A, binary=args.binary))
        except AcgError as e:
            raise SystemExit(f"acg-tpu-torch: {args.A}: {e}")
        _log(args, "read matrix:", t0)

    # stage 2: assemble symmetric CSR
    t0 = time.perf_counter()
    csr = A.to_csr(epsilon=args.epsilon)
    _log(args, "assemble symmetric CSR:", t0)
    phases["ingest"] = time.perf_counter() - t_ingest
    n = A.nrows
    # partition-permuted input (mtx2bin --partition): the matrix on disk
    # is P A P^T, but b, x0 and the printed solution stay in the
    # original row order
    perm = (None if args.A.startswith("gen:")
            else _load_perm_sidecar(args.A, n))

    # stage 3: partition rows (cli.py:3348-3382)
    comm = args.comm
    nparts = args.nparts or _default_nparts(device)
    t0 = time.perf_counter()
    part = _partition(args, csr, n, nparts)
    if args.partition:
        nparts = max(nparts, int(part.max()) + 1)
    _log(args, f"partition rows into {nparts} parts:", t0)
    phases["partition"] = time.perf_counter() - t0

    # stage 4: right-hand side and initial guess
    rng = np.random.default_rng(args.seed)
    xsol = None
    x0 = None
    if args._batched:
        # one column per system: an n x B dense array file, a
        # manufactured block, or B seeded random unit columns
        from acg_tpu_torch.io.generators import batched_rhs
        from acg_tpu_torch.io.mtxfile import vector_columns
        if args.manufactured_solution:
            xsol = rng.standard_normal((n, args.nrhs))
            xsol /= np.linalg.norm(xsol, axis=0, keepdims=True)
            # one multi-column product through the shifted CSR: each
            # column is A.dsymv's, bit for bit
            b = csr @ xsol
        elif args.b:
            b = vector_columns(read_mtx(args.b, binary=args.binary), n,
                               args.nrhs)
            if perm is not None:
                b = b[perm]
        else:
            b = batched_rhs(n, args.nrhs, seed=args.seed)
        if args.x0:
            x0 = vector_columns(read_mtx(args.x0, binary=args.binary), n,
                                args.nrhs)
            if perm is not None:
                x0 = x0[perm]
    else:
        if args.manufactured_solution:
            # random unit-norm solution; b = A*xsol via the host SpMV
            xsol = rng.standard_normal(n)
            xsol /= np.linalg.norm(xsol)
            b = A.dsymv(xsol, epsilon=args.epsilon)
        elif args.b:
            b = _read_vector(args.b, args.binary, n, "b")
            if perm is not None:
                b = b[perm]
        else:
            b = np.ones(n)
        if args.x0:
            x0 = _read_vector(args.x0, args.binary, n, "x0")
            if perm is not None:
                x0 = x0[perm]
    criteria = StoppingCriteria(
        maxits=args.max_iterations,
        residual_atol=args.residual_atol, residual_rtol=args.residual_rtol,
        diff_atol=args.diff_atol, diff_rtol=args.diff_rtol)

    # stages 6-8: device matrix, solver, solve
    host = args.solver in ("host", "host-native", "petsc")
    if args.replace_every and host:
        sys.stderr.write("acg-tpu-torch: --replace-every applies to the "
                         "device bf16 solvers (use --refine for "
                         "f64-grade accuracy on host paths)\n")
        return 1
    if args.replace_every and (args.diff_atol > 0 or args.diff_rtol > 0):
        sys.stderr.write("acg-tpu-torch: --replace-every supports residual "
                         "criteria only (--diff-atol/--diff-rtol have no "
                         "meaning across replacement segments)\n")
        return 1
    t0 = time.perf_counter()
    pipelined = "pipelined" in args.solver
    comm_mtx = None
    if host:
        # the host oracles (acg_tpu/cli.py:3495-3565): numpy, the native
        # C++ core and scipy compute on the host by definition
        solver = _host_solver(args, csr, part, nparts, comm, pipelined)
        if solver is None:
            return 1
    elif args._batched and not (comm == "none" or nparts == 1):
        # B columns on stacked parts (acg_tpu/cli.py:3597-3616)
        if args.block_cg:
            raise SystemExit(
                "acg-tpu-torch: --block-cg is a single-device tier (its "
                "B x B Gram solves are not distributed); use --nparts "
                "1/--comm none, or drop --block-cg for the batched mesh "
                "tier")
        from acg_tpu_torch.graph import partition_matrix
        from acg_tpu_torch.parallel.dist import DistributedProblem
        from acg_tpu_torch.parallel.dist_batched import BatchedDistCGSolver

        subs = partition_matrix(csr, part, nparts)
        prob = DistributedProblem.build(csr, part, nparts, dtype=dtype,
                                        subs=subs, vector_dtype=vec_dtype)
        try:
            solver = BatchedDistCGSolver(prob, pipelined=pipelined,
                                         precise_dots=args.precise_dots,
                                         precond=args._precond,
                                         device=device)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    elif args._batched:
        # B columns, one batched solve (acg_tpu/cli.py:3566-3596)
        from acg_tpu_torch.solvers.batched import BatchedCGSolver
        mode = ("block" if args.block_cg
                else "pipelined" if pipelined else "batched")
        if args._operator_spec is not None:
            # matrix-free batched: spmv_multi takes the operator's
            # multi-column apply
            dev = _build_cli_operator(args, n, dtype, device)
        else:
            dev = device_matrix_from_csr(csr, dtype=dtype,
                                         format=args.spmv_format,
                                         device=device)
            _log(args, f"device matrix: {type(dev).__name__} "
                       f"(--spmv-format {args.spmv_format})")
        try:
            solver = BatchedCGSolver(dev, mode=mode,
                                     precise_dots=args.precise_dots,
                                     vector_dtype=vec_dtype,
                                     precond=args._precond, device=device)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    elif comm == "none" or nparts == 1:
        if args._operator_spec is not None:
            # matrix-free: the operator is the device matrix
            dev = _build_cli_operator(args, n, dtype, device)
        else:
            dev = device_matrix_from_csr(csr, dtype=dtype,
                                         format=args.spmv_format,
                                         device=device)
            _log(args, f"device matrix: {type(dev).__name__} "
                       f"(--spmv-format {args.spmv_format})")
        try:
            solver = TorchCGSolver(dev, pipelined=pipelined,
                                   kernels=args.kernels,
                                   vector_dtype=vec_dtype, device=device,
                                   **_solver_options(args))
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    else:
        from acg_tpu_torch.graph import comm_matrix, partition_matrix
        from acg_tpu_torch.parallel.dist import (DistCGSolver,
                                                 DistributedProblem,
                                                 resolve_comm)

        subs = partition_matrix(csr, part, nparts)
        if args.output_comm_matrix:
            comm_mtx = comm_matrix(subs, nparts)
        prob = DistributedProblem.build(csr, part, nparts, dtype=dtype,
                                        subs=subs, vector_dtype=vec_dtype)
        if args._operator_spec is not None:
            # matrix-free on the stacked parts: generated local planes
            # behind the same halo plan and ghost block
            from acg_tpu_torch.parallel.dist import arm_matfree
            arm_matfree(prob, _build_cli_operator(args, n, dtype, device))
        try:
            solver = DistCGSolver(prob, pipelined=pipelined,
                                  comm=resolve_comm(comm),
                                  kernels=args.kernels, device=device,
                                  **_solver_options(args))
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    if args.refine and not host:
        # the device solver inside the f64 host refinement loop
        from acg_tpu_torch.solvers.refine import RefinedSolver
        solver = RefinedSolver(solver, csr, inner_rtol=args.refine_rtol,
                               inner_maxits=args.refine_inner_maxits)
    solver.stats.timings.update(phases)
    # the host oracles run once: no warm-up solves
    solve_kw = {} if host else {"warmup": args.warmup}
    try:
        x = solver.solve(b, x0=x0, criteria=criteria, **solve_kw)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _fold_inner_timings(solver)
        solver.stats.fwrite(sys.stderr)
        return 1
    _fold_inner_timings(solver)
    _log(args, "solve:", t0)
    if solver.stats.batch:
        _log(args, f"batch: per-RHS iterations "
                   f"{solver.stats.batch['iterations']}")

    # stage 9: statistics block (grep-compatible with the reference)
    solver.stats.fwrite(sys.stderr)
    if xsol is not None:
        x0ref = x0 if x0 is not None else np.zeros_like(xsol)
        sys.stderr.write(f"initial error 2-norm: "
                         f"{np.linalg.norm(x0ref - xsol):.15g}\n")
        sys.stderr.write(f"error 2-norm: "
                         f"{np.linalg.norm(np.asarray(x) - xsol):.15g}\n")
        if xsol.ndim == 2 and xsol.shape[1] > 1:
            per = np.linalg.norm(np.asarray(x) - xsol, axis=0)
            sys.stderr.write(f"worst per-RHS error 2-norm: "
                             f"{float(per.max()):.15g} "
                             f"(rhs {int(per.argmax())})\n")

    # stage 10: communication matrix and solution output
    if comm_mtx is not None:
        _write_comm_matrix(comm_mtx, nparts)
    _emit_solution(args, x, perm)
    return 0


def _host_solver(args, csr, part, nparts: int, comm: str, pipelined: bool):
    """The ``--solver host|host-native|petsc`` oracle for this solve, or
    None (after the error message) when the native core is missing.  A
    multi-part ``host`` solve (``--nparts N > 1``) runs the subdomain
    oracle, which has no preconditioner hook."""
    from acg_tpu_torch.errors import AcgError, ErrorCode

    if args.solver == "host-native":
        from acg_tpu_torch.solvers.host_cg import NativeHostCGSolver
        try:
            return NativeHostCGSolver(csr)
        except RuntimeError as e:
            sys.stderr.write(f"acg-tpu-torch: {e}\n")
            return None
    if args.solver == "petsc":
        from acg_tpu_torch.solvers.petsc_cg import PetscBaselineSolver
        return PetscBaselineSolver(csr, pipelined=pipelined)
    if nparts > 1 and comm != "none":
        from acg_tpu_torch.graph import partition_matrix
        from acg_tpu_torch.solvers.host_cg import HostDistCGSolver
        if args._precond is not None:
            # silently running unpreconditioned CG would not be the solve
            # that was asked for
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "--precond has no hooks in the multi-part host solver; "
                "use --nparts 1 or the device solvers")
        return HostDistCGSolver(partition_matrix(csr, part, nparts))
    from acg_tpu_torch.solvers.host_cg import HostCGSolver
    return HostCGSolver(csr, precond=args._precond)


def _default_nparts(device: torch.device) -> int:
    """The part count when ``--nparts`` is not given: 1, whatever the
    device and however many cards the host has.  ``acg_tpu`` takes one
    part per device (``cli.py:3348-3352``) and places each part on its
    own; the port stacks every part on ``device``, where k stacked parts
    only run slower than one, so it keeps one part until each part can
    have a card of its own."""
    return 1


def _partition(args, csr, n: int, nparts: int) -> np.ndarray:
    """The row partition: ``--partition FILE`` (0- or 1-based), else
    ``partition_rows`` with the ``--partition-method`` (``auto`` = band
    for matrices that prefer DIA storage, graph otherwise)."""
    from acg_tpu_torch.errors import AcgError
    from acg_tpu_torch.io.mtxfile import read_mtx
    from acg_tpu_torch.ops.spmv import prefers_dia
    from acg_tpu_torch.partition import partition_rows

    if args.partition:
        try:
            pmtx = read_mtx(args.partition, binary=args.partition_binary)
        except AcgError as e:
            raise SystemExit(f"acg-tpu-torch: {args.partition}: {e}")
        part = np.asarray(pmtx.vals, dtype=np.int64).reshape(-1)
        if part.size != n:
            raise SystemExit(f"acg-tpu-torch: partition vector has "
                             f"{part.size} entries, matrix has {n} rows")
        if part.min() == 1 and part.max() == nparts:
            part = part - 1  # tolerate 1-based partition vectors
        return part.astype(np.int32)
    method = args.partition_method
    if method == "auto":
        method = "band" if nparts > 1 and prefers_dia(csr) else "graph"
    try:
        return partition_rows(csr, nparts, seed=args.seed, method=method)
    except AcgError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")


def _write_comm_matrix(M: np.ndarray, nparts: int) -> None:
    """Part-to-part communication volumes to stdout as Matrix Market
    (``--output-comm-matrix``, ``cuda/acg-cuda.c:1712-1780``)."""
    from acg_tpu_torch.io.mtxfile import MtxFile, write_mtx

    nz = np.nonzero(M)
    write_mtx(sys.stdout.buffer, MtxFile(
        object="matrix", format="coordinate", field="integer",
        symmetry="general", nrows=nparts, ncols=nparts,
        nnz=len(nz[0]), rowidx=nz[0], colidx=nz[1],
        vals=M[nz]), numfmt="%d")


if __name__ == "__main__":
    sys.exit(main())
