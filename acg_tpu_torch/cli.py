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
(the single-device gen-direct tier).  Flag names and defaults follow the
JAX package's CLI; flags of tiers the port does not have yet
(``--precond``, ``--serve``, ...) are not accepted.

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
exits with an error instead of solving on the CPU.
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
                            "acg-pipelined-device"],
                   help="solver variant (default: acg); the -device names "
                        "run the same solvers")
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
    return p


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
            (f"--dtype {args.dtype} (operators generate plane values "
             f"in the storage dtype; bf16 has no matrix traffic left "
             f"to halve)", args.dtype in ("bf16", "mixed")),
            (f"--spmv-format {args.spmv_format} (forcing an assembled "
             f"device format contradicts matrix-free)",
             args.spmv_format != "auto"),
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
        ("b/x0 input files", bool(args.b or args.x0)),
        ("--output-comm-matrix", args.output_comm_matrix),
        (f"--spmv-format {args.spmv_format}",
         args.spmv_format not in ("auto", "dia")),
    ] if on]
    if unsupported:
        raise SystemExit(
            f"acg-tpu-torch: {args.A}: direct on-device assembly "
            f"(N={N:,} rows) does not support: {', '.join(unsupported)} "
            f"(these need a host-side matrix; use a file or a smaller "
            f"gen: spec)")
    sharded = [flag for flag, on in [
        (f"--nparts {args.nparts}", args.nparts > 1),
        ("--manufactured-solution", args.manufactured_solution),
    ] if on]
    if sharded:
        raise SystemExit(
            f"acg-tpu-torch: {args.A} (N={N:,} rows) with "
            f"{', '.join(sharded)}: the sharded gen-direct tier "
            f"(parallel/sharded_dia) is not yet ported; solve on one "
            f"part with b = ones, or raise ACG_TPU_GEN_DIRECT_MIN above N")

    t0 = time.perf_counter()
    if args._operator_spec is not None:
        # matrix-free at gen-direct sizes: nothing is assembled at all
        A = _build_cli_operator(args, N, dtype, device)
        _log(args, f"gen-direct: {args.A} (N={N}) as the operator "
                   f"{A.identity()}, no host matrix:", t0)
    else:
        planes, offsets, _ = poisson_dia_device(n, dim, dtype=dtype,
                                                device=device)
        if args.epsilon:
            d = offsets.index(0)
            planes[d] += torch.tensor(args.epsilon, dtype=dtype,
                                      device=device)
        A = DiaMatrix(data=planes, offsets=offsets, nrows=N, ncols_padded=N)
        _log(args, f"gen-direct: {args.A} (N={N}) DIA planes assembled on "
                   f"the device, no host matrix:", t0)
    ingest = time.perf_counter() - t0
    try:
        solver = TorchCGSolver(A, pipelined="pipelined" in args.solver,
                               kernels=args.kernels, vector_dtype=vec_dtype,
                               device=device)
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


def _emit_solution(args, x) -> None:
    """``--output FILE`` writes a binary array vector (readable with
    ``read_mtx(binary=True)``) regardless of ``--quiet``; otherwise the
    text form goes to stdout unless ``--quiet``."""
    if args.output is None and args.quiet:
        return
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx

    x = np.asarray(x).reshape(-1)
    if args.output is not None:
        write_mtx(args.output, vector_mtx(np.asarray(x, np.float64)),
                  binary=True)
    else:
        write_mtx(sys.stdout.buffer, vector_mtx(x), numfmt=args.numfmt)


def _read_vector(path, binary, n, what):
    from acg_tpu_torch.io.mtxfile import read_mtx

    v = np.asarray(read_mtx(path, binary=binary).vals,
                   dtype=np.float64).reshape(-1)
    if v.size != n:
        raise SystemExit(f"acg-tpu-torch: {what} has {v.size} entries, "
                         f"need {n}")
    return v


def main(argv=None) -> int:
    args = make_parser().parse_args(sys.argv[1:] if argv is None else argv)
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

    # stage 0: the device, before anything expensive
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
        import os

        if os.path.exists(args.A + ".perm.mtx"):
            # acg-tpu maps b, x0 and x through this sidecar (written by
            # its mtx2bin --partition); solving without it would print
            # the solution in the permuted row order
            raise SystemExit(
                f"acg-tpu-torch: {args.A}.perm.mtx: partition-permuted "
                f"inputs are not supported yet; solve the unpermuted "
                f"matrix")
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

    # stage 3: partition rows (cli.py:3348-3382): every part lives on
    # the one device, so nparts defaults to the device count
    comm = args.comm
    nparts = args.nparts
    if comm == "none":
        nparts = nparts or 1
    else:
        nparts = nparts or (torch.cuda.device_count()
                            if device.type == "cuda" else 1)
    t0 = time.perf_counter()
    part = _partition(args, csr, n, nparts)
    if args.partition:
        nparts = max(nparts, int(part.max()) + 1)
    _log(args, f"partition rows into {nparts} parts:", t0)
    phases["partition"] = time.perf_counter() - t0

    # stage 4: right-hand side and initial guess
    rng = np.random.default_rng(args.seed)
    xsol = None
    if args.manufactured_solution:
        # random unit-norm solution; b = A*xsol via the host SpMV
        xsol = rng.standard_normal(n)
        xsol /= np.linalg.norm(xsol)
        b = A.dsymv(xsol, epsilon=args.epsilon)
    elif args.b:
        b = _read_vector(args.b, args.binary, n, "b")
    else:
        b = np.ones(n)
    x0 = _read_vector(args.x0, args.binary, n, "x0") if args.x0 else None
    criteria = StoppingCriteria(
        maxits=args.max_iterations,
        residual_atol=args.residual_atol, residual_rtol=args.residual_rtol,
        diff_atol=args.diff_atol, diff_rtol=args.diff_rtol)

    # stages 6-8: device matrix, solver, solve
    t0 = time.perf_counter()
    pipelined = "pipelined" in args.solver
    comm_mtx = None
    if comm == "none" or nparts == 1:
        if args._operator_spec is not None:
            # matrix-free: the operator is the device matrix
            dev = _build_cli_operator(args, n, dtype, device)
        else:
            dev = device_matrix_from_csr(csr, dtype=dtype,
                                         format=args.spmv_format,
                                         device=device)
        try:
            solver = TorchCGSolver(dev, pipelined=pipelined,
                                   kernels=args.kernels,
                                   vector_dtype=vec_dtype, device=device)
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
                                  kernels=args.kernels, device=device)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    solver.stats.timings.update(phases)
    try:
        x = solver.solve(b, x0=x0, criteria=criteria, warmup=args.warmup)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        solver.stats.fwrite(sys.stderr)
        return 1
    _log(args, "solve:", t0)

    # stage 9: statistics block (grep-compatible with the reference)
    solver.stats.fwrite(sys.stderr)
    if xsol is not None:
        x0ref = x0 if x0 is not None else np.zeros_like(xsol)
        sys.stderr.write(f"initial error 2-norm: "
                         f"{np.linalg.norm(x0ref - xsol):.15g}\n")
        sys.stderr.write(f"error 2-norm: "
                         f"{np.linalg.norm(np.asarray(x) - xsol):.15g}\n")

    # stage 10: communication matrix and solution output
    if comm_mtx is not None:
        _write_comm_matrix(comm_mtx, nparts)
    _emit_solution(args, x)
    return 0


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
