"""The ``python -m acg_tpu_torch`` CLI driver: the single-device main path.

The counterpart of ``acg_tpu/cli.py`` for one device: read or generate
the matrix, assemble the symmetric CSR, build the right-hand side
(optionally a manufactured solution), choose the device format, run
:class:`~acg_tpu_torch.solvers.cg.TorchCGSolver`, print the statistics
block to stderr and write the solution.  Flag names and defaults follow
the JAX package's CLI; flags of tiers the port does not have yet
(``--nparts``, ``--precond``, ``--serve``, ...) are not accepted.

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
exits with an error instead of solving on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# rows above which the JAX package's gen: specs assemble DIA planes on
# the device without a host matrix (acg_tpu/cli.py:_gen_direct_min)
GEN_DIRECT_MIN = 2 ** 24

DTYPES = {"f64": (torch.float64, torch.float64),
          "f32": (torch.float32, torch.float32),
          "mixed": (torch.bfloat16, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16)}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="acg-tpu-torch",
        description="Conjugate gradient solver for symmetric positive "
                    "definite linear systems Ax=b on one CUDA device "
                    "(PyTorch port of acg-tpu, single-device tier).")
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
                        "pallas = the hand-written CUDA DIA SpMV (and the "
                        "pipelined update kernel); fused = classic CG on "
                        "the two-phase kernel pair; auto = the hand "
                        "kernels for DIA matrices on CUDA (every dtype)")
    p.add_argument("--spmv-format", default="auto",
                   choices=["auto", "dia", "ell", "coo"],
                   help="force the device sparse format; auto picks by "
                        "sparsity structure")
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


def synthesize_host_matrix(spec_str: str, seed: int = 42):
    """``gen:`` spec -> host :class:`~acg_tpu_torch.matrix.SymCsrMatrix`."""
    from acg_tpu_torch.io.generators import (irregular_spd_coo,
                                             poisson2d_coo, poisson3d_coo)
    from acg_tpu_torch.matrix import SymCsrMatrix

    kind, dim, n, N, avg = _parse_gen_spec(spec_str)
    if kind == "poisson":
        r, c, v, N = (poisson2d_coo if dim == 2 else poisson3d_coo)(n)
    else:
        r, c, v, N = irregular_spd_coo(n, avg_degree=avg, seed=seed)
    return SymCsrMatrix.from_coo(N, r, c, v)


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
    try:
        return _main(args)
    except OSError as e:
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
        if kind == "poisson" and N > GEN_DIRECT_MIN:
            raise SystemExit(
                f"acg-tpu-torch: {args.A}: N={N:,} rows is above "
                f"{GEN_DIRECT_MIN:,}, where acg-tpu assembles the DIA "
                f"planes directly on the device (the gen-direct tier); "
                f"that tier is not yet ported -- use N <= "
                f"{GEN_DIRECT_MIN:,}")
        t0 = time.perf_counter()
        _log(args, f"synthesizing {args.A} (N={N})")
        A = synthesize_host_matrix(args.A, seed=args.seed)
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
    # one part: every row belongs to part 0 (the JAX package's
    # partition stage with nparts = 1)
    phases["partition"] = 0.0

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
    dev = device_matrix_from_csr(csr, dtype=dtype, format=args.spmv_format,
                                 device=device)
    try:
        solver = TorchCGSolver(dev, pipelined="pipelined" in args.solver,
                               kernels=args.kernels, vector_dtype=vec_dtype,
                               device=device)
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

    # stage 10: solution output
    _emit_solution(args, x)
    return 0


if __name__ == "__main__":
    sys.exit(main())
