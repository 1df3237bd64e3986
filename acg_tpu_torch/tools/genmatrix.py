"""Model-problem matrix generator (the reference's ``matrices_generator``).

Writes 2D (5-point) or 3D (7-point) Poisson matrices in Matrix Market
format (a copy of ``acg_tpu/tools/genmatrix.py``: the same output
bytes), e.g. ``python -m acg_tpu_torch.tools.genmatrix --dim 2 -n 2048 -o
poisson2d_n2048.mtx`` reproduces the reference benchmark matrix
(``matrices_generator/poisson.py``, N=4,194,304).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="acg-tpu-torch-genmatrix",
                                description="Generate Poisson test matrices.")
    p.add_argument("-n", type=int, required=True,
                   help="grid points per side (poisson) or rows (irregular)")
    p.add_argument("--kind", default="poisson",
                   choices=["poisson", "irregular"],
                   help="poisson = banded stencil; irregular = power-law "
                        "random SPD (the SuiteSparse-workload stand-in)")
    p.add_argument("--dim", type=int, default=2, choices=[2, 3])
    p.add_argument("--avg-degree", type=float, default=16.0,
                   help="mean row degree for --kind irregular")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default=None,
                   help="output path (default: poisson{dim}d_n{n}.mtx)")
    p.add_argument("--binary", action="store_true", help="write binary format")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)

    from acg_tpu_torch.io.generators import irregular_mtx, poisson_mtx
    from acg_tpu_torch.io.mtxfile import write_mtx

    t0 = time.perf_counter()
    if args.kind == "irregular":
        mtx = irregular_mtx(args.n, avg_degree=args.avg_degree,
                            seed=args.seed)
        out = args.output or f"irregular_n{args.n}.mtx"
    else:
        mtx = poisson_mtx(args.n, dim=args.dim)
        out = args.output or f"poisson{args.dim}d_n{args.n}.mtx"
    write_mtx(out, mtx, binary=args.binary)
    if args.verbose:
        sys.stderr.write(
            f"generated {out}: {mtx.nrows}x{mtx.ncols} matrix, "
            f"{mtx.nnz} stored nonzeros in {time.perf_counter() - t0:.3f} s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
