"""Offline row-partitioning tool (the reference's ``mtxpartition``).

A copy of ``acg_tpu/tools/mtxpartition.py``: the same flags and the same
output bytes.

Reads a symmetric matrix, computes a balanced low-edge-cut row partition
(METIS if present, built-in otherwise), and writes the partition vector as
a ``vector array integer general`` Matrix Market file -- the same shape the
reference writes (``mtxpartition/mtxpartition.c:721``) and the CLI's
``--partition`` flag consumes (``cuda/acg-cuda.c:1542-1677``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="acg-tpu-torch-mtxpartition",
        description="Partition the rows of a symmetric sparse matrix.")
    p.add_argument("A", help="matrix in Matrix Market format")
    p.add_argument("--parts", type=int, default=2, metavar="N",
                   help="number of parts (default: 2)")
    p.add_argument("--seed", type=int, default=0, help="random seed")
    p.add_argument("--binary", action="store_true",
                   help="matrix file is in binary Matrix Market format")
    p.add_argument("--output-binary", action="store_true",
                   help="write the partition vector in binary format")
    p.add_argument("--use-metis", default="auto",
                   choices=["auto", "never", "require"],
                   help="METIS usage policy (default: auto-detect)")
    p.add_argument("--method", default="graph", choices=["graph", "band"],
                   help="graph = edge-cut minimisation; band = contiguous "
                        "nnz-balanced row ranges (keeps banded matrices DIA)")
    p.add_argument("--variant", default="kway",
                   choices=["kway", "recursive"],
                   help="METIS algorithm (METIS_PartGraphKway or "
                        "METIS_PartGraphRecursive, metis.h:39-43)")
    p.add_argument("--numfmt", default="%d", metavar="FMT",
                   help="output number format (reference flag; default "
                        "%%d)")
    from acg_tpu_torch.tools import add_parity_flags, apply_quiet
    add_parity_flags(p, "acg-tpu-torch-mtxpartition")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)
    apply_quiet(args)

    from acg_tpu_torch.io.mtxfile import MtxFile, read_mtx, write_mtx
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.partition import edgecut, partition_rows

    t0 = time.perf_counter()
    mtx = read_mtx(args.A, binary=args.binary)
    A = SymCsrMatrix.from_mtx(mtx)
    csr = A.to_csr()
    if args.verbose:
        sys.stderr.write(f"read+assemble: {time.perf_counter() - t0:.6f} s\n")

    t0 = time.perf_counter()
    part = partition_rows(csr, args.parts, seed=args.seed,
                          use_metis=args.use_metis, method=args.method,
                          variant=args.variant)
    if args.verbose:
        sys.stderr.write(
            f"partition into {args.parts} parts: "
            f"{time.perf_counter() - t0:.6f} s, "
            f"edge cut {edgecut(csr, part):,}\n")

    out = MtxFile(object="vector", format="array", field="integer",
                  symmetry="general", nrows=part.size, ncols=1,
                  nnz=part.size, vals=part.astype(np.int32))
    write_mtx(sys.stdout.buffer, out, binary=args.output_binary,
              numfmt=args.numfmt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
