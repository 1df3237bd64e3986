"""Text-to-binary Matrix Market converter (the reference's ``mtx2bin``).

A copy of ``acg_tpu/tools/mtx2bin.py``: the same flags and the same
output bytes, sidecars included.

Converts a text or gzipped ``.mtx`` file to the raw-binary form (same
header text; data section as consecutive rowidx/colidx/vals arrays,
``mtx2bin/mtx2bin.c:538-547``) for fast re-reading at scale -- the de facto
checkpoint of the preprocessing pipeline (SURVEY.md section 5).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="acg-tpu-torch-mtx2bin",
        description="Convert a Matrix Market file to binary form.")
    p.add_argument("input", help="text or gzipped .mtx file")
    p.add_argument("output", nargs="?", default=None,
                   help="output path (default: stdout)")
    p.add_argument("--expand", action="store_true",
                   help="expand symmetric one-triangle storage to full "
                        "storage and sort entries by row: the layout "
                        "required for per-controller RANGE reads "
                        "(read_mtx_row_range) at pod scale -- each "
                        "controller then reads only its rows")
    p.add_argument("--partition", metavar="FILE", default=None,
                   help="with --expand: apply a partition vector "
                        "(mtxpartition output) by symmetrically "
                        "permuting the matrix so each part's rows are "
                        "contiguous -- arbitrary METIS/graph partitions "
                        "then ride the band range-read ingest "
                        "(--distributed-read) unchanged.  Writes two "
                        "sidecars next to OUTPUT: OUTPUT.bounds.mtx "
                        "(nparts+1 part boundaries, for the "
                        "distributed read) and OUTPUT.perm.mtx "
                        "(permuted-to-original row map, applied "
                        "automatically to solution output)")
    p.add_argument("--partition-binary", action="store_true",
                   help="the --partition file is binary")
    nb = p.add_mutually_exclusive_group()
    nb.add_argument("--one-based", action="store_true",
                    help="the --partition vector numbers parts from 1 "
                         "(Fortran/METIS one-based output); shifted to "
                         "0-based before applying")
    nb.add_argument("--zero-based", action="store_true",
                    help="the --partition vector numbers parts from 0; "
                         "only needed when its minimum part is 1 (an "
                         "empty part 0), which is otherwise ambiguous "
                         "with one-based numbering and a hard error")
    # reference-parity flags (mtx2bin/mtx2bin.c:367-387)
    dt = p.add_mutually_exclusive_group()
    dt.add_argument("--double", dest="datatype", action="store_const",
                    const="real", help="treat values as double (real)")
    dt.add_argument("--integer", dest="datatype", action="store_const",
                    const="integer", help="treat values as integers")
    from acg_tpu_torch.tools import add_parity_flags, apply_quiet
    add_parity_flags(p, "acg-tpu-torch-mtx2bin")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)
    apply_quiet(args)

    import numpy as np

    from acg_tpu_torch.io.mtxfile import (apply_partition_rowsorted,
                                    expand_to_rowsorted_full, read_mtx,
                                    vector_mtx, write_mtx)

    if args.partition and not args.expand:
        p.error("--partition requires --expand (range reads need "
                "row-sorted full storage)")
    if args.partition and not args.output:
        p.error("--partition requires an OUTPUT path (the bounds/perm "
                "sidecars are named after it)")

    t0 = time.perf_counter()
    mtx = read_mtx(args.input)
    if args.datatype and args.datatype != mtx.field:
        # reference --double/--integer: force the value datatype.
        # Pattern matrices have implicit unit values -- materialise them
        # (flipping the field while leaving vals=None would write a
        # value-typed header with no value bytes: a malformed file)
        import dataclasses
        vdt = np.float64 if args.datatype == "real" else np.int32
        vals = (np.ones(mtx.nnz, dtype=vdt) if mtx.vals is None
                else np.asarray(mtx.vals).astype(vdt))
        mtx = dataclasses.replace(mtx, field=args.datatype, vals=vals)
    if args.verbose:
        sys.stderr.write(f"read: {time.perf_counter() - t0:.6f} s "
                         f"({mtx.nrows}x{mtx.ncols}, {mtx.nnz} nnz)\n")
    if args.expand:
        mtx = expand_to_rowsorted_full(mtx)
        if args.verbose:
            sys.stderr.write(f"expand: full storage, {mtx.nnz} nnz\n")
    if args.output and not args.partition:
        # remove stale sidecars from an earlier --partition run to the
        # same path: a leftover perm/bounds pair would silently reorder
        # solutions of the now-unpermuted matrix
        import os
        for ext in (".bounds.mtx", ".perm.mtx"):
            if os.path.exists(args.output + ext):
                os.remove(args.output + ext)
                if args.verbose:
                    sys.stderr.write(f"removed stale {args.output}{ext}\n")
    if args.partition:
        pmtx = read_mtx(args.partition, binary=args.partition_binary)
        part = np.asarray(pmtx.vals).reshape(-1).astype(np.int64)
        if args.one_based:
            if part.size and part.min() < 1:
                p.error(f"--one-based given but the partition vector "
                        f"contains part {part.min()}")
            part = part - 1
        elif part.size and part.min() == 1 and not args.zero_based:
            # ambiguous: could be a 1-based vector OR a 0-based one
            # whose part 0 happens to be empty.  Guessing silently
            # renumbered every part (round-4 advisor finding), and the
            # round-5 advice upgraded the easy-to-miss warning to a
            # hard error: the two readings permute the matrix
            # differently, so the user must say which they mean.
            p.error(
                "partition vector has min part 1: ambiguous between "
                "one-based numbering (Fortran/METIS) and 0-based with "
                "an empty part 0 -- rerun with --one-based or "
                "--zero-based")
        t0 = time.perf_counter()
        mtx, bounds, perm = apply_partition_rowsorted(mtx, part)
        write_mtx(args.output + ".bounds.mtx",
                  vector_mtx(bounds, field="integer"), numfmt="%d")
        write_mtx(args.output + ".perm.mtx",
                  vector_mtx(perm + 1, field="integer"), binary=True)
        if args.verbose:
            sys.stderr.write(
                f"partition: {bounds.size - 1} parts grouped contiguous "
                f"in {time.perf_counter() - t0:.6f} s; sidecars "
                f"{args.output}.bounds.mtx, {args.output}.perm.mtx\n")
    t0 = time.perf_counter()
    if args.output:
        write_mtx(args.output, mtx, binary=True)
    else:
        write_mtx(sys.stdout.buffer, mtx, binary=True)
    if args.verbose:
        sys.stderr.write(f"write: {time.perf_counter() - t0:.6f} s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
