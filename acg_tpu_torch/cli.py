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
x0 and x in the original row order.  ``--multihost`` (with
``--coordinator``, ``--num-processes``, ``--process-id``) runs one
process per card: each holds its own parts, the stage boundaries are
agreed across processes, and process 0 alone prints; ``--distributed-
read`` range-reads each process's rows of a binary file and writes its
rows of ``--output``.  The observability tier (``--convergence-log``,
``--progress``, ``--stats-json``, ``--metrics-file``/``--metrics-port``,
``--status-file``/``--status-port``, ``--history``, ``--slo``/
``--fail-on-slo``, ``--profile-ops``, ``--trace``, ``--timeline``)
records the solve through :mod:`acg_tpu_torch.telemetry`,
:mod:`~acg_tpu_torch.metrics`, :mod:`~acg_tpu_torch.observatory` and
:mod:`~acg_tpu_torch.tracing`.  Flag names and defaults follow the JAX
package's CLI, every one of them.  ``--serve`` runs the solver service
(:mod:`acg_tpu_torch.serve`) in place of one solve.

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
                   help="number of parts, stacked on the device (default: "
                        "1; under --multihost one part per process, the "
                        "parts of a process stacked on its card)")
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
    # default=False: these register before their store_true partners,
    # and argparse keeps the FIRST registered default for a shared dest
    # (acg_tpu/cli.py:105-112)
    p.add_argument("--no-manufactured-solution",
                   dest="manufactured_solution", action="store_false",
                   default=False, help=argparse.SUPPRESS)
    p.add_argument("--no-output-comm-matrix",
                   dest="output_comm_matrix", action="store_false",
                   default=False, help=argparse.SUPPRESS)
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
    p.add_argument("--multihost", action="store_true",
                   help="run as one process of a multi-process solve (the "
                        "MPI_Init stage): one process per card, each "
                        "holding its parts; pass --coordinator/"
                        "--num-processes/--process-id")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-process coordinator address: process 0 "
                        "serves the run's store there (implies "
                        "--multihost)")
    p.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="total processes (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="this process's index (with --coordinator)")
    p.add_argument("--distributed-read", action="store_true",
                   help="each process range-reads only its own rows from "
                        "a row-sorted full-storage binary file (mtx2bin "
                        "--expand output; requires --binary) and builds "
                        "only its own subdomains: I/O, host memory and "
                        "preprocessing are O(local nnz); with --output "
                        "each process writes its own rows of the "
                        "solution file")
    p.add_argument("--err-timeout", type=float, default=120.0,
                   metavar="SECONDS",
                   help="multi-process error-agreement watchdog: how long "
                        "to wait at a stage boundary for the peers before "
                        "concluding one died and aborting with exit 97 "
                        "(default: 120).  Must exceed the worst arrival "
                        "skew between processes at any boundary")
    p.add_argument("--heartbeat", type=float, default=0.0,
                   metavar="SECONDS",
                   help="multi-process dead-peer detection during the "
                        "solve: each process bumps a store key from a "
                        "daemon thread and declares a peer dead after "
                        "SECONDS of silence, exiting 97 (0 = off)")
    p.add_argument("--recover", action="store_true",
                   help="arm breakdown detection and bounded restart "
                        "recovery in the solve loops: a non-finite "
                        "residual or non-positive p^T A p exits the "
                        "loop, the solver restarts from the recomputed "
                        "true residual (--max-restarts, "
                        "--restart-backoff), falls back from the dma to "
                        "the xla halo transport, then to the host "
                        "reference solver -- every event in the stats "
                        "block")
    p.add_argument("--max-restarts", type=int, default=2, metavar="N",
                   help="with --recover/--fault-inject: bounded restarts "
                        "per solve before falling back (default: 2)")
    p.add_argument("--restart-backoff", type=float, default=0.0,
                   metavar="SECONDS",
                   help="sleep SECONDS * 2^(n-1) before the n-th restart "
                        "(default: 0 -- numerical breakdowns restart "
                        "immediately)")
    p.add_argument("--fault-inject", metavar="SPEC", default=None,
                   help="arm the deterministic fault injector "
                        "(acg_tpu_torch.faults): SITE:MODE[@ITER]"
                        "[:KEY=VAL] -- e.g. spmv:nan@7, "
                        "halo:inf@3:part=2, dot:neg@5, precond:nan@4, "
                        "sdc:flip@7, crash:exit@20, "
                        "solve:slow@10:secs=0.05.  Implies breakdown "
                        "detection; recovery knobs as with --recover.  "
                        "Exported as ACG_TPU_FAULT_INJECT")
    p.add_argument("--audit-every", type=int, default=0, metavar="K",
                   help="numerical-health tier: every K iterations the "
                        "solve loop recomputes the true residual b - Ax "
                        "through its own SpMV and carries the relative "
                        "gap ||r_true - r_rec||/||b||; the gap lands in "
                        "a 'health:' stats section, the acg_health_* "
                        "metrics and (with --convergence-log) a 'gap' "
                        "column in the trace (default 0: off)")
    p.add_argument("--gap-threshold", type=float, default=0.0,
                   metavar="G",
                   help="with --audit-every: a relative gap above G "
                        "emits an accuracy_degraded event and drives "
                        "--on-gap (default 0: record-only)")
    p.add_argument("--on-gap", default="warn",
                   choices=["warn", "replace", "abort"],
                   help="what a gap past --gap-threshold does: warn = "
                        "event only; replace = exit through the "
                        "breakdown path and restart from the "
                        "recomputed true residual (bounded by "
                        "--max-restarts); abort = fail the solve "
                        "(default: warn)")
    p.add_argument("--stall-window", type=int, default=0, metavar="N",
                   help="stagnation detector: N consecutive iterations "
                        "without residual decrease exit through the "
                        "breakdown path (with --recover: bounded "
                        "restarts; default: off).  Arms the "
                        "dot-product sign-anomaly guards too")
    p.add_argument("--abft", action="store_true",
                   help="arm the Huang-Abraham checksum-protected SpMV: "
                        "the column checksum c = A^T 1 is computed once "
                        "through the loop's own SpMV and every "
                        "--audit-every iterations sum(A p) is compared "
                        "with (c, p), so a silent corruption of the "
                        "SpMV output (sdc:flip) is detected on the "
                        "device and routed into the breakdown -> "
                        "rollback/recovery path.  Needs --audit-every K")
    p.add_argument("--abft-threshold", type=float, default=0.0,
                   metavar="T",
                   help="with --abft: relative checksum-mismatch trip "
                        "level (default 0 = 64*sqrt(n)*eps of the "
                        "scalar type)")
    p.add_argument("--ckpt", metavar="FILE", default=None,
                   help="write solver-state snapshots -- the loop carry, "
                        "iteration, tolerances, fault residue and "
                        "telemetry tail -- to FILE by atomic rename with "
                        "a checksummed header, every --ckpt-every "
                        "iterations (the solve runs as chunks of the "
                        "unchanged recurrence, bitwise an uninterrupted "
                        "classic run).  A detected breakdown rolls back "
                        "to the last snapshot before spending the "
                        "restart budget; a killed process resumes via "
                        "--resume.  Snapshots are the reference "
                        "package's format")
    p.add_argument("--ckpt-every", type=int, default=0, metavar="K",
                   help="with --ckpt: snapshot period in iterations "
                        "(also the chunk length; exactly one of "
                        "--ckpt-every/--ckpt-secs is required)")
    p.add_argument("--ckpt-secs", type=float, default=0.0, metavar="S",
                   help="with --ckpt: wall-clock snapshot cadence -- "
                        "each chunk is sized from the measured "
                        "seconds/iteration.  Mutually exclusive with "
                        "--ckpt-every")
    p.add_argument("--resume", metavar="FILE", default=None,
                   help="reconstruct the solver state from a --ckpt "
                        "snapshot (written by this package or by "
                        "acg-tpu) and continue the solve to the "
                        "original tolerance; refuses snapshots of "
                        "another tier, algorithm, preconditioner, size "
                        "or right-hand side, or with a corrupted "
                        "header.  Combine with --ckpt to keep "
                        "snapshotting")
    p.add_argument("--resume-repartition", action="store_true",
                   help="with --resume: accept a snapshot of another "
                        "partition count or tier (stacked parts <-> "
                        "one device <-> host oracle): the carry is "
                        "reassembled in global row order through the "
                        "snapshot's row-permutation sidecar and "
                        "re-sliced onto this run's partition")
    p.add_argument("--supervise", action="store_true",
                   help="elastic-recovery tier (acg_tpu_torch."
                        "supervisor): run the solve as a supervised "
                        "child process and watch the exit-code contract "
                        "(see --buildinfo): a crash (rc 94), a lost peer "
                        "(rc 86/97), a signal death or a failed solve "
                        "relaunches the child with --resume from the "
                        "last committed snapshot -- shrinking --nparts "
                        "with --resume-repartition when a peer was lost "
                        "(--shrink) -- under a bounded relaunch budget "
                        "with exponential backoff.  Needs --ckpt FILE "
                        "with a cadence; drift (rc 7) and SLO (rc 8) "
                        "verdicts pass through")
    p.add_argument("--relaunch-budget", type=int, default=3, metavar="N",
                   help="with --supervise: relaunches granted before "
                        "giving up with exit 95 (default: 3)")
    p.add_argument("--relaunch-backoff", type=float, default=1.0,
                   metavar="SECONDS",
                   help="with --supervise: sleep SECONDS * 2^(n-1) "
                        "before the n-th relaunch (default: 1)")
    p.add_argument("--shrink", default="peer-lost",
                   choices=["never", "peer-lost", "any"],
                   help="with --supervise: which failures shrink the "
                        "mesh on relaunch (halving --nparts down to "
                        "--min-parts, resuming with "
                        "--resume-repartition): peer-lost = only dead-"
                        "peer teardowns (rc 86/97; default), any = every "
                        "relaunchable failure, never = always relaunch "
                        "on the same parts")
    p.add_argument("--min-parts", type=int, default=1, metavar="M",
                   help="with --supervise: never shrink below M parts "
                        "(default: 1)")
    p.add_argument("--grow-after", type=int, default=0, metavar="N",
                   help="with --serve --supervise: grow-on-recovery -- "
                        "a shrunken daemon (a crash relaunch halved "
                        "--nparts) that stays healthy for N served "
                        "requests is relaunched back toward the "
                        "original part count (doubling --nparts, with "
                        "--resume-repartition), counted by "
                        "acg_recovery_regrows_total (default: 0 = "
                        "never grow back)")
    p.add_argument("--serve", action="store_true",
                   help="solver-service tier (acg_tpu_torch.serve): run "
                        "a long-lived daemon that owns the card and "
                        "answers POST /solve over HTTP on localhost "
                        "(JSON in/out; GET /status, /metrics, /healthz, "
                        "/requests; POST /shutdown).  The positional "
                        "matrix is preloaded into the operator cache; "
                        "each request names its own gen: operator, b "
                        "and solver knobs.  Repeated request shapes hit "
                        "the operator and program caches (zero ingest, "
                        "no warm-up -- acg_serve_cache_*), compatible "
                        "queued requests coalesce into one batched "
                        "multi-RHS solve (bitwise-equal to single "
                        "service), admission control sheds with typed "
                        "429/503 responses and downgrades before "
                        "refusing as the --slo error budget burns, and "
                        "a failed request is answered with a typed "
                        "error -- never a dead daemon.  --supervise "
                        "wraps it in the relaunch/shrink/grow ladder "
                        "(warm cache restore from --ckpt serve state); "
                        "--chaos SEED[:N] fires seeded fault schedules "
                        "at the live daemon with per-request answer "
                        "verification (exit 96 on wrong-answer-green)")
    p.add_argument("--serve-port", type=int, default=0, metavar="PORT",
                   help="with --serve: bind PORT on localhost (default "
                        "0 = OS-assigned, printed to stderr)")
    p.add_argument("--serve-queue-depth", type=int, default=16,
                   metavar="N",
                   help="with --serve: bounded request queue depth; "
                        "an arrival past it is shed with a typed 429 "
                        "(default: 16)")
    p.add_argument("--serve-coalesce", type=int, default=8, metavar="B",
                   help="with --serve: coalesce up to B compatible "
                        "queued requests into one batched multi-RHS "
                        "solve (1 disables; default: 8)")
    p.add_argument("--serve-deadline", type=float, default=60.0,
                   metavar="SECONDS",
                   help="with --serve: default per-request deadline "
                        "(a request may set its own 'timeout'); an "
                        "expired request is answered with a typed 504 "
                        "(default: 60)")
    p.add_argument("--serve-faults", action="store_true",
                   help="with --serve: honour per-request 'fault' "
                        "fields (crash / slow:S / device fault specs) "
                        "-- the chaos campaign's hook; never arm on a "
                        "production service")
    p.add_argument("--access-log", metavar="FILE", default=None,
                   help="with --serve: append one acg-tpu-access/1 "
                        "JSONL row per request (atomic line writes): "
                        "request_id, outcome, per-stage seconds "
                        "(admit/queue-wait/coalesce/cache/compile/"
                        "solve/demux/respond), cache + coalesce + "
                        "degrade + plan provenance, batch id/width "
                        "with per-RHS solve attribution.  "
                        "scripts/access_report.py renders the per-"
                        "stage p50/p95/p99 table and tail "
                        "decomposition; scripts/check_access_log.py "
                        "validates the ledger")
    p.add_argument("--chaos", metavar="SEED[:N]", default=None,
                   help="chaos campaign (acg_tpu_torch.supervisor): N "
                        "(default 20) seeded fault schedules over the "
                        "fault sites this run can fire, each through the "
                        "supervisor; every green run's true residual is "
                        "verified against a host rebuild of the matrix, "
                        "verdicts (converged / agreed-abort / "
                        "WRONG-ANSWER) to stderr and the --history "
                        "ledger.  Exit 96 if any schedule converged to "
                        "a wrong answer")
    p.add_argument("--soak", type=int, default=0, metavar="N",
                   help="soak mode: run N repeated solves of the same "
                        "system (the first carries --warmup), feed each "
                        "into the metrics registry, report p50/p95/p99 "
                        "solve latency and iterations in a 'soak:' "
                        "stats section, and arm an EWMA latency-drift "
                        "detector (see --fail-on-drift).  Single "
                        "process only")
    p.add_argument("--fail-on-drift", type=float, default=None,
                   metavar="PCT",
                   help="with --soak: exit 7 when the EWMA solve latency "
                        "drifts more than PCT percent above the "
                        "baseline window's median (default: warn-only "
                        "at 50%%)")
    p.add_argument("--convergence-log", metavar="FILE", default=None,
                   help="record per-iteration (rnrm2, alpha, beta, pAp) "
                        "in a device-side ring buffer written by the "
                        "solve loop (fetched once with the result) and "
                        "write it to FILE as JSONL: one meta line "
                        "(wrap/truncation marked), one record per "
                        "surviving iteration.  Window size: "
                        "--telemetry-window.  Render with "
                        "scripts/plot_convergence.py")
    p.add_argument("--telemetry-window", type=int, default=512,
                   metavar="N",
                   help="ring-buffer capacity (iterations) for "
                        "--convergence-log (default: 512; the trailing "
                        "N iterations survive a longer solve)")
    p.add_argument("--progress", type=int, default=0, metavar="K",
                   help="heartbeat: print the residual 2-norm to stderr "
                        "every K iterations, recorded on the device and "
                        "printed where the loop reads its convergence "
                        "flag (default: off)")
    p.add_argument("--stats-json", metavar="FILE", default=None,
                   help="write a schema-versioned machine-readable twin "
                        "of the stats block to FILE: run manifest "
                        "(backend, card, torch/CUDA versions, kernel "
                        "tier, comm transport, matrix id, partition/"
                        "halo sizes), per-op counters, phase timings, "
                        "timestamped events, the convergence trace, and "
                        "on multi-process runs the cross-rank "
                        "min/median/max + imbalance aggregation")
    p.add_argument("--metrics-file", metavar="FILE", default=None,
                   help="write the service-metrics registry (solve/"
                        "iteration counters, latency + phase "
                        "histograms, RSS/device-memory gauges) to FILE "
                        "in Prometheus text format -- atomic rename, "
                        "flushed on exit and on SIGTERM")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve GET /metrics (Prometheus text format) "
                        "on PORT from a daemon thread for the "
                        "process's lifetime (default: off)")
    p.add_argument("--status-port", type=int, default=0, metavar="PORT",
                   help="live in-flight status: serve GET /status (an "
                        "acg-tpu-status/1 JSON document: phase, "
                        "iteration, residual trail, iterations/sec, "
                        "ETA, per-part imbalance, last events) on PORT "
                        "from a daemon thread; the same port also "
                        "answers /metrics (default: off)")
    p.add_argument("--status-file", metavar="FILE", default=None,
                   help="write the acg-tpu-status/1 document to FILE "
                        "(atomic rename), refreshed on every status "
                        "update at most every 0.2 s and finalised on "
                        "exit")
    p.add_argument("--history", metavar="DIR", default=None,
                   help="run-history ledger: append this solve's "
                        "--stats-json document to a date-partitioned "
                        "JSONL ledger under DIR (one acg-tpu-history/1 "
                        "index line per solve carrying the full "
                        "document); render with "
                        "scripts/history_report.py")
    p.add_argument("--slo", metavar="SPEC", default=None,
                   help="declare per-solve service-level objectives as "
                        "latency=SECONDS,iters=N (any subset): targets "
                        "land on the metrics registry, every completed "
                        "solve is judged (breaches bump "
                        "acg_slo_breaches_total and emit slo-breach "
                        "events) and the verdict lands in an 'slo:' "
                        "stats section")
    p.add_argument("--fail-on-slo", action="store_true",
                   help="with --slo: exit 8 when any declared "
                        "objective breached during the run")
    p.add_argument("--explain", action="store_true",
                   help="performance report instead of a normal solve: "
                        "for the classic, pipelined and stacked "
                        "multi-part tiers count the operations and "
                        "hand-kernel launches an iteration dispatches, "
                        "build the static communication ledger, time a "
                        "short solve and print a roofline verdict "
                        "(HBM-, comm-, dispatch- or compute-bound; the "
                        "dispatch term is launches an iteration x the "
                        "measured launch latency)")
    p.add_argument("--commbench", nargs="?", const="-", default=None,
                   metavar="FILE",
                   help="communication observatory: microbenchmark the "
                        "stacked parts' collectives (the parts' sum, "
                        "the transposing plane copy, the roll, kernel "
                        "K6's puts dense and per ring distance), measure "
                        "the SpMV/halo/reduction segments of this case, "
                        "fit alpha-beta per kind and write the "
                        "acg-tpu-commbench/1 document to FILE ('-' or "
                        "omitted = stdout).  Alone, or with --explain "
                        "to calibrate the verdict live")
    p.add_argument("--calibration", metavar="FILE", default=None,
                   help="a saved --commbench document: --explain prices "
                        "comm from its fitted alpha-beta model and "
                        "reports predicted-vs-measured with its id; a "
                        "normal solve records the id in the --stats-json "
                        "manifest and the convergence-log meta line")
    p.add_argument("--plan", nargs="?", const="-", default=None,
                   metavar="FILE",
                   help="decision observatory: write the ranked "
                        "acg-tpu-plan/1 document (every candidate "
                        "program priced in seconds a solve; typed "
                        "reasons for pruned cells) to FILE ('-' or "
                        "omitted = stdout).  With --explain: print the "
                        "ranked table without solving; with --autotune: "
                        "record the document the decision came from")
    p.add_argument("--autotune", action="store_true",
                   help="plan the candidate programs, time the top two "
                        "by short probes and dispatch the winner instead "
                        "of the flag-selected program; the decision and "
                        "its plan-vs-actual row land in the 'plan:' "
                        "stats section and the --history ledger, where "
                        "later planned runs consult them to correct the "
                        "model")
    p.add_argument("--no-probe-cache", action="store_true",
                   help="ignore the on-disk triad-probe sidecar "
                        "(ACG_TPU_PROBE_CACHE / "
                        "~/.cache/acg-tpu/probe_cache.json) and "
                        "re-measure the bandwidth")
    p.add_argument("--profile-ops", nargs="?", const=10, type=int,
                   default=None, metavar="REPS",
                   help="fill the stats block's per-op seconds/GB/s by "
                        "replaying each op class standalone on the "
                        "solver's own kernels (best of REPS timings, "
                        "default 10; CUDA events on the card) -- the "
                        "reference's ACG_ENABLE_PROFILING tier")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="capture the solve with torch.profiler (CPU "
                        "activity, plus CUDA on the card) into "
                        "DIR/<process>.trace.json.gz.  The capture is "
                        "analysed after the solve: measured per-op-class "
                        "device seconds inside the acg:solve windows, "
                        "overlap efficiency and straggler attribution "
                        "land in the 'tracing:' stats section, and "
                        "measured seconds replace the --profile-ops "
                        "replay estimates where the capture resolves "
                        "an op class")
    p.add_argument("--timeline", metavar="FILE", default=None,
                   help="write a cross-rank span timeline of this run "
                        "as Chrome trace-event JSON (one pid per part; "
                        "load in Perfetto / chrome://tracing): the "
                        "pipeline phases and telemetry events, gathered "
                        "across processes with barrier-timestamp clock "
                        "alignment")
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
    from acg_tpu_torch.telemetry import CONVERGENCE_SCHEMA, STATS_SCHEMA

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
        ("telemetry", f"--convergence-log (device ring, "
         f"{CONVERGENCE_SCHEMA}), --progress (heartbeat at the chunk "
         f"reads), --stats-json ({STATS_SCHEMA}, phase timings + "
         f"cross-rank aggregation)"),
        ("profiling", "--profile-ops (per-op replay on the solver's "
         "kernels, CUDA-event timed; chain_overhead and dispatch), "
         "--trace (torch.profiler capture, acg:* phase annotations)"),
        ("timeline tracing", "--timeline FILE (cross-rank span "
         "timeline, Chrome trace-event JSON, one pid per part), --trace "
         "capture analysis (measured per-op-class seconds of the port's "
         "kernels, overlap efficiency, straggler attribution); "
         "'tracing' section + acg_trace_* metrics"),
        ("service metrics", "--metrics-file (Prometheus textfile, "
         "atomic rename, flushed on exit/SIGTERM), --metrics-port "
         "(stdlib /metrics endpoint)"),
        ("live observatory", "--status-port PORT / --status-file FILE "
         "(acg-tpu-status/1), --history DIR (acg-tpu-history/1 run "
         "ledger), --slo latency=S,iters=N + --fail-on-slo (exit 8)"),
        ("robustness", "--recover (restart, rollback, dma -> xla, host "
         "rungs), --fault-inject (spmv|dot|halo|precond|sdc|crash|solve), "
         "--audit-every/--stall-window/--abft (health: section), --ckpt/"
         "--resume[-repartition] (the reference's snapshot file), --soak "
         "+ --fail-on-drift (exit 7), on one process and across "
         "processes"),
        ("elastic recovery", "--supervise (process supervisor: watches "
         "the exit-code contract, relaunches with --resume -- shrinking "
         "--nparts with --resume-repartition on a lost peer -- under "
         "--relaunch-budget/--relaunch-backoff; recovery: section, "
         "acg_recovery_* metrics, status-doc degraded key), "
         "--resume-repartition (an N-part snapshot onto M parts or one "
         "device through the global row-permutation sidecar), "
         "--ckpt-secs S (wall-clock snapshot cadence)"),
        ("chaos campaign", "--chaos SEED[:N] (seeded fault schedules "
         "through the supervisor; per-schedule converged/agreed-abort/"
         "WRONG-ANSWER verdicts into the --history ledger, exit 96 on "
         "any wrong-answer-green)"),
        ("solver service", "--serve (long-lived daemon on the card: "
         "POST /solve JSON requests; GET /status /metrics /healthz "
         "/requests, POST /shutdown; operator + program caches, typed "
         "429/503/504 sheds, the --slo degrade-before-refuse ladder, "
         "--serve-coalesce B bitwise-equal batched service, typed "
         "request isolation; --serve-port/--serve-queue-depth/"
         "--serve-deadline/--serve-faults), --serve --supervise (warm "
         "operator-cache restore from --ckpt serve state; --grow-after "
         "N), --serve --chaos SEED[:N] (live campaign, exit 96 on "
         "wrong-answer-green); acg_serve_* metric families"),
        ("request observatory", "request ids (client request_id, "
         "traceparent or generated), --access-log FILE "
         "(acg-tpu-access/1 JSONL, per-stage seconds and provenance), "
         "--serve --timeline FILE (worker row + request lanes), GET "
         "/requests, acg_serve_stage_seconds{stage}"),
    ]
    for k, v in rows:
        out.write(f"{k}: {v}\n")
    from acg_tpu_torch.errors import exit_code_table
    out.write("exit codes:\n")
    for code, origin, meaning in exit_code_table():
        out.write(f"  {code:>3}  [{origin}] {meaning}\n")
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
                                             poisson_packed_upper)
    from acg_tpu_torch.matrix import SymCsrMatrix

    kind, dim, n, N, avg = _parse_gen_spec(spec_str)
    if kind == "poisson" and aniso is not None:
        r, c, v, N = aniso_poisson2d_coo(n, aniso)
    elif kind == "poisson":
        # the packed upper CSR assembling poisson{2,3}d_coo would give,
        # without sorting its triplets
        pr, pc, pa, N = poisson_packed_upper(n, dim)
        return SymCsrMatrix(nrows=N, prowptr=pr, pcolidx=pc, pa=pa)
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
            ("--multihost/--coordinator (single-controller tier)",
             args.multihost or args.coordinator is not None),
            ("--distributed-read", args.distributed_read),
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
            ("--audit-every/--stall-window (no batched audit hooks "
             "yet)", args.audit_every > 0 or args.stall_window > 0),
            ("--fault-inject/--recover (no batched breakdown "
             "detection yet)", bool(args.fault_inject) or args.recover),
            ("--multihost/--coordinator (single-controller tier)",
             args.multihost or args.coordinator is not None),
            ("--distributed-read", args.distributed_read),
            ("--output-comm-matrix", args.output_comm_matrix),
            ("--progress with --block-cg (its columns share one "
             "Krylov block)", args.progress > 0 and args.block_cg),
            ("--profile-ops", args.profile_ops is not None),
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
            ("--profile-ops (the replay census has no CA op map)",
             args.profile_ops is not None),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --algorithm {args._algorithm} does not "
                f"support: {', '.join(unsupported)}")


def _validate_decision(args) -> None:
    """The decision layers' refusals, before anything expensive
    (``acg_tpu/cli.py:2580-2700``, ``:2751-2789``): ``--explain`` and
    ``--commbench`` are single-controller passes that produce no solve
    output and run pristine programs; ``--calibration`` is loaded and
    validated here; ``--autotune`` owns the axes it plans over, and
    ``--plan`` needs ``--explain`` or ``--autotune``."""
    import os

    fault_armed = bool(args.fault_inject
                       or os.environ.get("ACG_TPU_FAULT_INJECT"))
    multi = (args.multihost or args.coordinator is not None
             or args.distributed_read)
    if args.explain:
        if multi:
            raise SystemExit(
                "acg-tpu-torch: --explain is a single-controller analysis "
                "pass (drop --multihost/--coordinator/--distributed-read)")
        if fault_armed:
            raise SystemExit(
                "acg-tpu-torch: --explain analyses and times the PRISTINE "
                "solve programs; drop --fault-inject (fault-test a normal "
                "solve instead)")
        ignored = [flag for flag, on in [
            ("--convergence-log", bool(args.convergence_log)),
            ("--progress", args.progress > 0),
            ("-o/--output", args.output is not None),
            ("--profile-ops", args.profile_ops is not None),
            ("--output-comm-matrix", args.output_comm_matrix),
            ("--audit-every (--explain computes its own convergence "
             "verdict from the host oracle)", args.audit_every > 0),
            ("--stall-window", args.stall_window > 0),
            ("--timeline (the analysis solves are not the pipeline the "
             "timeline describes; --trace works and feeds the measured "
             "verdict)", args.timeline is not None),
            ("--status-port/--status-file (the analysis solves are not "
             "the solve a status plane watches)",
             args.status_port > 0 or args.status_file is not None),
            ("--history (the ledger records solves, not analysis "
             "passes; --explain --plan --history consults it "
             "read-only)", args.history is not None and args.plan is None),
            ("--slo (objectives judge real solves)", args.slo is not None),
        ] if on]
        if ignored:
            raise SystemExit(
                f"acg-tpu-torch: --explain is an analysis pass and "
                f"produces none of: {', '.join(ignored)} -- run a normal "
                f"solve for those (--stats-json works with --explain)")
    if args.commbench is not None and args.calibration is not None:
        raise SystemExit(
            "acg-tpu-torch: --commbench and --calibration are two "
            "calibration sources; run --commbench to produce a document, "
            "then --explain --calibration FILE to consume it")
    if args.commbench is not None:
        if multi:
            raise SystemExit(
                "acg-tpu-torch: --commbench is a single-controller "
                "measurement pass (drop --multihost/--coordinator/"
                "--distributed-read)")
        if fault_armed:
            raise SystemExit(
                "acg-tpu-torch: --commbench measures the PRISTINE "
                "collectives; drop --fault-inject")
        if not args.explain:
            ignored = [flag for flag, on in [
                ("--convergence-log", bool(args.convergence_log)),
                ("-o/--output", args.output is not None),
                ("--profile-ops", args.profile_ops is not None),
                ("--timeline", args.timeline is not None),
                ("--stats-json (the commbench document IS the "
                 "structured output; --stats-json works with --explain "
                 "--commbench)", args.stats_json is not None),
                ("--soak", args.soak > 0),
                ("--history (the ledger records solves, not "
                 "microbenchmarks)", args.history is not None),
                ("--slo (objectives judge real solves)",
                 args.slo is not None),
            ] if on]
            if ignored:
                raise SystemExit(
                    f"acg-tpu-torch: --commbench is a measurement pass and "
                    f"produces none of: {', '.join(ignored)} -- run a "
                    f"normal solve for those")
    args._calibration = None
    if args.calibration is not None:
        from acg_tpu_torch.commbench import load_calibration
        try:
            args._calibration = load_calibration(args.calibration)
        except (OSError, ValueError) as e:
            raise SystemExit(f"acg-tpu-torch: --calibration "
                             f"{args.calibration}: {e}")
        args._calibration_source = f"--calibration {args.calibration}"
    if args.autotune:
        if args.explain:
            raise SystemExit(
                "acg-tpu-torch: --autotune dispatches a real solve; use "
                "--explain --plan for the ranked table without solving")
        if args.commbench is not None:
            raise SystemExit(
                "acg-tpu-torch: --autotune consumes a SAVED calibration "
                "(--calibration FILE); run --commbench first")
        unsupported = [flag for flag, on in [
            (f"--algorithm {args.algorithm} (the planner chooses the "
             f"recurrence numerically)",
             args.algorithm not in (None, "auto")),
            (f"--solver {args.solver} (the planner chooses among the "
             f"device tiers)", args.solver != "acg"),
            ("--kernels fused (the planner chooses the kernel tier)",
             args.kernels == "fused"),
            ("--nrhs/--block-cg (no batched candidate pricing yet)",
             args.nrhs >= 2 or args.block_cg),
            ("--refine", args.refine),
            ("--replace-every", args.replace_every > 0),
            ("--fault-inject (probes must time the pristine programs)",
             fault_armed),
            ("--multihost/--coordinator/--distributed-read (single-"
             "controller planning only)", multi),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --autotune does not support: "
                f"{', '.join(unsupported)}")
    if args.plan is not None and not (args.explain or args.autotune):
        raise SystemExit(
            "acg-tpu-torch: --plan needs --explain (ranked table, no "
            "solve) or --autotune (plan, probe, dispatch)")


def _validate_robustness(args) -> None:
    """Validate and build the robustness tier's selections before
    anything expensive (``acg_tpu/cli.py:2786-2900``, ``:3116-3189``,
    ``:3007-3028``): the health spec, the checkpoint configuration (the
    resume snapshot loaded and checked here), the fault injector
    (installed process-wide and exported as ``ACG_TPU_FAULT_INJECT``
    for child processes) and the recovery policy; each refuses what
    could never fire."""
    import os

    from acg_tpu_torch import faults
    from acg_tpu_torch import health as health_mod
    if args.gap_threshold and not args.audit_every:
        raise SystemExit(
            "acg-tpu-torch: --gap-threshold needs --audit-every K (the "
            "threshold judges audit gaps; without an audit it could "
            "never fire)")
    if args.abft and not args.audit_every:
        raise SystemExit(
            "acg-tpu-torch: --abft fires the checksum test at the audit "
            "cadence; add --audit-every K")
    try:
        args._health = health_mod.make_spec(
            args.audit_every, args.gap_threshold, args.on_gap,
            args.stall_window, abft=args.abft,
            abft_threshold=args.abft_threshold)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    if args._health is not None:
        unsupported = [flag for flag, on in [
            (f"--solver {args.solver} (the external oracles have no "
             f"audit hooks)", args.solver in ("host-native", "petsc")),
            ("--replace-every (the replacement segments already "
             "recompute b - Ax every K iterations)",
             args.replace_every > 0),
            ("--kernels fused (the two-phase kernels fold the whole "
             "iteration; no audit hook)", args.kernels == "fused"),
            ("--refine (the refinement outer loop already recomputes "
             "f64 true residuals every pass)", args.refine),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --audit-every/--stall-window do not "
                f"support: {', '.join(unsupported)}")
    args._ckpt = None
    if args.ckpt_every > 0 and args.ckpt_secs > 0:
        raise SystemExit("acg-tpu-torch: --ckpt-every and --ckpt-secs "
                         "are mutually exclusive cadences; pick one")
    if args.ckpt_secs < 0:
        raise SystemExit("acg-tpu-torch: --ckpt-secs must be positive "
                         "seconds")
    if args.ckpt is not None and args.ckpt_every <= 0 \
            and args.ckpt_secs <= 0:
        raise SystemExit("acg-tpu-torch: --ckpt needs a snapshot "
                         "cadence: add --ckpt-every K or --ckpt-secs S")
    if (args.ckpt_every or args.ckpt_secs > 0) and args.ckpt is None:
        raise SystemExit("acg-tpu-torch: --ckpt-every/--ckpt-secs need "
                         "--ckpt FILE (a cadence with nowhere to write)")
    if args.resume_repartition and args.resume is None:
        raise SystemExit("acg-tpu-torch: --resume-repartition is a "
                         "resume policy; add --resume FILE")
    if args.ckpt is not None or args.resume is not None:
        unsupported = [flag for flag, on in [
            (f"--solver {args.solver} (the external oracles expose no "
             f"loop carry)", args.solver in ("host-native", "petsc")),
            ("--replace-every (the replacement segments' inner state "
             "never leaves the program)", args.replace_every > 0),
            ("--kernels fused (the two-phase kernels expose no loop "
             "carry)", args.kernels == "fused"),
            ("--refine (the refinement outer loop re-enters solve; "
             "checkpoint the inner tolerance solve instead)",
             args.refine),
            ("--diff-atol/--diff-rtol (the dx scalar is not part of "
             "the snapshot carry)",
             args.diff_atol > 0 or args.diff_rtol > 0),
            ("--soak with --resume (every repetition would re-resume "
             "from the same snapshot; resume the solve once, then "
             "soak)", args.soak > 0 and args.resume is not None),
        ] if on]
        if unsupported:
            raise SystemExit(
                f"acg-tpu-torch: --ckpt/--resume do not support: "
                f"{', '.join(unsupported)}")
        from acg_tpu_torch.checkpoint import (CheckpointConfig,
                                              load_snapshot)
        from acg_tpu_torch.errors import AcgError
        resume_snap = None
        if args.resume is not None:
            try:
                resume_snap = load_snapshot(args.resume)
            except AcgError as e:
                raise SystemExit(f"acg-tpu-torch: {e}")
        try:
            args._ckpt = CheckpointConfig(
                path=args.ckpt, every=args.ckpt_every,
                secs=args.ckpt_secs, resume=resume_snap,
                repartition=args.resume_repartition)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    if args.soak < 0:
        raise SystemExit("acg-tpu-torch: --soak must be >= 0")
    if args.fail_on_drift is not None and not args.soak:
        raise SystemExit("acg-tpu-torch: --fail-on-drift needs --soak N "
                         "(drift is a property of repeated solves)")
    if args.fail_on_drift is not None and args.fail_on_drift <= 0:
        raise SystemExit("acg-tpu-torch: --fail-on-drift must be "
                         "positive percent")
    if args.fail_on_drift is not None:
        from acg_tpu_torch.soak import gate_is_vacuous
        if gate_is_vacuous(args.soak):
            raise SystemExit(
                f"acg-tpu-torch: --fail-on-drift is vacuous at --soak "
                f"{args.soak}: the baseline window consumes the whole "
                f"run; use --soak 4 or more")
    if args.soak:
        unsupported = [flag for flag, on in [
            ("--refine (the outer iteration re-enters solve itself)",
             args.refine),
            ("--profile-ops", args.profile_ops is not None),
            ("--multihost/--coordinator (soak is per-process; run one "
             "driver per controller)", _multi(args)),
            ("--distributed-read", args.distributed_read),
        ] if on]
        if unsupported:
            raise SystemExit(f"acg-tpu-torch: --soak does not support: "
                             f"{', '.join(unsupported)}")
    env_spec = os.environ.get(faults.ENV_VAR)
    if env_spec and not args.fault_inject:
        try:
            faults.parse_fault_spec(env_spec)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {faults.ENV_VAR}: {e}")
    spec = None
    if args.fault_inject:
        try:
            spec = faults.parse_fault_spec(args.fault_inject)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
        if spec.site == "solve" and not args.soak:
            raise SystemExit(
                "acg-tpu-torch: solve:slow fires from the soak driver's "
                "per-solve hook; add --soak N")
        if spec.site == "crash" and (args._ckpt is None
                                     or args._ckpt.path is None):
            raise SystemExit(
                "acg-tpu-torch: crash:exit fires between snapshot "
                "commits; arm --ckpt FILE --ckpt-every K")
        if spec.device_site and args.solver in ("host-native", "petsc"):
            raise SystemExit(
                f"acg-tpu-torch: --fault-inject has no injection sites "
                f"in --solver {args.solver}; use --solver host or the "
                f"device solvers")
    if spec is not None:
        args._prev_fault_env = env_spec
        faults.install(spec)
        os.environ[faults.ENV_VAR] = args.fault_inject
    recovery = None
    gap_replace = (args._health is not None
                   and args._health.action == "replace")
    if args.recover or args.fault_inject or gap_replace:
        from acg_tpu_torch.solvers.resilience import RecoveryPolicy
        recovery = RecoveryPolicy(max_restarts=max(args.max_restarts, 0),
                                  backoff=max(args.restart_backoff, 0.0),
                                  agree_timeout=args.err_timeout)
        if args.recover and args.solver in ("host-native", "petsc"):
            sys.stderr.write(
                f"acg-tpu-torch: warning: --recover has no effect for "
                f"--solver {args.solver} (the external oracles have no "
                f"breakdown detection)\n")
    args._recovery = recovery


def _robust_options(args) -> dict:
    """The robustness keywords the single-device and stacked solvers
    take (None when disarmed: the loops then run as before)."""
    return dict(recovery=args._recovery, health=args._health,
                ckpt=args._ckpt)


def _robust_armed(args) -> bool:
    return any(v is not None for v in _robust_options(args).values())


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
    """The precision, preconditioning, recurrence and in-loop telemetry
    keywords both solver tiers take."""
    return dict(precise_dots=args.precise_dots,
                replace_every=args.replace_every, precond=args._precond,
                algorithm=args._algorithm, trace=args._trace,
                progress=args.progress)


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
    if (args.nparts > 1 or args.manufactured_solution or args.refine
            or _multi(args)):
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
                               device=device, **_solver_options(args),
                               **_robust_options(args))
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    args._phases.add("ingest", ingest)
    b = torch.ones(N, dtype=vec_dtype, device=device)
    criteria = StoppingCriteria(
        maxits=args.max_iterations,
        residual_atol=args.residual_atol, residual_rtol=args.residual_rtol,
        diff_atol=args.diff_atol, diff_rtol=args.diff_rtol)
    t0 = time.perf_counter()
    try:
        x = _run_solve(args, solver, criteria, _soak_call(
            args, solver, b, None, criteria,
            dict(warmup=args.warmup,
                 host_result=bool(not args.quiet or args.output))))
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _fold_phases(args, solver)
        solver.stats.fwrite(sys.stderr)
        _emit_telemetry(args, solver, matrix_id=args.A, collective=False)
        return 1
    _log(args, "solve:", t0)
    _after_solve(args, solver, b)
    solver.stats.fwrite(sys.stderr)
    t_wb = time.perf_counter()
    _emit_solution(args, x)
    args._phases.add("writeback", time.perf_counter() - t_wb)
    _emit_telemetry(args, solver, matrix_id=args.A)
    return 0


def _solve_generated_sharded(args, dim, n, N, device, dtype,
                             vec_dtype) -> int:
    """The sharded gen-direct tier (``acg_tpu/cli.py:2291-2470``): the
    planes built on the device and solved over ``--nparts`` row parts
    (one by default; one per process under ``--multihost``, each process
    building and holding its own rows), b = ones or a manufactured b
    drawn on the device with the analytic spot check, and ``--refine`` as
    df64 refinement on the device (``parallel/sharded_dia``)."""
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
    if args.profile_ops is not None:
        raise SystemExit(
            "acg-tpu-torch: --profile-ops is not available on the sharded "
            "direct-assembly path (single-part: drop --nparts/"
            "--manufactured-solution)")
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
    nparts = args.nparts or _default_nparts(device, args)
    t0 = time.perf_counter()
    try:
        solver = build_sharded_poisson_solver(
            n, dim, nparts=nparts, dtype=dtype, vector_dtype=vec_dtype,
            pipelined="pipelined" in args.solver,
            epsilon=args.epsilon, kernels=args.kernels, device=device,
            **_solver_options(args), **_robust_options(args))
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    _log(args, f"gen-direct: {args.A} (N={N}) sharded DIA planes assembled "
               f"on the device ({nparts} parts, {solver.kernels}), no host "
               f"matrix:", t0)
    args._phases.add("ingest", time.perf_counter() - t0)

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
                _stage_sync(args, "solve", 1)
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
            x, xl = _run_solve(args, solver, criteria,
                               lambda: solver.solve_refined(
                                   b, criteria=criteria,
                                   inner_rtol=args.refine_rtol,
                                   inner_maxits=args.refine_inner_maxits,
                                   warmup=args.warmup), nparts=nparts)
            _log(args, f"refine: {solver.stats.nrefine} passes, "
                       f"{solver.stats.niterations} inner iterations")
        else:
            x = _run_solve(args, solver, criteria, _soak_call(
                args, solver, b, None, criteria,
                dict(warmup=args.warmup, host_result=False)),
                nparts=nparts)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _fold_phases(args, solver)
        if _is_primary():
            solver.stats.fwrite(sys.stderr)
        _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                        collective=False)
        _stage_sync(args, "solve", 1)
        return 1
    _log(args, "solve:", t0)
    rc = _stage_sync(args, "solve", 0)
    if rc:
        sys.stderr.write("acg-tpu-torch: aborting: a peer controller "
                         "failed during the solve\n")
        return rc
    _after_solve(args, solver, b)
    # the collective steps (error norms, the solution gather) run on every
    # process before the primary-only output
    errs = None
    if xsol is not None:
        errs = (solver.error_norms_df(x, xl, xsol) if xl is not None
                else solver.error_norms(x, xsol))
    x_host = None
    if args.output is not None or not args.quiet:
        # a refined solution is the df64 pair: its f64 sum carries the
        # accuracy --refine computed
        x_host = solver.gather_x(x)
        if xl is not None:
            x_host = x_host + solver.gather_x(xl)
    if not _is_primary():
        _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts)
        return 0
    solver.stats.fwrite(sys.stderr)
    if errs is not None:
        sys.stderr.write(f"initial error 2-norm: {errs[0]:.15g}\n")
        sys.stderr.write(f"error 2-norm: {errs[1]:.15g}\n")
    if x_host is not None:
        t_wb = time.perf_counter()
        _emit_solution(args, x_host)
        args._phases.add("writeback", time.perf_counter() - t_wb)
    _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts)
    return 0


def _solve_distributed_read(args, device, dtype, vec_dtype) -> int:
    """The ``--distributed-read`` pipeline (``acg_tpu/cli.py:
    1736-2013``): each process range-reads its own rows of a row-sorted
    full-storage binary file, builds only its own subdomains, agrees the
    stacked shapes with the other processes, and solves on the
    multi-process tier; b/x0 files are window-read (through the
    ``.perm.mtx`` sidecar for a partition-permuted matrix) and
    ``--output`` is written rootless (:func:`_distributed_write`)."""
    import os

    from acg_tpu_torch.errors import (AcgError, BreakdownError,
                                      NotConvergedError)
    from acg_tpu_torch.io.mtxfile import read_mtx
    from acg_tpu_torch.parallel import multihost
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    unsupported = [flag for flag, on in [
        ("a gen: spec (use the sharded direct path)",
         args.A.startswith("gen:")),
        ("text input (needs --binary; see mtx2bin --expand)",
         not args.binary),
        (f"--solver {args.solver}",
         args.solver in ("host", "host-native", "petsc")),
        ("b/x0 files with --manufactured-solution",
         args.manufactured_solution and bool(args.b or args.x0)),
        ("--kernels fused (needs the full-information build; the "
         "local-read flow holds other controllers' coupled-row lists "
         "as stubs)", args.kernels == "fused"),
        ("--diff-* criteria with --replace-every or --refine",
         (args.replace_every > 0 or args.refine)
         and (args.diff_atol > 0 or args.diff_rtol > 0)),
        ("--comm dma", args.comm in ("dma", "nvshmem")),
        ("--profile-ops", args.profile_ops is not None),
    ] if on]
    if unsupported:
        raise SystemExit(
            f"acg-tpu-torch: --distributed-read does not support: "
            f"{', '.join(unsupported)}")

    # partition bounds: arbitrary partitions arrive PRE-APPLIED by
    # mtx2bin --expand --partition as a bounds sidecar (text by
    # construction; binary sniffed as a fallback for hand-made ones)
    bounds = None
    bounds_path = args.partition
    if bounds_path is None and os.path.exists(args.A + ".bounds.mtx"):
        bounds_path = args.A + ".bounds.mtx"
    if bounds_path is not None:
        try:
            bmtx = read_mtx(bounds_path, binary=False)
        except (AcgError, ValueError):
            try:
                bmtx = read_mtx(bounds_path, binary=True)
            except AcgError as e:
                raise SystemExit(f"acg-tpu-torch: {bounds_path}: {e}")
        bounds = np.asarray(bmtx.vals).reshape(-1).astype(np.int64)
        try:
            from acg_tpu_torch.io.mtxfile import read_mtx_sizes
            n_check = read_mtx_sizes(args.A)[0]
        except (AcgError, OSError):
            n_check = None   # the matrix read reports its own error
        if (bounds.size < 2 or bounds[0] != 0 or (np.diff(bounds) < 0).any()
                or (n_check is not None and bounds[-1] != n_check)):
            raise SystemExit(
                f"acg-tpu-torch: {bounds_path} is not a part-bounds "
                f"sidecar (nparts+1 ascending boundaries from 0 to "
                f"nrows).  For --distributed-read, apply the partition "
                f"VECTOR offline with: mtx2bin IN OUT --expand "
                f"--partition VECFILE, then pass OUT here (its "
                f".bounds.mtx is found automatically)")
        if args.nparts and args.nparts != bounds.size - 1:
            raise SystemExit(
                f"acg-tpu-torch: --nparts {args.nparts} != "
                f"{bounds.size - 1} parts in {bounds_path}")
    nparts = (bounds.size - 1 if bounds is not None
              else args.nparts or multihost.process_count())
    # two-phase ingest: the range reads (phase 1) can fail on one
    # process alone, so they are agreed BEFORE the shape agreement of
    # phase 2 (a failed peer must not leave the others in a collective)
    ingest_rc, state = 0, None
    t0 = time.perf_counter()
    try:
        state = DistributedProblem.read_local_subdomains(args.A, nparts,
                                                         bounds=bounds)
        _log(args, f"range-read + local build ({len(state[3])} of "
                   f"{nparts} parts on this process):", t0)
    except (AcgError, OSError, ValueError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        ingest_rc = 1
    rc = _stage_sync(args, "ingest", ingest_rc)
    if rc:
        if not ingest_rc:
            sys.stderr.write("acg-tpu-torch: aborting: a peer controller "
                             "failed during ingest\n")
        return rc
    subs, bounds, n_rows, owned = state
    t_part = time.perf_counter()
    args._phases.add("ingest", t_part - t0)
    prob = DistributedProblem.assemble_local(subs, bounds, n_rows, nparts,
                                             owned, dtype=dtype,
                                             vector_dtype=vec_dtype)
    args._phases.add("partition", time.perf_counter() - t_part)

    comm_mtx = None
    if args.output_comm_matrix:
        # this process's rows of the volume matrix are exact from its
        # plans; the sum over processes fills the rest
        from acg_tpu_torch.graph import comm_matrix
        M = comm_matrix([prob.subs[p] for p in prob.owned_parts], nparts)
        comm_mtx = multihost.allgather_array(M).sum(axis=0).astype(np.int64)

    n = prob.n
    rng = np.random.default_rng(args.seed)
    xsol = None
    x0 = None
    if args.manufactured_solution:
        # the same seed on every process; b = A xsol from the local
        # blocks only, each process its own rows
        xsol = rng.standard_normal(n)
        xsol /= np.linalg.norm(xsol)
        b = np.zeros(n)
        _owned_spmv_windows(prob, xsol, b)
    elif args.b:
        b = None
    else:
        b = np.ones(n)
    if args.b or args.x0:
        rhs_rc = 0
        perm_path = (args.A + ".perm.mtx"
                     if os.path.exists(args.A + ".perm.mtx") else None)
        try:
            if args.b:
                b = _read_vector_windows(args.b, prob, perm_path)
            if args.x0:
                x0 = _read_vector_windows(args.x0, prob, perm_path)
        except (AcgError, OSError) as e:
            sys.stderr.write(f"acg-tpu-torch: {e}\n")
            rhs_rc = 1
        rc = _stage_sync(args, "rhs", rhs_rc)
        if rc:
            if not rhs_rc:
                sys.stderr.write("acg-tpu-torch: aborting: a peer "
                                 "controller failed reading b/x0\n")
            return rc

    criteria = StoppingCriteria(
        maxits=args.max_iterations,
        residual_atol=args.residual_atol, residual_rtol=args.residual_rtol,
        diff_atol=args.diff_atol, diff_rtol=args.diff_rtol)
    if args._ckpt is not None:
        # a snapshot records one b checksum and the primary's global
        # vectors: every process solves the same global b
        b = _allgather_sum(b, prob)
        if x0 is not None:
            x0 = _allgather_sum(x0, prob)
    try:
        solver = DistCGSolver(prob, pipelined="pipelined" in args.solver,
                              kernels=args.kernels, device=device,
                              **_solver_options(args),
                              **_robust_options(args))
    except ValueError as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _stage_sync(args, "solve", 1)
        return 1
    if args.refine:
        # f64 outer residuals from this process's host blocks only; the
        # outer iteration needs the same b (and x0) on every process
        from acg_tpu_torch.solvers.refine import RefinedSolver
        if args.manufactured_solution or args.b:
            b = _allgather_sum(b, prob)
        if x0 is not None:
            x0 = _allgather_sum(x0, prob)
        solver = RefinedSolver(solver, _dist_host_matvec(prob), n=n,
                               nnz=prob.nnz_total,
                               inner_rtol=args.refine_rtol,
                               inner_maxits=args.refine_inner_maxits)
    t0 = time.perf_counter()
    solve_kw = {} if args.refine else {"host_result": not args.output}
    try:
        x = _run_solve(args, solver, criteria, lambda: solver.solve(
            b, x0=x0, criteria=criteria, warmup=args.warmup, **solve_kw),
            nparts=nparts)
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _fold_phases(args, solver)
        if _is_primary():
            solver.stats.fwrite(sys.stderr)
        _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                        comm=args.comm, collective=False)
        _stage_sync(args, "solve", 1)
        _close(solver)
        return 1
    except (AcgError, ValueError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _stage_sync(args, "solve", 1)
        _close(solver)
        return 1
    _log(args, "solve:", t0)
    rc = _stage_sync(args, "solve", 0)
    _close(solver)
    if rc:
        sys.stderr.write("acg-tpu-torch: aborting: a peer controller "
                         "failed during the solve\n")
        return rc
    _after_solve(args, solver, b)
    if comm_mtx is not None and _is_primary():
        _write_comm_matrix(comm_mtx, nparts)
    if args.output:
        rc = _distributed_write(args, solver, x, xsol, n)
        if rc == 0:
            _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                            comm=args.comm)
        return rc
    if not _is_primary():
        _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                        comm=args.comm)
        return 0
    solver.stats.fwrite(sys.stderr)
    if xsol is not None:
        sys.stderr.write(f"initial error 2-norm: "
                         f"{np.linalg.norm(xsol):.15g}\n")
        sys.stderr.write(f"error 2-norm: "
                         f"{np.linalg.norm(x - xsol):.15g}\n")
    # a partition-permuted matrix solves in permuted row order; the
    # solution goes out in the input's order through the sidecar
    t_wb = time.perf_counter()
    _emit_solution(args, x, _load_perm_sidecar(args.A, n))
    args._phases.add("writeback", time.perf_counter() - t_wb)
    _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                    comm=args.comm)
    return 0


def _owned_spmv_windows(prob, x: np.ndarray, out: np.ndarray) -> None:
    """``out[lo:hi] = (A @ x)[lo:hi]`` for every part this process owns,
    from its host blocks in f64 (``acg_tpu/cli.py:2030-2042``)."""
    for p in prob.owned_parts:
        s = prob.subs[p]
        lo, hi = prob.band_bounds[p], prob.band_bounds[p + 1]
        yp = s.A_local @ x[lo:hi]
        if s.nghost:
            yp = yp + s.A_ghost @ x[s.global_ids[s.nowned:]]
        out[lo:hi] = yp


def _allgather_sum(y: np.ndarray, prob) -> np.ndarray:
    """The processes' owned-window vectors (zero elsewhere) summed into
    the global vector; only each process's span of rows moves
    (``acg_tpu/cli.py:2045-2077``)."""
    from acg_tpu_torch.parallel import multihost

    if multihost.process_count() == 1:
        return y
    y = np.asarray(y, dtype=np.float64)
    lo = min(int(prob.band_bounds[p]) for p in prob.owned_parts)
    hi = max(int(prob.band_bounds[p + 1]) for p in prob.owned_parts)
    meta = multihost.allgather_array(np.asarray([lo, hi], np.int64))
    span = int((meta[:, 1] - meta[:, 0]).max())
    buf = np.zeros(span)
    buf[: hi - lo] = y[lo:hi]
    data = multihost.allgather_array(buf)
    out = np.zeros_like(y)
    for (plo, phi), row in zip(meta, data):
        out[plo:phi] += row[: phi - plo]
    return out


def _dist_host_matvec(prob):
    """``matvec(x) -> A @ x`` in f64 from this process's host blocks:
    the owned windows, summed over the processes."""
    def mv(x):
        y = np.zeros(prob.n)
        _owned_spmv_windows(prob, x, y)
        return _allgather_sum(y, prob)
    return mv


def _read_vector_windows(path, prob, perm_path=None) -> np.ndarray:
    """A global-length vector holding only this process's owned windows
    of a binary array vector file, read by window; for a
    partition-permuted matrix each permuted window maps through the perm
    sidecar (itself window-read) to scattered original rows
    (``acg_tpu/cli.py:2095-2143``)."""
    from acg_tpu_torch.errors import AcgError, ErrorCode
    from acg_tpu_torch.io.mtxfile import read_vector_rows, read_vector_window

    v = np.zeros(prob.n)
    for p in prob.owned_parts:
        lo, hi = int(prob.band_bounds[p]), int(prob.band_bounds[p + 1])
        if perm_path is None:
            v[lo:hi] = read_vector_window(path, lo, hi, expect_nrows=prob.n)
            continue
        try:
            orig = read_vector_window(perm_path, lo, hi,
                                      expect_nrows=prob.n)
        except AcgError as e:
            raise AcgError(
                e.code,
                f"{perm_path}: not a readable perm sidecar -- mtx2bin "
                f"--partition writes it as a BINARY integer array of "
                f"1-based original row numbers, one per permuted row "
                f"({e})")
        orig = orig.astype(np.int64) - 1
        if orig.size and (orig.min() < 0 or orig.max() >= prob.n):
            oob = (int(orig.min() + 1) if orig.min() < 0
                   else int(orig.max() + 1))
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"{perm_path}: sidecar entry {oob} outside the 1-based "
                f"row range [1, {prob.n}] -- stale or hand-made sidecar?")
        v[lo:hi] = read_vector_rows(path, orig, expect_nrows=prob.n)
    return v


def _distributed_write(args, solver, x_st, xsol, n: int) -> int:
    """Rootless solution output (``mtxfile_fwrite_mpi_double``'s role,
    ``acg_tpu/cli.py:2146-2240``): each process range-writes the owned
    windows of its own stacked solution into the shared file, the
    primary writes the header; no process gathers the whole vector."""
    import os
    import shutil

    from acg_tpu_torch.io.mtxfile import (finalize_vector_file,
                                          write_vector_window)
    from acg_tpu_torch.parallel import multihost

    prob = getattr(solver, "problem", None)
    if prob is None:
        prob = solver.inner.problem   # RefinedSolver (--refine)
    bounds = prob.band_bounds
    windows = []
    wrc = 0
    try:
        if isinstance(x_st, np.ndarray):
            # refined: the outer iteration returned the global f64 x
            for p in prob.owned_parts:
                lo, hi = int(bounds[p]), int(bounds[p + 1])
                windows.append((lo, np.asarray(x_st[lo:hi], np.float64)))
        else:
            xs = x_st.to(torch.float32) if x_st.dtype == torch.bfloat16 \
                else x_st
            xs = xs.cpu().numpy()
            for j, p in enumerate(prob.owned_parts):
                lo, hi = int(bounds[p]), int(bounds[p + 1])
                windows.append((lo, xs[j, : hi - lo].astype(np.float64)))
        t0 = time.perf_counter()
        for lo, vals in windows:
            write_vector_window(args.output, n, lo, vals)
        _log(args, f"range-write {len(windows)} owned windows:", t0)
    except OSError as e:
        sys.stderr.write(f"acg-tpu-torch: {args.output}: {e}\n")
        wrc = 1
    rc = _stage_sync(args, "write", wrc)
    if rc:
        if not wrc:
            sys.stderr.write("acg-tpu-torch: aborting: a peer controller "
                             "failed during the solution write\n")
        return rc
    # manufactured error norms without a gather: partial sums of squares
    # over the owned windows, summed over the processes
    err = None
    if xsol is not None:
        part_sq = sum(float(np.sum((vals - xsol[lo:lo + vals.size]) ** 2))
                      for lo, vals in windows)
        err = float(np.sqrt(multihost.allgather_array(
            np.asarray([part_sq])).sum()))
    if not _is_primary():
        return 0
    finalize_vector_file(args.output, n)
    perm_path = args.A + ".perm.mtx"
    if os.path.exists(perm_path):
        # the windows keep the matrix's permuted row order: say so and
        # ship the map beside the file
        shutil.copyfile(perm_path, args.output + ".perm.mtx")
        sys.stderr.write(
            f"acg-tpu-torch: note: {args.output} is in the matrix's "
            f"permuted row ordering; {args.output}.perm.mtx (copied) maps "
            f"rows back to the original numbering\n")
    solver.stats.fwrite(sys.stderr)
    if err is not None:
        sys.stderr.write(f"initial error 2-norm: "
                         f"{np.linalg.norm(xsol):.15g}\n")
        sys.stderr.write(f"error 2-norm: {err:.15g}\n")
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


# -- the observability tier ----------------------------------------------

def _arm_observability(args) -> None:
    """Validate the observability flags and arm their recorders before
    anything records (``acg_tpu/cli.py:2570-2580, 2679-2682,
    3026-3101``): the phase timer, the ``--timeline`` span recorder, the
    metrics registry and its sinks, the status recorder and its sinks,
    the ``--slo`` objectives, and the ring size the solvers take
    (``args._trace``: armed only when ``--convergence-log`` will read
    it)."""
    import os

    from acg_tpu_torch import metrics, observatory, tracing
    from acg_tpu_torch.telemetry import PhaseTimer

    args._phases = PhaseTimer()
    if args.telemetry_window <= 0:
        raise SystemExit("acg-tpu-torch: --telemetry-window must be "
                         "positive")
    if args.progress < 0:
        raise SystemExit("acg-tpu-torch: --progress must be >= 0")
    if args.metrics_port < 0 or args.metrics_port > 65535:
        raise SystemExit("acg-tpu-torch: --metrics-port must be 0-65535")
    if args.status_port < 0 or args.status_port > 65535:
        raise SystemExit("acg-tpu-torch: --status-port must be 0-65535")
    args._slo = None
    if args.slo is not None:
        try:
            args._slo = observatory.parse_slo(args.slo)
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    if args.fail_on_slo and args._slo is None:
        raise SystemExit("acg-tpu-torch: --fail-on-slo needs --slo SPEC "
                         "(a gate with no declared objectives could "
                         "never trip)")
    if (args._slo is not None and args._slo.gap is not None
            and not args.audit_every):
        raise SystemExit("acg-tpu-torch: --slo gap=G judges audit gaps; "
                         "add --audit-every K (without an audit the "
                         "objective could never be observed)")
    if args.history is not None and os.path.isfile(args.history):
        raise SystemExit(f"acg-tpu-torch: --history {args.history} is a "
                         f"file; the ledger needs a directory")
    if args.timeline:
        tracing.arm()
        args._timeline_written = False
    if args.metrics_file or args.metrics_port or args._slo is not None:
        metrics.arm()
        args._metrics_armed = True
        if args.metrics_file:
            metrics.install_flush_handlers(args.metrics_file)
        if args.metrics_port and args.metrics_port != args.status_port:
            # an equal --status-port serves /metrics itself
            srv = metrics.serve(args.metrics_port)
            _log(args, f"metrics: serving /metrics on port "
                       f"{srv.server_address[1]}")
    if (args.status_port or args.status_file or args.history
            or args._slo is not None):
        observatory.arm()
        args._observatory_armed = True
        if args._slo is not None:
            observatory.install_slo(args._slo)
        if args.status_file:
            observatory.set_status_file(args.status_file)
        if args.status_port:
            ssrv = observatory.serve_status(args.status_port)
            _log(args, f"status: serving /status (and /metrics) on port "
                       f"{ssrv.server_address[1]}")
    # the ring arms only when the JSONL sink will read it (--stats-json
    # alone stays compatible with every solver tier)
    args._trace = args.telemetry_window if args.convergence_log else 0
    if ((args.convergence_log or args.progress)
            and args.solver in ("host-native", "petsc")):
        sys.stderr.write(
            f"acg-tpu-torch: warning: --convergence-log/--progress have "
            f"no in-loop hooks in --solver {args.solver} (the external "
            f"oracles); --stats-json still works\n")


def _finish_observability(args) -> None:
    """``main``'s ``finally``: the last ``--metrics-file`` flush (only
    when ``_main`` armed the registry: a run that died in validation
    must not clobber the last healthy scrape), then the span and status
    recorders disarmed and cleared, scoped to this invocation."""
    if args.metrics_file and getattr(args, "_metrics_armed", False):
        from acg_tpu_torch import metrics
        try:
            metrics.write_textfile(args.metrics_file)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --metrics-file "
                             f"{args.metrics_file}: {e}\n")
    if args.timeline:
        from acg_tpu_torch import tracing
        tracing.disarm()
    if getattr(args, "_observatory_armed", False):
        from acg_tpu_torch import observatory
        observatory.shutdown()


def _inner_solver(solver):
    """Unwrap ``--refine``'s RefinedSolver down to the device solver that
    carries the telemetry (trace, timings, problem layout)."""
    while hasattr(solver, "inner"):
        solver = solver.inner
    return solver


def _run_solve(args, solver, criteria, call, nparts: int = 1):
    """One CLI solve, ``call()``, under the observability tier
    (``acg_tpu/cli.py:1290-1345``): the status header and per-part
    imbalance, the ``--trace`` capture around the solve, and the
    ``--slo`` verdict (judged on a failed solve too)."""
    from acg_tpu_torch import observatory, tracing

    prob = getattr(_inner_solver(solver), "problem", None)
    observatory.begin_solve(
        args.solver, criteria.maxits, rtol=args.residual_rtol,
        atol=args.residual_atol, matrix=args.A,
        nparts=int(getattr(prob, "nparts", 0) or nparts or 1))
    observatory.note_solver(solver)
    with tracing.profiler_trace(args.trace):
        try:
            return call()
        finally:
            _attach_health_spectrum(args, solver)
            if args.soak:
                # the soak driver judged every solve; only the stats
                # section attach is left
                observatory.attach_slo(solver.stats)
            else:
                _observe_slo(args, solver)


def _soak_call(args, solver, b, x0, criteria, solve_kw: dict):
    """The solve ``call`` of a CLI run: one solve, or under ``--soak N``
    the soak driver's N solves (the first carries the warm-up), its
    report kept for the ``--fail-on-drift`` gate."""
    if not args.soak:
        return lambda: solver.solve(b, x0=x0, criteria=criteria,
                                    **solve_kw)

    def call():
        from acg_tpu_torch.soak import run_soak
        kw = dict(solve_kw)
        warm = kw.pop("warmup", None)
        x, args._soak_report = run_soak(
            solver, b, nsolves=args.soak, x0=x0, criteria=criteria,
            fail_on_drift=args.fail_on_drift,
            first_solve_kwargs=({"warmup": warm} if warm is not None
                                else None),
            solve_kwargs=kw,
            progress_every=(max(1, args.soak // 10) if args.verbose
                            else 0))
        return x

    return call


def _attach_health_spectrum(args, solver) -> None:
    """Post-hoc spectrum estimation: with an armed health spec and a
    recorded trace, the Lanczos estimate of kappa and the predicted
    iterations join the ``health:`` section (``acg_tpu/cli.py:1360``)."""
    if getattr(args, "_health", None) is None:
        return
    inner = _inner_solver(solver)
    trace = getattr(inner, "last_trace", None)
    if trace is None:
        return
    from acg_tpu_torch.health import attach_spectrum
    try:
        attach_spectrum(inner.stats, trace, args.residual_rtol,
                        precond=str(args._precond)
                        if args._precond is not None else None)
    except Exception as e:  # noqa: BLE001 -- never sinks a solve
        sys.stderr.write(f"acg-tpu-torch: warning: spectrum estimate "
                         f"failed: {e}\n")


def _observe_slo(args, solver) -> None:
    """Judge a completed solve against the declared ``--slo`` objectives
    and attach the verdict to the stats block."""
    from acg_tpu_torch import observatory
    if observatory.installed_slo() is None:
        return
    st = solver.stats
    observatory.slo_observe(st, latency=st.timings.get("solve", st.tsolve),
                            iterations=int(st.niterations),
                            gap=(st.health or {}).get("gap_last"))
    observatory.attach_slo(st)


def _after_solve(args, solver, b) -> None:
    """After a solve's last collective: the ``--profile-ops`` replay, the
    ``--trace`` analysis (measured seconds supersede the replay's), and
    the phase fold (``acg_tpu/cli.py:1255-1270``)."""
    if args.profile_ops is not None:
        from acg_tpu_torch.solvers.profile import profile_ops
        per_call = profile_ops(solver, b, reps=max(args.profile_ops, 1))
        _report_replay(per_call)
    _attach_trace_analysis(args, solver)
    _fold_phases(args, solver)


def _report_replay(per_call: dict) -> None:
    """The ``--profile-ops`` replay's per-call seconds and its two
    correction terms, next to the stats block they qualify."""
    if not per_call:
        return
    ops = {k: v for k, v in per_call.items()
           if k not in ("chain_overhead", "dispatch")}
    sys.stderr.write("per-op replay (seconds a call): "
                     + ", ".join(f"{k} {v:.3e}" for k, v in ops.items())
                     + "\n")
    co = per_call.get("chain_overhead")
    if co is not None:
        sys.stderr.write(
            f"per-op replay: chain_overhead {co:.3e} s/call -- "
            f"scalar-result chains (dot/nrm2/allreduce/halo) are upper "
            f"bounds by ~this\n")
    d = per_call.get("dispatch")
    if d is not None:
        sys.stderr.write(
            f"per-op replay: dispatch {d:.3e} s/launch -- the host's "
            f"cost to issue one launch; an op near it measured its "
            f"launch, not its work\n")


def _attach_trace_analysis(args, solver) -> None:
    """Parse the ``--trace`` capture into the ``tracing:`` section;
    an unusable capture degrades to a self-describing section and a
    warning (a solve that succeeded never dies for its
    observability)."""
    if not args.trace or solver is None:
        return
    from acg_tpu_torch import tracing

    an = tracing.analyze_trace(args.trace)
    tracing.attach(solver.stats, an)
    if not an.get("available"):
        sys.stderr.write(f"acg-tpu-torch: --trace: capture analysis "
                         f"unavailable ({an.get('why', '?')})\n")


def _fold_phases(args, solver) -> None:
    """Fold the CLI's phase timer (and under ``--refine`` the device
    solver's own phases and trace) into the stats about to be printed;
    idempotent, since the timer consumes on merge."""
    st = solver.stats
    inner = _inner_solver(solver)
    if inner is not solver:
        for k, v in inner.stats.timings.items():
            st.timings[k] = st.timings.get(k, 0.0) + v
        inner.stats.timings.clear()
        if st.trace is None and inner.stats.trace is not None:
            st.trace = inner.stats.trace
    timer = getattr(args, "_phases", None)
    if timer is not None:
        timer.merge_into(st.timings)


def _timeline_parts(solver, nparts: int) -> list:
    """The part ids this process's spans describe: its owned parts, or
    every part (one process runs them all)."""
    prob = getattr(_inner_solver(solver), "problem", None)
    owned = getattr(prob, "owned_parts", None) if prob is not None else None
    if owned is not None:
        return [int(p) for p in owned]
    from acg_tpu_torch.parallel import mesh, multihost
    n = max(int(nparts), 1)
    if multihost.process_count() > 1:
        lo, hi = mesh.part_range(n, multihost.process_index(),
                                 multihost.process_count())
        return list(range(lo, hi))
    return list(range(n))


def _emit_timeline(args, solver, nparts=1, collective=True) -> None:
    """Gather every process's spans (clock-aligned) and write the
    ``--timeline``: every process gathers, process 0 writes."""
    if not args.timeline or getattr(args, "_timeline_written", False):
        return
    from acg_tpu_torch import tracing

    payloads, clock = tracing.gather_timeline(
        parts=_timeline_parts(solver, nparts), timeout=args.err_timeout,
        collective=collective)
    # set on every rank right after the gather, so a second call skips
    # the collective everywhere at once
    args._timeline_written = True
    if not _is_primary():
        return
    try:
        summary = tracing.export_chrome_trace(
            args.timeline, payloads, nparts=max(int(nparts), 1),
            clock=clock)
    except OSError as e:
        sys.stderr.write(f"acg-tpu-torch: --timeline {args.timeline}: "
                         f"{e}\n")
        return
    tracing.attach(solver.stats, None, timeline=summary)
    sys.stderr.write(f"acg-tpu-torch: timeline: {summary['nspans']} spans "
                     f"over {summary['nparts']} part(s) from "
                     f"{summary['nranks']} rank(s) -> {args.timeline}\n")


def _calibration_id(args) -> str:
    """The active commbench calibration's id, or ``uncalibrated``
    (``acg_tpu/cli.py:1595-1665``): one lookup for both provenance
    surfaces, the convergence-log meta line and the stats manifest."""
    from acg_tpu_torch.commbench import UNCALIBRATED
    cal = getattr(args, "_calibration", None)
    return cal["calibration_id"] if cal is not None else UNCALIBRATED


def _emit_telemetry(args, solver, *, matrix_id, nparts=1, comm=None,
                    collective=True) -> None:
    """The telemetry sinks (``acg_tpu/cli.py:1581-1733``): the
    ``--convergence-log`` JSONL, the timeline, the cross-rank
    aggregation, the ``--stats-json`` document and the ``--history``
    ledger.  The gathers are collective (every process calls this at the
    same point: argv, and so the gating flags, are the same on every
    process); the file writes are process 0's.  Error paths pass
    ``collective=False``: a one-sided failure must not enter a gather
    its peers may never reach."""
    if not (args.convergence_log or args.stats_json or args.timeline
            or args.history):
        return
    from acg_tpu_torch import telemetry
    from acg_tpu_torch.parallel import multihost

    _fold_phases(args, solver)
    _emit_timeline(args, solver, nparts=nparts, collective=collective)
    inner = _inner_solver(solver)
    st = solver.stats
    trace = st.trace if st.trace is not None else inner.stats.trace
    if args.convergence_log and _is_primary():
        try:
            if trace is not None:
                trace.meta_extra["calibration"] = _calibration_id(args)
                trace.write_jsonl(args.convergence_log)
            else:
                sys.stderr.write(
                    f"acg-tpu-torch: --convergence-log: no convergence "
                    f"trace was recorded (--solver {args.solver} has no "
                    f"in-loop telemetry hooks)\n")
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: {args.convergence_log}: "
                             f"{e}\n")
    if not (args.stats_json or args.history):
        return
    ranks = payloads = None
    try:
        payload = telemetry.rank_payload(inner)
    except (AttributeError, TypeError, ValueError) as e:
        # a stub keeps the gather below symmetric across processes
        sys.stderr.write(f"acg-tpu-torch: rank stats payload failed "
                         f"({type(e).__name__})\n")
        payload = {"process": multihost.process_index(),
                   "error": type(e).__name__}
    if collective:
        payloads = telemetry.gather_rank_stats(payload,
                                               timeout=args.err_timeout)
    elif multihost.process_count() == 1:
        payloads = [payload]
    if payloads is not None:
        agg = telemetry.aggregate_ranks(payloads)
        ranks = {"per_rank": payloads, "aggregate": agg}
        if _is_primary() and len(payloads) > 1:
            sys.stderr.write("acg-tpu-torch: "
                             + telemetry.format_rank_report(agg) + "\n")
    if not _is_primary():
        return
    extra = {"matrix": str(matrix_id), "solver": args.solver,
             "comm": comm, "nparts": int(nparts), "dtype": args.dtype,
             # the --calibration id (the case key folds it in)
             "calibration": _calibration_id(args),
             "argv": list(sys.argv[1:])}
    if args._precond is not None:
        extra["precond"] = str(args._precond)
    if args._batched:
        extra["nrhs"] = int(args.nrhs)
        if args.block_cg:
            extra["block_cg"] = True
    if args._operator_spec is not None:
        extra["operator"] = str(args._operator_spec)
    if args.aniso is not None:
        extra["aniso"] = float(args.aniso)
    kern = getattr(inner, "kernels", None)
    extra["kernels"] = kern if isinstance(kern, str) else args.kernels
    prob = getattr(inner, "problem", None)
    if prob is not None:
        extra["mesh"] = {"parts": int(prob.nparts)}
        extra["partition"] = {
            "nparts": int(prob.nparts),
            "nmax_owned": int(prob.nmax_owned),
            "local_format": prob.local.format,
            "nnz_total": int(prob.nnz_total),
            "halo_send_total": int(prob.halo_total()),
            "nmax_ghost": int(prob.halo.nmax_ghost),
        }
    doc = None
    if args.stats_json:
        try:
            doc = telemetry.write_stats_json(
                args.stats_json, st,
                manifest=telemetry.run_manifest(**extra), ranks=ranks)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: {args.stats_json}: {e}\n")
    if args.history and not getattr(args, "_history_written", False):
        # error paths append too: a failed run is history evidence
        args._history_written = True
        from acg_tpu_torch import observatory
        if doc is None:
            doc = telemetry.stats_document(
                st, manifest=telemetry.run_manifest(**extra), ranks=ranks)
        try:
            path = observatory.history_append(args.history, doc)
            sys.stderr.write(f"acg-tpu-torch: history: appended to "
                             f"{path}\n")
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --history {args.history}: "
                             f"{e}\n")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--buildinfo" in argv:
        return _buildinfo(sys.stdout)
    args = make_parser().parse_args(argv)
    if args.serve:
        # the solver service (acg_tpu/cli.py:2487-2493): the daemon owns
        # its lifecycle; --supervise/--chaos wrap the live daemon
        from acg_tpu_torch.errors import AcgError
        from acg_tpu_torch.serve import run_serve
        try:
            return run_serve(args, list(argv))
        except AcgError as e:
            sys.stderr.write(f"acg-tpu-torch: {e}\n")
            return 1
    if args.chaos is not None or args.supervise:
        # the elastic-recovery driver modes (acg_tpu/cli.py:2494-2501):
        # the supervisor owns the child solves' lifecycle, before any
        # device work -- the card belongs to the children
        from acg_tpu_torch.supervisor import run_chaos, run_supervised
        return (run_chaos(args, list(argv)) if args.chaos is not None
                else run_supervised(args, list(argv)))
    args.numfmt = _validate_numfmt(args.numfmt)
    from acg_tpu_torch.errors import AcgError

    try:
        rc = _main(args)
        _report_run(args)
        if rc == 0 and getattr(args, "_soak_report", None) is not None:
            # the --fail-on-drift gate: a clean run whose latency
            # drifted exits 7
            from acg_tpu_torch.soak import gate_exit_code
            rc = gate_exit_code(args._soak_report, args.fail_on_drift)
        if rc == 0 and args.fail_on_slo:
            # a clean run that breached a declared objective exits 8
            from acg_tpu_torch import observatory
            rc = observatory.slo_exit_code(True)
        return rc
    except (OSError, AcgError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        return 1
    finally:
        _finish_observability(args)
        if args.fault_inject and hasattr(args, "_prev_fault_env"):
            # the installed spec and the exported env var are scoped to
            # this invocation: in-process callers must not stay armed
            import os

            from acg_tpu_torch import faults
            faults.install(None)
            if args._prev_fault_env is None:
                os.environ.pop(faults.ENV_VAR, None)
            else:
                os.environ[faults.ENV_VAR] = args._prev_fault_env
        if _multi(args):
            from acg_tpu_torch.parallel import multihost
            multihost.shutdown(timeout=args.err_timeout)


def _report_run(args) -> None:
    """Under ``-vv``, every process logs its kernel launches (a JSON
    object of ``ops.kernels.launches``) and, on the card, its device
    memory peak: what a run spread over processes shows of its path."""
    if args.verbose < 2:
        return
    import json

    from acg_tpu_torch.ops import kernels as K
    _log(args, f"kernel launches: {json.dumps(K.launches)}")
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _log(args, f"device memory peak: {peak:.3f} GiB")


def _multi(args) -> bool:
    """A multi-process run (``--multihost`` or ``--coordinator``)."""
    return bool(args.multihost or args.coordinator is not None)


def _stage_sync(args, stage: str, code: int = 0) -> int:
    """The cross-process stage sync (``acg_tpu/cli.py:1390-1402``): every
    process learns the worst status at a pipeline stage boundary, so all
    exit together, and a dead peer trips the watchdog (exit 97) instead
    of wedging the others in the next collective.  Single-process it
    returns ``code``."""
    if not _multi(args):
        return int(code)
    from acg_tpu_torch.parallel.erragree import agree_status
    return agree_status(code, what=stage, timeout=args.err_timeout)


def _is_primary() -> bool:
    from acg_tpu_torch.parallel.multihost import is_primary
    return is_primary()


def _close(solver) -> None:
    """Release the solver's peer mappings (collective on the
    multi-process tier)."""
    inner = getattr(solver, "inner", solver)
    close = getattr(inner, "close", None)
    if close is not None:
        close()


def _start_processes(args):
    """The device of this process: under ``--multihost`` join the run
    (``acg_tpu/cli.py:3201-3222``), print the ``multihost:`` line (the
    backend and why) and arm ``--heartbeat``; else resolve ``--device``."""
    from acg_tpu_torch._device import resolve_device

    if not _multi(args):
        if args.heartbeat > 0:
            sys.stderr.write("acg-tpu-torch: warning: --heartbeat is "
                             "multi-process dead-peer detection; no-op "
                             "without --multihost/--coordinator\n")
        return resolve_device(args.device)
    from acg_tpu_torch.parallel import multihost
    try:
        w = multihost.initialize(args.coordinator, args.num_processes,
                                 args.process_id, device=args.device,
                                 timeout=args.err_timeout + 60.0)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    sys.stderr.write(multihost.describe() + "\n")
    if args.heartbeat > 0:
        from acg_tpu_torch.parallel.erragree import DeadlineHeartbeat
        args._heartbeat = DeadlineHeartbeat(
            period=max(args.heartbeat / 6.0, 0.5),
            deadline=args.heartbeat).start()
    return w.device


def _main(args) -> int:
    from acg_tpu_torch.errors import (AcgError, BreakdownError,
                                      NotConvergedError)
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.cg import TorchCGSolver
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    # stage 0: the device, before anything expensive (the reference's
    # validation order)
    _validate_precision(args)
    _validate_algorithm(args)
    _validate_batched(args)
    _validate_operator(args)
    _validate_decision(args)
    _validate_robustness(args)
    _arm_observability(args)
    # the bounded liveness probe of the CUDA runtime, before anything
    # touches the card (acg_tpu/cli.py:3154-3172)
    from acg_tpu_torch._device import backend_probe_needed, probe_backend
    if backend_probe_needed(args.device):
        ok, detail = probe_backend()
        if not ok:
            sys.stderr.write(
                f"acg-tpu-torch: backend unavailable: {detail}.  Fix the "
                f"CUDA runtime, run with --device cpu for a host debug "
                f"solve, or set ACG_TPU_SKIP_BACKEND_PROBE=1 to wait out "
                f"a slow init\n")
            from acg_tpu_torch.errors import ExitCode
            return int(ExitCode.BACKEND_UNAVAILABLE)
    try:
        device = _start_processes(args)
    except AcgError as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        return 1
    dtype, vec_dtype = DTYPES[args.dtype]
    if args.commbench is not None or args.explain:
        return _run_decision_pass(args, device, dtype, vec_dtype)
    if args.distributed_read:
        return _solve_distributed_read(args, device, dtype, vec_dtype)
    if args.A.startswith("gen:"):
        kind, dim, n, N, _ = _parse_gen_spec(args.A)
        if (kind == "poisson" and N > _gen_direct_min()
                and args.aniso is None):
            # too large for the host matrix: the gen-direct tier (the
            # aniso family keeps the host route, as in acg_tpu)
            return _solve_generated_direct(args, dim, n, N, device, dtype,
                                           vec_dtype)

    # stages 1-4 under the ingest agreement: the host-local stages where
    # one process can fail alone
    ingest_rc, state = 0, None
    try:
        state = _ingest(args, device, args._phases)
    except (AcgError, OSError, SystemExit) as e:
        if not _multi(args):
            raise
        msg = str(e)
        sys.stderr.write(msg if msg.startswith("acg-tpu-torch:")
                         else f"acg-tpu-torch: {msg}")
        sys.stderr.write("\n")
        ingest_rc = 1
    rc = _stage_sync(args, "ingest", ingest_rc)
    if rc:
        if not ingest_rc:
            sys.stderr.write("acg-tpu-torch: aborting: a peer controller "
                             "failed during ingest\n")
        return rc
    A, csr, n, perm, nparts, part, b, x0, xsol = state
    if args.autotune:
        # the planner rewrites the parsed flags before the ordinary
        # construction below; it never alters a program
        _run_autotune(args, csr, part, nparts, b, dtype, vec_dtype, device)
    comm = args.comm
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
                                         trace=args._trace,
                                         progress=args.progress,
                                         device=device, ckpt=args._ckpt)
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
                                     precond=args._precond,
                                     trace=args._trace,
                                     progress=args.progress, device=device,
                                     ckpt=args._ckpt)
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
                                   host_matrix=csr,
                                   **_solver_options(args),
                                   **_robust_options(args))
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    else:
        from acg_tpu_torch.graph import comm_matrix, partition_matrix
        from acg_tpu_torch.parallel.dist import (DistCGSolver,
                                                 DistributedProblem,
                                                 resolve_comm)

        # multi-process: each process assembles the blocks of its own
        # parts only (acg_tpu/cli.py:3650-3669)
        owned = None
        if _multi(args):
            from acg_tpu_torch.parallel import mesh, multihost
            try:
                owned = mesh.owned_parts(nparts, multihost.process_index(),
                                         multihost.process_count())
            except ValueError as e:
                raise SystemExit(f"acg-tpu-torch: {e}")
        subs = partition_matrix(csr, part, nparts, owned_parts=owned)
        if args.output_comm_matrix:
            comm_mtx = comm_matrix(subs, nparts)
        prob = DistributedProblem.build(csr, part, nparts, dtype=dtype,
                                        subs=subs, vector_dtype=vec_dtype,
                                        owned_parts=owned)
        if args._operator_spec is not None:
            # matrix-free on the stacked parts: generated local planes
            # behind the same halo plan and ghost block
            from acg_tpu_torch.parallel.dist import arm_matfree
            arm_matfree(prob, _build_cli_operator(args, n, dtype, device))
        try:
            solver = DistCGSolver(prob, pipelined=pipelined,
                                  comm=resolve_comm(comm),
                                  kernels=args.kernels, device=device,
                                  **_solver_options(args),
                                  **_robust_options(args))
        except ValueError as e:
            raise SystemExit(f"acg-tpu-torch: {e}")
    if args.refine and not host:
        # the device solver inside the f64 host refinement loop
        from acg_tpu_torch.solvers.refine import RefinedSolver
        solver = RefinedSolver(solver, csr, inner_rtol=args.refine_rtol,
                               inner_maxits=args.refine_inner_maxits)
    # the host oracles run once: no warm-up solves
    solve_kw = {} if host else {"warmup": args.warmup}
    try:
        x = _run_solve(args, solver, criteria,
                       _soak_call(args, solver, b, x0, criteria, solve_kw),
                       nparts=nparts)
    except ValueError as e:
        raise SystemExit(f"acg-tpu-torch: {e}")
    except (NotConvergedError, BreakdownError) as e:
        sys.stderr.write(f"acg-tpu-torch: {e}\n")
        _finalize_plan(args, solver)
        _fold_phases(args, solver)
        if _is_primary():   # the stats block from rank 0 only
            solver.stats.fwrite(sys.stderr)
        # the convergence log matters most on a failed solve; no
        # collective gather on this path
        _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                        comm=comm, collective=False)
        _stage_sync(args, "solve", 1)
        _close(solver)
        return 1
    _log(args, "solve:", t0)
    rc = _stage_sync(args, "solve", 0)
    if rc:
        _close(solver)
        sys.stderr.write("acg-tpu-torch: aborting: a peer controller "
                         "failed during the solve\n")
        return rc
    _finalize_plan(args, solver)
    _after_solve(args, solver, b)
    _close(solver)
    # every process solves; only rank 0 speaks (the reference's
    # mtxfile_fwrite_mpi_double root-rank output), but every process
    # contributes to the telemetry gathers
    if not _is_primary():
        _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                        comm=comm)
        return 0
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
    t_wb = time.perf_counter()
    _emit_solution(args, x, perm)
    args._phases.add("writeback", time.perf_counter() - t_wb)
    # the structured sinks last, so they carry the writeback phase
    _emit_telemetry(args, solver, matrix_id=args.A, nparts=nparts,
                    comm=comm)
    return 0


def _run_decision_pass(args, device, dtype, vec_dtype) -> int:
    """``--commbench`` alone (the calibration document), or ``--explain``
    (with ``--commbench``: calibrated live; with ``--plan``: the ranked
    table without a solve) instead of a normal solve."""
    if not args.explain:
        from acg_tpu_torch.commbench import run_commbench
        return run_commbench(args, dtype, vec_dtype, device)
    if args.commbench is not None:
        # live calibration: collect the document, write it (stdout when
        # FILE is omitted: the verdict goes to stderr), then explain
        # against it
        from acg_tpu_torch import commbench
        doc = commbench.collect_document(args, dtype, vec_dtype,
                                         sys.stderr, device)
        try:
            commbench.write_document(doc, args.commbench)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --commbench "
                             f"{args.commbench}: {e}\n")
        args._calibration = doc
        args._calibration_source = "live --commbench run"
    if args.plan is not None:
        from acg_tpu_torch.planner import run_plan_explain
        return run_plan_explain(args, dtype, vec_dtype, device)
    from acg_tpu_torch.perfmodel import run_explain
    return run_explain(args, dtype, vec_dtype, device)


def _run_autotune(args, csr, part, nparts, b, dtype, vec_dtype,
                  device) -> None:
    """Plan, probe, dispatch (``acg_tpu/cli.py:1512-1560``): build the
    ranked plan, time its top candidates, and rewrite the parsed flags so
    the ordinary construction dispatches the winner.  A candidate the
    tier refuses to build, or whose probe ends in divergence or a
    breakdown, is disqualified; when none is left the flag-selected
    program dispatches with provenance ``fallback``.  On the card any
    other error of a probe (a kernel's among them) raises."""
    from acg_tpu_torch import planner

    err = sys.stderr
    doc = planner.plan_for_args(args, csr, nparts, dtype, vec_dtype,
                                device, part=part)
    err.write(planner.render_plan(doc))
    if args.plan not in (None, "-"):
        try:
            planner.write_plan(doc, args.plan)
        except OSError as e:
            err.write(f"acg-tpu-torch: --plan {args.plan}: {e}\n")
    decision = {"plan_id": doc["plan_id"],
                "calibration": doc["calibration"],
                "uncalibrated": bool(doc.get("uncalibrated")),
                "kappa_source": doc["kappa_source"],
                "correction_scale": doc["correction"]["scale"],
                "correction_nsamples": doc["correction"]["nsamples"],
                "key": doc["correction"]["key"]}
    probe_b = b[:, 0] if getattr(b, "ndim", 1) == 2 else b
    winner = planner.autotune_select(args, doc, csr, part, nparts, probe_b,
                                     dtype, vec_dtype, device, err)
    if winner is None:
        err.write("acg-tpu-torch: autotune: every probe failed; "
                  "dispatching the flag-selected program (provenance: "
                  "fallback)\n")
        args._plan_decision = {**decision, "source": "fallback"}
        return
    planner.apply_candidate_to_args(args, winner)
    err.write(f"acg-tpu-torch: autotune: dispatching {winner['label']} "
              f"(predicted {winner['predicted_s_per_solve']:.3e} s/solve, "
              f"{winner['predicted_iterations']} its)\n")
    args._plan_decision = {
        **decision, "source": "planned", "selected": winner["label"],
        "algorithm": winner["algorithm"], "kernels": winner["kernels"],
        "comm": winner["comm"], "precond": winner["precond"],
        "predicted_s_per_solve": winner["predicted_s_per_solve"],
        "predicted_iterations": winner["predicted_iterations"],
    }


def _finalize_plan(args, solver) -> None:
    """One planned solve's plan-vs-actual row (``acg_tpu/cli.py:
    1556-1578``): predicted against measured seconds and iterations and
    their ratio, in the ``plan:`` stats section, and from there in
    ``--stats-json`` and the ``--history`` ledger, where the next plan
    for the same key consults it."""
    dec = getattr(args, "_plan_decision", None)
    if dec is None or solver is None:
        return
    from acg_tpu_torch import metrics
    st = solver.stats
    plan = dict(dec)
    measured = float(st.tsolve or 0.0)
    plan["measured_s_per_solve"] = measured
    plan["measured_iterations"] = int(st.niterations)
    pred = dec.get("predicted_s_per_solve")
    if pred and measured > 0:
        plan["misprediction_ratio"] = float(pred) / measured
        metrics.record_plan_misprediction(plan["misprediction_ratio"])
    st.plan = plan
    metrics.record_plan_decision(dec.get("source", "planned"))
    args._plan_decision = None  # one solve, one row


def _ingest(args, device, phases):
    """Stages 1-4 (``acg_tpu/cli.py:3300-3460``): read or synthesize the
    matrix, assemble the symmetric CSR, partition the rows, build b and
    x0.  Returns ``(A, csr, n, perm, nparts, part, b, x0, xsol)``."""
    from acg_tpu_torch.errors import AcgError
    from acg_tpu_torch.io.mtxfile import read_mtx
    from acg_tpu_torch.matrix import SymCsrMatrix

    # stage 1: read (or synthesize) the matrix
    t_ingest = time.perf_counter()
    t0 = time.perf_counter()
    if args.A.startswith("gen:"):
        _, _, _, N, _ = _parse_gen_spec(args.A)
        _log(args, f"synthesizing {args.A} (N={N})")
        A = synthesize_host_matrix(args.A, aniso=args.aniso, seed=args.seed)
        _log(args, "synthesize matrix:", t0)
    else:
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
    phases.add("ingest", time.perf_counter() - t_ingest)
    n = A.nrows
    # partition-permuted input (mtx2bin --partition): the matrix on disk
    # is P A P^T, but b, x0 and the printed solution stay in the
    # original row order
    perm = (None if args.A.startswith("gen:")
            else _load_perm_sidecar(args.A, n))

    # stage 3: partition rows (cli.py:3348-3382)
    nparts = args.nparts or _default_nparts(device, args)
    t0 = time.perf_counter()
    part = _partition(args, csr, n, nparts)
    if args.partition:
        nparts = max(nparts, int(part.max()) + 1)
    _log(args, f"partition rows into {nparts} parts:", t0)
    phases.add("partition", time.perf_counter() - t0)

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
    return A, csr, n, perm, nparts, part, b, x0, xsol


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
        from acg_tpu_torch import faults
        if faults.device_fault() is not None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "fault injection has no injection sites in the "
                "multi-part host solver; use the serial host solver "
                "(--nparts 1) or the device solvers")
        if args._health is not None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "--audit-every/--stall-window have no hooks in the "
                "multi-part host solver; use --nparts 1 or the device "
                "solvers")
        if args._ckpt is not None:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "--ckpt/--resume have no hooks in the multi-part host "
                "solver; use --nparts 1 or the device solvers")
        if args._recovery is not None:
            sys.stderr.write(
                "acg-tpu-torch: warning: --recover has no effect on the "
                "multi-part host solver (no breakdown detection there)\n")
        if args._trace or args.progress:
            sys.stderr.write(
                "acg-tpu-torch: warning: --convergence-log/--progress "
                "have no hooks in the multi-part host solver; use "
                "--nparts 1 or the device solvers\n")
        return HostDistCGSolver(partition_matrix(csr, part, nparts))
    from acg_tpu_torch.solvers.host_cg import HostCGSolver
    return HostCGSolver(csr, recovery=args._recovery, trace=args._trace,
                        progress=args.progress, precond=args._precond,
                        health=args._health, ckpt=args._ckpt)


def _default_nparts(device, args=None) -> int:
    """The part count when ``--nparts`` is not given: under
    ``--multihost`` one part per process (``acg_tpu`` takes one part per
    device, ``cli.py:3348-3352``, and here each process has a card), else
    1, whatever the device and however many cards the host has: the port
    stacks a process's parts on its card, where k stacked parts only run
    slower than one.  ``--comm none`` is one part."""
    if args is not None and args.comm != "none" and _multi(args):
        from acg_tpu_torch.parallel import multihost
        return multihost.process_count()
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
