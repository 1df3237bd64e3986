"""Error codes and exceptions for the PyTorch port.

A copy of ``acg_tpu/errors.py`` restricted to what the ported paths
raise: one enum spanning every subsystem, its string conversion,
the solver exceptions, and the floating-point-exception report (NaN /
Inf observed in computed arrays, the role of the reference's
``fetestexcept`` decoding, ``error.c:62-142``).
"""

from __future__ import annotations

import enum

import numpy as np


class ErrorCode(enum.IntEnum):
    """Error codes, numbered as in ``acg_tpu.errors.ErrorCode``."""

    SUCCESS = 0
    ERRNO = 1
    EOF = 2
    LINE_TOO_LONG = 3
    INVALID_FORMAT = 4
    INVALID_VALUE = 5
    OVERFLOW = 6
    INDEX_OUT_OF_BOUNDS = 7
    NOT_SUPPORTED = 8
    NOT_CONVERGED = 9
    INVALID_PARTITION = 10
    FEXCEPT = 11
    DEVICE = 12
    KERNEL = 13
    METIS = 15
    NOT_CONVERGED_INDEFINITE_MATRIX = 17
    BREAKDOWN = 18


_ERRSTR = {
    ErrorCode.SUCCESS: "success",
    ErrorCode.ERRNO: "system error",
    ErrorCode.EOF: "unexpected end of file",
    ErrorCode.LINE_TOO_LONG: "line exceeds maximum length",
    ErrorCode.INVALID_FORMAT: "invalid file format",
    ErrorCode.INVALID_VALUE: "invalid value",
    ErrorCode.OVERFLOW: "integer overflow",
    ErrorCode.INDEX_OUT_OF_BOUNDS: "index out of bounds",
    ErrorCode.NOT_SUPPORTED: "operation not supported",
    ErrorCode.NOT_CONVERGED: "solver did not converge",
    ErrorCode.INVALID_PARTITION: "invalid partition",
    ErrorCode.FEXCEPT: "floating-point exception",
    ErrorCode.DEVICE: "device error",
    ErrorCode.KERNEL: "CUDA kernel error",
    ErrorCode.METIS: "graph partitioner error",
    ErrorCode.NOT_CONVERGED_INDEFINITE_MATRIX:
        "not converged (indefinite matrix)",
    ErrorCode.BREAKDOWN: "solver breakdown",
}


def errcodestr(code: ErrorCode) -> str:
    """Human-readable description of an error code (cf. ``acgerrcodestr``)."""
    return _ERRSTR.get(code, "unknown error")


class AcgError(Exception):
    """Exception carrying an :class:`ErrorCode` and optional detail."""

    def __init__(self, code: ErrorCode, detail: str = ""):
        self.code = ErrorCode(code)
        msg = errcodestr(self.code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


class NotConvergedError(AcgError):
    """Raised when a solver fails to meet its stopping criteria."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.NOT_CONVERGED, detail)


class IndefiniteMatrixError(AcgError):
    """Raised when CG hits (p, Ap) == 0: the matrix is not positive
    definite (the reference's ``ACG_ERR_NOT_CONVERGED_INDEFINITE_MATRIX``
    abort, ``cg.c:304``)."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.NOT_CONVERGED_INDEFINITE_MATRIX, detail)


class BreakdownError(AcgError):
    """Raised when the numerical state of a solve is junk (non-finite
    residual, non-positive (p, Ap)) and iterating further would only
    launder NaNs into a plausible-looking answer."""

    def __init__(self, detail: str = ""):
        super().__init__(ErrorCode.BREAKDOWN, detail)


class ExitCode(enum.IntEnum):
    """The process exit-code contract, with the JAX package's values
    (``acg_tpu/errors.py:110-130``): the CLI, the error agreement's
    watchdog and the heartbeat return these."""

    OK = 0
    FAILURE = 1                  # solve/config failure, agreed abort
    NOTHING_COMPARABLE = 2       # bench_diff: no case in common
    BACKEND_UNAVAILABLE = 3      # bounded backend probe failed
    DRIFT = 7                    # --fail-on-drift: EWMA latency drift
    SLO_BREACH = 8               # --fail-on-slo: declared objective
    PEER_DEAD_INJECTED = 86      # peer:dead fault fired on this rank
    CRASH_INJECTED = 94          # crash:exit fault fired (resumable)
    RELAUNCH_BUDGET = 95         # supervisor: relaunch budget spent
    WRONG_ANSWER = 96            # chaos: converged to a wrong answer
    PEER_LOST = 97               # erragree watchdog/heartbeat teardown


# (code, origin, meaning): the table --buildinfo renders and the
# supervisor's relaunch policy keys off (acg_tpu/errors.py:131-158)
EXIT_CONTRACT: tuple = (
    (ExitCode.OK, "everywhere", "success"),
    (ExitCode.FAILURE, "cli/solvers",
     "solve or configuration failure (agreed abort)"),
    (ExitCode.NOTHING_COMPARABLE, "bench_diff",
     "no comparable case between captures"),
    (ExitCode.BACKEND_UNAVAILABLE, "cli",
     "accelerator backend unavailable (bounded probe failed)"),
    (ExitCode.DRIFT, "soak",
     "--fail-on-drift: EWMA solve latency drifted past the gate"),
    (ExitCode.SLO_BREACH, "observatory",
     "--fail-on-slo: a declared service-level objective breached"),
    (ExitCode.PEER_DEAD_INJECTED, "faults",
     "peer:dead fault injector killed this controller"),
    (ExitCode.CRASH_INJECTED, "faults/checkpoint",
     "crash:exit fault injector killed this process between snapshot "
     "commits (relaunch with --resume)"),
    (ExitCode.RELAUNCH_BUDGET, "supervisor",
     "--supervise: relaunch budget exhausted without a converged run"),
    (ExitCode.WRONG_ANSWER, "supervisor",
     "--chaos: a schedule converged (rc 0) but failed the independent "
     "true-residual verification"),
    (ExitCode.PEER_LOST, "erragree",
     "a peer controller died (stage-sync watchdog or solve heartbeat); "
     "this process tore down so the supervisor can relaunch"),
)

# the supervisor's relaunch policy over the contract: the child exit
# codes worth another attempt from the last snapshot, and those of them
# that mean a LOST PEER (shrink onto the survivors)
RELAUNCHABLE_CODES = frozenset({
    int(ExitCode.FAILURE), int(ExitCode.BACKEND_UNAVAILABLE),
    int(ExitCode.PEER_DEAD_INJECTED), int(ExitCode.CRASH_INJECTED),
    int(ExitCode.PEER_LOST)})
PEER_LOST_CODES = frozenset({
    int(ExitCode.PEER_DEAD_INJECTED), int(ExitCode.PEER_LOST)})


def exit_code_table() -> list:
    """``[(int code, origin, meaning), ...]`` sorted by code: the
    ``--buildinfo`` rendering of the contract."""
    return [(int(c), o, m)
            for c, o, m in sorted(EXIT_CONTRACT, key=lambda r: int(r[0]))]


def fexcept_str(*arrays) -> str:
    """Report floating-point exceptions observable in computed arrays:
    NaN / Inf in the arrays produced by the solve (no trap flags are
    observable from a device kernel)."""
    flags = []
    for a in arrays:
        a = np.asarray(a)
        if np.isnan(a).any():
            flags.append("invalid (NaN)")
            break
    for a in arrays:
        a = np.asarray(a)
        if np.isinf(a).any():
            flags.append("overflow (Inf)")
            break
    return ", ".join(flags) if flags else "none"
