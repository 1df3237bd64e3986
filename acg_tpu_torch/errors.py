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
