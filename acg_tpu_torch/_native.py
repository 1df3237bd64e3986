"""ctypes bindings to the native C++ host core (``native/src``).

The counterpart of ``acg_tpu/_native.py``.  ``native/src`` is the host
core both packages share, the role of aCG's C core: Matrix Market
parsing and formatting, radix sort, symmetric CSR assembly, the one-pass
graph partitioner and a host CG.  Every binding has a numpy twin in the
port (``io.mtxfile``, ``matrix``, ``graph``) that gives the same arrays
and bytes; the twin runs when the library cannot be built or
``ACG_TPU_DISABLE_NATIVE=1``.  :func:`available` says which path is in
use (``--buildinfo`` prints it), and ``--solver host-native`` raises
without the library.

The library is compiled at first import with ``g++`` and the flags of
``native/Makefile`` (one ``g++`` per source, all started together), into
``acg_tpu_torch/_build/native-<hash>/libacg_core.so``, keyed by a hash of
the sources, the flags and the host CPU (``-march=native``), so a
checkout builds once per machine.  Where the compiler cannot link
OpenMP (no libgomp), it builds serial, without ``-fopenmp``: the
sources guard every OpenMP use, and the serial library gives the same
arrays (:data:`openmp_error` says why).  Nothing is written under
``native/``.

All wrappers take and return numpy arrays, with int64 indices throughout
(the reference's ``acgidx_t`` at IDXSIZE=64).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F64 = ctypes.POINTER(ctypes.c_double)

_SRC_DIR = Path(__file__).resolve().parent.parent / "native" / "src"
_BUILD_ROOT = Path(__file__).resolve().parent / "_build"
# native/Makefile:5-6
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-Wall", "-Wextra",
            "-march=native")
LDFLAGS = ("-shared", "-fopenmp")
_SOURCES = ("sort.cpp", "mtxparse.cpp", "csr.cpp", "graph.cpp", "cg.cpp")

_ABI_VERSION = 3  # must match acg_core_abi_version() (native/src/sort.cpp)


def _flags(openmp: bool) -> tuple:
    """``(cxxflags, ldflags)``: the Makefile's, or the same without
    ``-fopenmp`` (the sources guard every OpenMP use with ``_OPENMP``),
    for a host whose compiler has no libgomp to link."""
    if openmp:
        return CXXFLAGS, LDFLAGS
    return (tuple(f for f in CXXFLAGS if f != "-fopenmp"),
            tuple(f for f in LDFLAGS if f != "-fopenmp"))


def _cpu_id() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` code
    built on one machine may not run on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        import platform
        return platform.processor().encode()


def source_hash(openmp: bool = True) -> str:
    """Hash of the native sources and header, the flags and the CPU."""
    cxx, ld = _flags(openmp)
    h = hashlib.sha256(" ".join(cxx + ld).encode())
    h.update(_cpu_id())
    for f in sorted(_SRC_DIR.glob("*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(openmp: bool = True) -> Path:
    return (_BUILD_ROOT / f"native-{source_hash(openmp)}"
            / "libacg_core.so")


def _compile(openmp: bool) -> Path:
    """Compile ``native/src`` into :func:`library_path` (one ``g++`` per
    source, all started together, then one link, in a temporary
    directory renamed into place); raises on failure."""
    out = library_path(openmp)
    cxxflags, ldflags = _flags(openmp)
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="native-build-", dir=_BUILD_ROOT))
    try:
        procs = []
        for name in _SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [cxx, *cxxflags, "-c", "-o", str(obj),
                   str(_SRC_DIR / name)]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for obj, proc in procs:
            text, _ = proc.communicate(timeout=300)
            if proc.returncode != 0:
                failed.append(f"{obj.stem}: {text.decode(errors='replace')}")
        if not failed:
            res = subprocess.run(
                [cxx, *ldflags, "-o", str(tmp / out.name),
                 *(str(o) for o, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                timeout=300)
            if res.returncode != 0:
                failed.append(f"link: {res.stdout.decode(errors='replace')}")
        if failed:
            raise RuntimeError("native core build failed:\n"
                               + "\n".join(failed))
        try:
            os.replace(tmp, out.parent)
        except OSError:
            # another process finished the same build first
            if not out.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return out


openmp_error: str | None = None


def build() -> Path:
    """The library, built once per checkout and machine: with the
    Makefile's flags, or -- when that build fails (a compiler without
    libgomp) -- serial, without ``-fopenmp``; :data:`openmp_error` then
    says why.  Raises when neither builds."""
    global openmp_error
    if library_path(True).exists():
        return library_path(True)
    if library_path(False).exists():
        openmp_error = "an earlier OpenMP build failed on this machine"
        return library_path(False)
    try:
        return _compile(True)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        openmp_error = " ".join(str(e).split())[:2000]
    return _compile(False)


def _open_and_bind(path):
    """CDLL + version check + symbol binding; None on a mismatch."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    c = ctypes.c_int64
    try:
        lib.acg_core_abi_version.restype = ctypes.c_int32
        if lib.acg_core_abi_version() != _ABI_VERSION:
            return None
        _bind(lib, c)
    except AttributeError:
        return None
    return lib


build_error: str | None = None
_path: Path | None = None


def _load():
    """The bound library, or None when disabled or the build failed
    (the reason is kept in :data:`build_error`)."""
    global build_error
    if os.environ.get("ACG_TPU_DISABLE_NATIVE"):
        build_error = "disabled (ACG_TPU_DISABLE_NATIVE)"
        return None
    global _path
    try:
        path = _path = build()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_error = " ".join(str(e).split())[:2000] or type(e).__name__
        return None
    lib = _open_and_bind(path)
    if lib is None:
        build_error = f"{path}: not loadable or ABI mismatch"
    return lib


def _bind(lib, c):
    lib.acg_radixsort_i64.argtypes = [c, _I64, _I64]
    lib.acg_radixargsort_i64.argtypes = [c, _I64, _I64]
    lib.acg_prefixsum_exclusive_i64.argtypes = [c, _I64]
    lib.acg_mtx_parse_coord.restype = c
    lib.acg_mtx_parse_coord.argtypes = [
        ctypes.c_char_p, c, c, c, c, ctypes.c_int32, _I64, _I64, _F64]
    lib.acg_mtx_parse_array.restype = c
    lib.acg_mtx_parse_array.argtypes = [ctypes.c_char_p, c, c, _F64]
    lib.acg_mtx_format_coord.restype = c
    lib.acg_mtx_format_coord.argtypes = [
        c, _I64, _I64, _F64, ctypes.c_char_p, ctypes.c_char_p, c]
    lib.acg_mtx_format_array.restype = c
    lib.acg_mtx_format_array.argtypes = [
        c, _F64, ctypes.c_char_p, ctypes.c_char_p, c]
    lib.acg_sym_csr_count.restype = c
    lib.acg_sym_csr_count.argtypes = [c, c, _I64, _I64, _I64, _I64, _I32]
    lib.acg_sym_csr_fill.restype = c
    lib.acg_sym_csr_fill.argtypes = [c, c, c, _I64, _I64, _F64,
                                     ctypes.c_int32, _I64, _I64, _F64]
    lib.acg_sym_csr_expand.restype = c
    lib.acg_sym_csr_expand.argtypes = [c, _I64, _I64, _F64,
                                       ctypes.c_double, _I64, _I64, _F64, c]
    lib.acg_graph_partition_run.restype = ctypes.c_void_p
    lib.acg_graph_partition_run.argtypes = [c, _I64, _I64, _I32,
                                            ctypes.c_int32]
    lib.acg_pr_counts.argtypes = [ctypes.c_void_p, _I64, _I64, _I64, _I64]
    lib.acg_pr_fill.argtypes = [ctypes.c_void_p, _I64, _I32, _I32, _I64,
                                _I64]
    lib.acg_pr_free.argtypes = [ctypes.c_void_p]
    lib.acg_cg_solve.restype = ctypes.c_int32
    lib.acg_cg_solve.argtypes = [
        c, _I64, _I64, _F64, _F64, _F64, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        _I32, _F64, _F64, _F64, _F64]


_lib = _load()


def available() -> bool:
    return _lib is not None


def describe() -> str:
    """Which path is in use, for ``--buildinfo``."""
    if _lib is None:
        return f"no (numpy fallbacks: {build_error})"
    if openmp_error is None:
        return f"yes, OpenMP ({_path})"
    return (f"yes, serial: the OpenMP build failed ({openmp_error[:200]}) "
            f"({_path})")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype) if a.size else None


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


# ---- sort / scan ---------------------------------------------------------

def radixsort(keys: np.ndarray, return_perm: bool = True):
    """Sort int64 keys ascending (stable); optionally return the argsort."""
    keys = _i64(keys).copy()
    n = keys.size
    perm = np.empty(n, dtype=np.int64) if return_perm else None
    _lib.acg_radixsort_i64(n, _ptr(keys, _I64),
                           _ptr(perm, _I64) if return_perm else None)
    return (keys, perm) if return_perm else keys


def argsort(keys: np.ndarray) -> np.ndarray:
    keys = _i64(keys)
    perm = np.empty(keys.size, dtype=np.int64)
    _lib.acg_radixargsort_i64(keys.size, _ptr(keys, _I64), _ptr(perm, _I64))
    return perm


def prefixsum_exclusive(a: np.ndarray) -> np.ndarray:
    """[a0, a1, ...] -> [0, a0, a0+a1, ..., total] (n+1 entries)."""
    a = _i64(a)
    out = np.empty(a.size + 1, dtype=np.int64)
    out[: a.size] = a
    out[a.size] = 0
    _lib.acg_prefixsum_exclusive_i64(a.size, _ptr(out, _I64))
    return out


# ---- Matrix Market data sections ----------------------------------------

class NativeParseError(Exception):
    def __init__(self, code: int):
        super().__init__(f"native parse error {code}")
        self.code = int(code)


def parse_coord(buf: bytes, nnz: int, nrows: int, ncols: int,
                with_vals: bool):
    """Parse coordinate data lines; returns (rowidx, colidx, vals|None),
    0-based and bounds-checked."""
    rowidx = np.empty(nnz, dtype=np.int64)
    colidx = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64) if with_vals else None
    rc = _lib.acg_mtx_parse_coord(
        buf, len(buf), nnz, nrows, ncols, 1 if with_vals else 0,
        _ptr(rowidx, _I64), _ptr(colidx, _I64),
        _ptr(vals, _F64) if with_vals else None)
    if rc < 0:
        raise NativeParseError(rc)
    return rowidx, colidx, vals


def parse_array(buf: bytes, n: int) -> np.ndarray:
    vals = np.empty(n, dtype=np.float64)
    rc = _lib.acg_mtx_parse_array(buf, len(buf), n, _ptr(vals, _F64))
    if rc < 0:
        raise NativeParseError(rc)
    return vals


import re

_FLOAT_FMT = re.compile(r"^[^%]*%[-+ #0-9.]*[eEfFgG][^%]*$")


def _fmt_width(fmt: str) -> int:
    """Upper-bound the printed width of one value under ``fmt`` by probing
    extreme doubles (overflow is caught by the C side and surfaces as a
    NativeParseError, so a too-small probe only costs a fallback).  Only
    float conversions are supported: the C side passes a double vararg, so
    %d-style formats must take the Python fallback."""
    if not _FLOAT_FMT.match(fmt):
        raise NativeParseError(-1)
    probes = (1.7976931348623157e308, -2.2250738585072014e-308,
              -1.2345678901234567e-5, float("inf"))
    return max(len(fmt % v) for v in probes) + 4


def format_coord(rowidx, colidx, vals, fmt: str = "%.17g") -> bytes:
    rowidx = _i64(rowidx)
    colidx = _i64(colidx)
    nnz = rowidx.size
    vals = None if vals is None else np.ascontiguousarray(vals, np.float64)
    idxw = (len(str(int(rowidx.max()) + 1)) + len(str(int(colidx.max()) + 1))
            if nnz else 2)
    est = idxw + 3 + (_fmt_width(fmt) if vals is not None else 0)
    cap = nnz * est + 128
    out = ctypes.create_string_buffer(cap)
    rc = _lib.acg_mtx_format_coord(
        nnz, _ptr(rowidx, _I64), _ptr(colidx, _I64),
        _ptr(vals, _F64) if vals is not None else None,
        fmt.encode(), out, cap)
    if rc < 0:
        raise NativeParseError(rc)
    return out.raw[:rc]


def format_array(vals, fmt: str = "%.17g") -> bytes:
    vals = np.ascontiguousarray(vals, np.float64).reshape(-1)
    cap = vals.size * (_fmt_width(fmt) + 2) + 128
    out = ctypes.create_string_buffer(cap)
    rc = _lib.acg_mtx_format_array(vals.size, _ptr(vals, _F64),
                                   fmt.encode(), out, cap)
    if rc < 0:
        raise NativeParseError(rc)
    return out.raw[:rc]


# ---- symmetric CSR assembly ---------------------------------------------

def sym_csr_from_coo(nrows: int, rowidx, colidx, vals):
    """COO -> packed-upper CSR (prowptr, pcolidx, pa); duplicates summed,
    mirrored full-storage input halved (SymCsrMatrix.from_coo semantics)."""
    rowidx = _i64(rowidx)
    colidx = _i64(colidx)
    vals = None if vals is None else np.ascontiguousarray(vals, np.float64)
    nnz = rowidx.size
    workkeys = np.empty(nnz, dtype=np.int64)
    workperm = np.empty(nnz, dtype=np.int64)
    mirrored = np.zeros(1, dtype=np.int32)
    pnnz = _lib.acg_sym_csr_count(nrows, nnz, _ptr(rowidx, _I64),
                                  _ptr(colidx, _I64), _ptr(workkeys, _I64),
                                  _ptr(workperm, _I64), _ptr(mirrored, _I32))
    if pnnz < 0:
        raise NativeParseError(pnnz)
    prowptr = np.empty(nrows + 1, dtype=np.int64)
    pcolidx = np.empty(pnnz, dtype=np.int64)
    pa = np.empty(pnnz, dtype=np.float64)
    if vals is None:
        vals = np.ones(nnz, dtype=np.float64)
    rc = _lib.acg_sym_csr_fill(nrows, nnz, pnnz, _ptr(workkeys, _I64),
                               _ptr(workperm, _I64), _ptr(vals, _F64),
                               int(mirrored[0]), _ptr(prowptr, _I64),
                               _ptr(pcolidx, _I64), _ptr(pa, _F64))
    if rc < 0:
        raise NativeParseError(rc)
    return prowptr, pcolidx, pa


def sym_csr_expand(nrows: int, prowptr, pcolidx, pa, epsilon: float = 0.0):
    """Packed upper CSR -> full-storage CSR (+ epsilon*I), sorted columns."""
    prowptr = _i64(prowptr)
    pcolidx = _i64(pcolidx)
    pa = np.ascontiguousarray(pa, np.float64)
    cap = 2 * pcolidx.size + (nrows if epsilon else 0)
    frowptr = np.empty(nrows + 1, dtype=np.int64)
    fcolidx = np.empty(max(cap, 1), dtype=np.int64)
    fa = np.empty(max(cap, 1), dtype=np.float64)
    rc = _lib.acg_sym_csr_expand(nrows, _ptr(prowptr, _I64),
                                 _ptr(pcolidx, _I64), _ptr(pa, _F64),
                                 float(epsilon), _ptr(frowptr, _I64),
                                 _ptr(fcolidx, _I64), _ptr(fa, _F64), cap)
    if rc < 0:
        raise NativeParseError(rc)
    return frowptr, fcolidx[:rc].copy(), fa[:rc].copy()


# ---- graph partitioning --------------------------------------------------

def graph_partition(nrows: int, frowptr, fcolidx, part, nparts: int):
    """One-pass subdomain construction.  Returns a dict of per-part counts
    and ragged arrays (see native/src/acg_core.h acg_pr_fill layout)."""
    frowptr = _i64(frowptr)
    fcolidx = _i64(fcolidx)
    part = np.ascontiguousarray(part, dtype=np.int32)
    handle = _lib.acg_graph_partition_run(
        nrows, _ptr(frowptr, _I64), _ptr(fcolidx, _I64), _ptr(part, _I32),
        nparts)
    if not handle:
        raise NativeParseError(-3)
    try:
        nowned = np.empty(nparts, dtype=np.int64)
        ninterior = np.empty(nparts, dtype=np.int64)
        nghost = np.empty(nparts, dtype=np.int64)
        nsend = np.empty(nparts, dtype=np.int64)
        _lib.acg_pr_counts(handle, _ptr(nowned, _I64), _ptr(ninterior, _I64),
                           _ptr(nghost, _I64), _ptr(nsend, _I64))
        global_ids = np.empty(int((nowned + nghost).sum()), dtype=np.int64)
        ghost_owner = np.empty(int(nghost.sum()), dtype=np.int32)
        send_part = np.empty(int(nsend.sum()), dtype=np.int32)
        send_gid = np.empty(int(nsend.sum()), dtype=np.int64)
        send_lidx = np.empty(int(nsend.sum()), dtype=np.int64)
        _lib.acg_pr_fill(handle, _ptr(global_ids, _I64),
                         _ptr(ghost_owner, _I32), _ptr(send_part, _I32),
                         _ptr(send_gid, _I64), _ptr(send_lidx, _I64))
    finally:
        _lib.acg_pr_free(handle)
    return dict(nowned=nowned, ninterior=ninterior, nghost=nghost,
                nsend=nsend, global_ids=global_ids, ghost_owner=ghost_owner,
                send_part=send_part, send_gid=send_gid, send_lidx=send_lidx)


# ---- host CG solver ------------------------------------------------------

def cg_solve(rowptr, colidx, vals, b, x0=None, maxits=100, res_atol=0.0,
             res_rtol=0.0, diff_atol=0.0, diff_rtol=0.0):
    """Native classic-CG solve over full-storage CSR (acg_cg_solve).

    Returns ``(x, r, niter, rnrm2, r0nrm2, dxnrm2, converged,
    indefinite)`` -- ``r`` is the final residual vector (for the
    caller's FP-exception scan) and ``indefinite`` reports the
    reference's (p, Ap) == 0 abort (``ACG_ERR_NOT_CONVERGED_
    INDEFINITE_MATRIX``, cg.c:304).  The C loop mirrors
    ``solvers.host_cg.HostCGSolver`` exactly (see native/src/cg.cpp),
    so the two host oracles cross-check each other.
    """
    rowptr = _i64(rowptr)
    colidx = _i64(colidx)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    x = (np.zeros_like(b) if x0 is None
         else np.array(x0, dtype=np.float64, copy=True))
    n = b.size
    # validate shapes BEFORE crossing into C: the native loop writes
    # x[0..n) and reads rowptr[0..n], trusting the caller
    if x.shape != (n,):
        raise ValueError(f"x0 has shape {x.shape}, need ({n},)")
    if rowptr.shape != (n + 1,):
        raise ValueError(f"rowptr has shape {rowptr.shape}, need ({n + 1},)")
    nnz = int(rowptr[-1])
    if colidx.size < nnz or vals.size < nnz:
        raise ValueError(f"colidx/vals have {colidx.size}/{vals.size} "
                         f"entries, rowptr ends at {nnz}")
    if nnz and (colidx[:nnz].min() < 0 or colidx[:nnz].max() >= n):
        raise ValueError("colidx out of range")
    niter = np.zeros(1, dtype=np.int32)
    out = np.zeros(3, dtype=np.float64)  # rnrm2, r0nrm2, dxnrm2
    r = np.zeros_like(b)
    rc = _lib.acg_cg_solve(
        n, _ptr(rowptr, _I64), _ptr(colidx, _I64), _ptr(vals, _F64),
        _ptr(b, _F64), _ptr(x, _F64), int(maxits),
        float(res_atol), float(res_rtol), float(diff_atol), float(diff_rtol),
        _ptr(niter, _I32), _ptr(out[0:], _F64), _ptr(out[1:], _F64),
        _ptr(out[2:], _F64), _ptr(r, _F64))
    if rc < 0:
        raise ValueError(f"acg_cg_solve: invalid input (code {rc})")
    return (x, r, int(niter[0]), float(out[0]), float(out[1]), float(out[2]),
            rc == 0, rc == 2)
