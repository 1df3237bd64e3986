"""Build and load the port's CUDA kernels.

The sources under ``acg_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source started
together, and linked into one shared library with a plain C interface
that :mod:`ctypes` loads.  The library lands in ``acg_tpu_torch/_build/
<hash>/``, keyed by a hash of the sources and flags, so a checkout builds
once and every later process reuses it.  A failed build raises: nothing
falls back to the plain PyTorch versions.

``--fmad=false`` keeps ``a*b + c`` a rounded multiply and a rounded add,
as PyTorch's separate elementwise ops compute it, so each kernel's
vector outputs are bitwise-equal to its plain version; only the dots,
summed in another order, differ.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh, enum AcgDtype)
DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U = ctypes.c_uint
_LP = ctypes.POINTER(ctypes.c_longlong)   # a host int64 array
_PP = ctypes.POINTER(ctypes.c_void_p)     # a host pointer slot
# argtypes of every exported function; each returns a cudaError_t (the
# launches cudaGetLastError())
_SIGNATURES = {
    "acg_dia_spmv": (_I, _I, _P, _LP, _I, _L, _P, _P, _P, _P, _P),
    "acg_cg_phase_a": (_I, _I, _P, _P, _I, _L, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P),
    "acg_cg_phase_b": (_I, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P),
    "acg_pipelined_update": (_I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P),
    "acg_halo_put": (_I, _P, _P, _I, _L, _I, _P, _P),
    "acg_halo_put_peer": (_I, _P, _P, _I, _I, _I, _L, _I, _P, _I, _P),
    "acg_memops_init": (_I, ctypes.POINTER(ctypes.c_int)),
    "acg_memops": (_I, _P, _P, _P, _U, _I, _P),
    "acg_stream_create": (_PP,),
    "acg_stream_destroy": (_P,),
    "acg_ipc_alloc": (_I, _L, _PP),
    "acg_ipc_handle": (_P, _P),
    "acg_ipc_open": (_I, _P, _PP),
    "acg_ipc_close": (_P,),
    "acg_ipc_free": (_P,),
    "acg_ipc_handle_size": (),
    "acg_stencil_spmv": (_I, _I, _L, _I, _L, _P, _P, _P, _P, _P),
    "acg_part_dot": (_I, _I, _L, _L, _P, _L, _P, _L, _P, _P, _P, _P),
    "acg_part_dot_blocks": (_L,),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand.append(os.path.join(home, "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and header plus the compile flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libacg_kernels.so"


def build() -> Path:
    """Compile the kernels into :func:`library_path` unless it exists;
    returns the path.  Each source compiles in its own ``nvcc`` process,
    all started together; compiler output (with ``-Xptxas -v`` register
    and spill counts) is kept in ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for cmd, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + text)
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(obj.stem)
        if not failed:
            cmd = [nvcc, ARCH, "-shared", "-o", str(tmp / out.name), *objs]
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(cmd) + "\n" + res.stdout)
            if res.returncode != 0:
                failed.append("link")
        (tmp / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)})"
                               f":\n" + "\n".join(log))
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


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"{err}")
