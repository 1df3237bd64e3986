"""Matrix Market file I/O (text, gzip, and raw binary).

A copy of ``acg_tpu/io/mtxfile.py`` restricted to what the
single-device path reads and writes: :func:`read_mtx` (text, gzipped
text, raw binary), :func:`write_mtx` and :func:`vector_mtx`.  The binary
data section is the concatenation of the row-index array, the
column-index array and the value array (int64, 1-based indices,
``mtxfile.c:1492-1497``), record-compatible with the JAX package's
files.  Parsing is numpy's C tokenizer; the native C++ fast path of the
JAX package is not part of the port.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

from acg_tpu_torch.errors import AcgError, ErrorCode

_VALID_OBJECTS = ("matrix", "vector")
_VALID_FORMATS = ("coordinate", "array")
_VALID_FIELDS = ("real", "double", "integer", "pattern")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")

IDX_DTYPE = np.int64  # matches reference acgidx_t at IDXSIZE=64 (config.h:59-95)


@dataclasses.dataclass
class MtxFile:
    """An in-memory Matrix Market file.

    Indices are stored 0-based internally; text/binary files on disk are
    1-based as mandated by the format.  ``vals`` is None for ``pattern``
    fields.  For ``format == "array"`` (dense), ``rowidx``/``colidx`` are
    None and ``vals`` holds the column-major entries.
    """

    object: str = "matrix"
    format: str = "coordinate"
    field: str = "real"
    symmetry: str = "general"
    nrows: int = 0
    ncols: int = 0
    nnz: int = 0
    rowidx: np.ndarray | None = None
    colidx: np.ndarray | None = None
    vals: np.ndarray | None = None
    comments: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.object not in _VALID_OBJECTS:
            raise AcgError(ErrorCode.INVALID_VALUE, f"object {self.object!r}")
        if self.format not in _VALID_FORMATS:
            raise AcgError(ErrorCode.INVALID_VALUE, f"format {self.format!r}")
        if self.field not in _VALID_FIELDS:
            raise AcgError(ErrorCode.INVALID_VALUE, f"field {self.field!r}")
        if self.symmetry not in _VALID_SYMMETRIES:
            raise AcgError(ErrorCode.INVALID_VALUE, f"symmetry {self.symmetry!r}")

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (rowidx, colidx, vals) as 0-based COO triplets.

        Pattern matrices get unit values.  Symmetry is NOT expanded here.
        """
        if self.format != "coordinate":
            raise AcgError(ErrorCode.NOT_SUPPORTED, "to_coo on array format")
        vals = self.vals
        if vals is None:
            vals = np.ones(self.nnz, dtype=np.float64)
        return self.rowidx, self.colidx, vals


def _open_maybe_gzip(path, mode="rb"):
    if isinstance(path, (str, os.PathLike)):
        f = open(path, mode)
        magic = f.read(2)
        f.seek(0)
        if magic == b"\x1f\x8b":
            return gzip.open(f, mode)
        return f
    return path


def _parse_header_line(line: str) -> tuple[str, str, str, str]:
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise AcgError(ErrorCode.INVALID_FORMAT, f"bad header: {line.strip()!r}")
    obj, fmt, field, sym = (p.lower() for p in parts[1:5])
    if field == "double":
        field = "real"
    return obj, fmt, field, sym


def read_mtx(path, binary: bool = False) -> MtxFile:
    """Read a Matrix Market file (text, gzipped text, or raw binary).

    ``binary`` selects the raw data section layout (the reference's
    ``--binary`` flag); gzip is auto-detected from the magic bytes.
    """
    f = _open_maybe_gzip(path, "rb")
    try:
        return _read_mtx_stream(f, binary)
    finally:
        if isinstance(path, (str, os.PathLike)):
            f.close()


def _read_header_meta(f):
    """Parse header line, comments, and size line from an open binary
    stream; returns (obj, fmt, field, sym, comments, nrows, ncols, nnz)
    with the stream positioned at the data section."""
    header = f.readline().decode("ascii", errors="replace")
    obj, fmt, field, sym = _parse_header_line(header)
    comments = []
    line = f.readline()
    while line.startswith(b"%"):
        comments.append(line.decode("utf-8", errors="replace").rstrip("\n"))
        line = f.readline()
    parts = line.split()
    if fmt == "coordinate":
        if len(parts) != 3:
            raise AcgError(ErrorCode.INVALID_FORMAT,
                           f"bad size line: {line!r}")
        nrows, ncols, nnz = (int(s) for s in parts)
    else:
        if obj == "vector" and len(parts) == 1:
            nrows, ncols = int(parts[0]), 1
        elif len(parts) == 2:
            nrows, ncols = int(parts[0]), int(parts[1])
        else:
            raise AcgError(ErrorCode.INVALID_FORMAT,
                           f"bad size line: {line!r}")
        nnz = nrows * ncols
    return obj, fmt, field, sym, comments, nrows, ncols, nnz


def _check_bounds(rowidx, colidx, nrows, ncols, nnz):
    if nnz > 0 and (rowidx.min() < 0 or rowidx.max() >= nrows
                    or colidx.min() < 0 or colidx.max() >= ncols):
        raise AcgError(ErrorCode.INDEX_OUT_OF_BOUNDS,
                       "mtx indices out of range")


def _read_mtx_stream(f, binary: bool) -> MtxFile:
    obj, fmt, field, sym, comments, nrows, ncols, nnz = _read_header_meta(f)

    rowidx = colidx = vals = None
    if fmt == "coordinate":
        if binary:
            rowidx = np.frombuffer(f.read(8 * nnz), dtype=IDX_DTYPE).copy()
            if rowidx.size != nnz:
                raise AcgError(ErrorCode.EOF, "binary rowidx truncated")
            colidx = np.frombuffer(f.read(8 * nnz), dtype=IDX_DTYPE).copy()
            if colidx.size != nnz:
                raise AcgError(ErrorCode.EOF, "binary colidx truncated")
            rowidx -= 1
            colidx -= 1
            if field != "pattern":
                vdt = np.float64 if field == "real" else np.int32
                vals = np.frombuffer(f.read(np.dtype(vdt).itemsize * nnz),
                                     dtype=vdt).copy()
                if vals.size != nnz:
                    raise AcgError(ErrorCode.EOF, "binary vals truncated")
        else:
            ncolumns = 2 if field == "pattern" else 3
            data = (np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
                    if nnz > 0 else np.zeros((0, ncolumns)))
            if data.shape[0] != nnz or (nnz > 0 and data.shape[1] < ncolumns):
                raise AcgError(ErrorCode.INVALID_FORMAT,
                               f"expected {nnz} x {ncolumns} data entries, "
                               f"got {data.shape}")
            rowidx = data[:, 0].astype(IDX_DTYPE) - 1
            colidx = data[:, 1].astype(IDX_DTYPE) - 1
            if field == "real":
                vals = np.ascontiguousarray(data[:, 2])
            elif field == "integer":
                vals = data[:, 2].astype(np.int32)
        _check_bounds(rowidx, colidx, nrows, ncols, nnz)
    else:  # array
        if binary:
            vdt = np.float64 if field == "real" else np.int32
            vals = np.frombuffer(f.read(np.dtype(vdt).itemsize * nnz),
                                 dtype=vdt).copy()
            if vals.size != nnz:
                raise AcgError(ErrorCode.EOF, "binary array vals truncated")
        else:
            vals = np.loadtxt(f, dtype=np.float64, ndmin=1,
                              max_rows=nnz).reshape(-1)
            if vals.size != nnz:
                raise AcgError(ErrorCode.INVALID_FORMAT,
                               f"expected {nnz} array entries, got {vals.size}")
            if field == "integer":
                vals = vals.astype(np.int32)

    return MtxFile(object=obj, format=fmt, field=field, symmetry=sym,
                   nrows=nrows, ncols=ncols, nnz=nnz,
                   rowidx=rowidx, colidx=colidx, vals=vals, comments=comments)


def write_mtx(path, mtx: MtxFile, binary: bool = False,
              numfmt: str = "%.17g") -> None:
    """Write a Matrix Market file (text or raw binary); the binary data
    section matches the reference's layout (rowidx, colidx, vals as
    consecutive raw arrays, 1-based int64 indices)."""
    own = isinstance(path, (str, os.PathLike))
    f = open(path, "wb") if own else path
    try:
        _write_mtx_stream(f, mtx, binary, numfmt)
    finally:
        if own:
            f.close()


def _binary_vals(mtx: MtxFile) -> np.ndarray:
    """Values coerced to the on-disk binary dtype (float64 or int32),
    matching what the reader expects for the declared field."""
    vdt = np.float64 if mtx.field == "real" else np.int32
    return np.ascontiguousarray(np.asarray(mtx.vals), dtype=vdt)


def _write_mtx_stream(f, mtx: MtxFile, binary: bool, numfmt: str) -> None:
    field = "double" if (binary and mtx.field == "real") else mtx.field
    f.write(f"%%MatrixMarket {mtx.object} {mtx.format} {field} "
            f"{mtx.symmetry}\n".encode())
    for c in mtx.comments:
        line = c if c.startswith("%") else "%" + c
        f.write((line.rstrip("\n") + "\n").encode())
    if mtx.format == "coordinate":
        f.write(f"{mtx.nrows} {mtx.ncols} {mtx.nnz}\n".encode())
        if binary:
            # tobytes + f.write (not ndarray.tofile) so stream targets work
            # and ordering with the buffered header is preserved
            f.write((np.asarray(mtx.rowidx, dtype=IDX_DTYPE) + 1).tobytes())
            f.write((np.asarray(mtx.colidx, dtype=IDX_DTYPE) + 1).tobytes())
            if mtx.vals is not None:
                f.write(_binary_vals(mtx).tobytes())
        else:
            r = np.asarray(mtx.rowidx) + 1
            c = np.asarray(mtx.colidx) + 1
            lines = np.char.add(np.char.add(r.astype(str), " "), c.astype(str))
            if mtx.vals is not None:
                valstr = np.array([numfmt % v for v in np.asarray(mtx.vals)])
                lines = np.char.add(np.char.add(lines, " "), valstr)
            f.write(("\n".join(lines.tolist()) + "\n").encode())
    else:
        if mtx.object == "vector":
            f.write(f"{mtx.nrows}\n".encode())
        else:
            f.write(f"{mtx.nrows} {mtx.ncols}\n".encode())
        if binary:
            f.write(_binary_vals(mtx).tobytes())
        else:
            vals = np.asarray(mtx.vals).reshape(-1)
            f.write(("\n".join(numfmt % v for v in vals) + "\n").encode())


def vector_mtx(x: np.ndarray, field: str = "real") -> MtxFile:
    """Wrap a dense vector as a Matrix Market array file object."""
    x = np.asarray(x)
    return MtxFile(object="matrix", format="array", field=field,
                   symmetry="general", nrows=x.size, ncols=1,
                   nnz=x.size, vals=x)
