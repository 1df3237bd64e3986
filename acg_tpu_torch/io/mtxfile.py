"""Matrix Market I/O (host numpy).

A copy of ``acg_tpu/io/mtxfile.py`` (``acg/mtxfile.c``): :func:`read_mtx`
(text, gzipped text, raw binary), :func:`write_mtx`, the offline tools'
full-storage expansion and partition permutation
(:func:`expand_to_rowsorted_full`, :func:`apply_partition_rowsorted`),
the multi-column vectors of ``--nrhs`` (:func:`multi_vector_mtx`,
:func:`vector_columns`), and the range reads and writes of the
multi-process ingest and output (:func:`read_mtx_row_range`,
:func:`read_vector_window`, :func:`read_vector_rows`,
:func:`write_vector_window`, :func:`finalize_vector_file`).  The binary data section is the concatenation
of the row-index array, the column-index array and the value array
(int64, 1-based indices, ``mtxfile.c:1492-1497``), record-compatible
with the JAX package's files.

Parsing and formatting take the native C++ host core
(:mod:`acg_tpu_torch._native`) when its library is built, and numpy's C
tokenizer otherwise (or with ``ACG_TPU_DISABLE_NATIVE=1``); both give
the same arrays and the same bytes.
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

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry == "symmetric"

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (rowidx, colidx, vals) as 0-based COO triplets.

        Pattern matrices get unit values.  Symmetry is NOT expanded here;
        see :func:`expand_symmetry`.
        """
        if self.format != "coordinate":
            raise AcgError(ErrorCode.NOT_SUPPORTED, "to_coo on array format")
        vals = self.vals
        if vals is None:
            vals = np.ones(self.nnz, dtype=np.float64)
        return self.rowidx, self.colidx, vals


def expand_symmetry(rowidx, colidx, vals, nrows=None):
    """Expand one-triangle symmetric COO into full COO (both triangles)."""
    offdiag = rowidx != colidx
    r2 = np.concatenate([rowidx, colidx[offdiag]])
    c2 = np.concatenate([colidx, rowidx[offdiag]])
    v2 = np.concatenate([vals, vals[offdiag]])
    return r2, c2, v2


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

    Equivalent of ``acgmtxfile_read/fread/gzread`` (``mtxfile.h:352-416``).
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
                vals = np.frombuffer(f.read(np.dtype(vdt).itemsize * nnz), dtype=vdt).copy()
                if vals.size != nnz:
                    raise AcgError(ErrorCode.EOF, "binary vals truncated")
            if nnz > 0 and (rowidx.min() < 0 or rowidx.max() >= nrows
                            or colidx.min() < 0 or colidx.max() >= ncols):
                raise AcgError(ErrorCode.INDEX_OUT_OF_BOUNDS,
                               "mtx indices out of range")
        else:
            from acg_tpu_torch import _native
            if _native.available() and nnz > 0:
                try:
                    rowidx, colidx, vals = _native.parse_coord(
                        f.read(), nnz, nrows, ncols, field != "pattern")
                except _native.NativeParseError as e:
                    code = {-2: ErrorCode.EOF,
                            -3: ErrorCode.INDEX_OUT_OF_BOUNDS}.get(
                        e.code, ErrorCode.INVALID_FORMAT)
                    raise AcgError(code, "bad coordinate data section")
                if field == "integer":
                    vals = vals.astype(np.int32)
            else:
                ncolumns = 2 if field == "pattern" else 3
                data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz) if nnz > 0 else np.zeros((0, ncolumns))
                if data.shape[0] != nnz or (nnz > 0 and data.shape[1] < ncolumns):
                    raise AcgError(ErrorCode.INVALID_FORMAT, f"expected {nnz} x {ncolumns} data entries, got {data.shape}")
                rowidx = data[:, 0].astype(IDX_DTYPE) - 1
                colidx = data[:, 1].astype(IDX_DTYPE) - 1
                if field == "real":
                    vals = np.ascontiguousarray(data[:, 2])
                elif field == "integer":
                    vals = data[:, 2].astype(np.int32)
                # (the native parser bounds-checks inline)
                if nnz > 0 and (rowidx.min() < 0 or rowidx.max() >= nrows
                                or colidx.min() < 0 or colidx.max() >= ncols):
                    raise AcgError(ErrorCode.INDEX_OUT_OF_BOUNDS,
                                   "mtx indices out of range")
    else:  # array
        if binary:
            vdt = np.float64 if field == "real" else np.int32
            vals = np.frombuffer(f.read(np.dtype(vdt).itemsize * nnz), dtype=vdt).copy()
            if vals.size != nnz:
                raise AcgError(ErrorCode.EOF, "binary array vals truncated")
        else:
            from acg_tpu_torch import _native
            if _native.available() and nnz > 0:
                try:
                    vals = _native.parse_array(f.read(), nnz)
                except _native.NativeParseError as e:
                    code = ErrorCode.EOF if e.code == -2 else ErrorCode.INVALID_FORMAT
                    raise AcgError(code, "bad array data section")
            else:
                vals = np.loadtxt(f, dtype=np.float64, ndmin=1, max_rows=nnz).reshape(-1)
                if vals.size != nnz:
                    raise AcgError(ErrorCode.INVALID_FORMAT, f"expected {nnz} array entries, got {vals.size}")
            if field == "integer":
                vals = vals.astype(np.int32)

    return MtxFile(object=obj, format=fmt, field=field, symmetry=sym,
                   nrows=nrows, ncols=ncols, nnz=nnz,
                   rowidx=rowidx, colidx=colidx, vals=vals, comments=comments)


def _rowcol_argsort(r: np.ndarray, c: np.ndarray,
                    ncols: int) -> np.ndarray:
    """Stable argsort by (row, col) -- the hot host operation of the
    offline expand/permute tools (O(nnz log nnz) over ~1e9 entries at
    512^3 scale).  Uses the native int64 radix argsort
    (``native/src/sort.cpp``) on the fused key ``row * ncols + col``
    when the key fits int64; numpy lexsort otherwise."""
    from acg_tpu_torch import _native

    r = np.asarray(r)
    c = np.asarray(c)
    # the fused key is only collision-free when every column index is
    # strictly below the stride (callers may pass permuted indices up
    # to nrows-1 on rectangular files -- guard, don't assume)
    if _native.available() and r.size:
        stride = max(int(ncols), int(c.max(initial=0)) + 1)
        if int(r.max(initial=0) + 1) * stride < 2 ** 63:
            key = r.astype(np.int64) * np.int64(stride) + c.astype(np.int64)
            return _native.argsort(key)
    return np.lexsort((c, r))


def expand_to_rowsorted_full(mtx: MtxFile) -> MtxFile:
    """Expand one-triangle symmetric storage to FULL storage with entries
    sorted by (row, col), symmetry declared ``general``.

    This is the offline preprocessing step (``mtx2bin --expand``) that
    makes a binary file RANGE-READABLE: with full storage, every entry of
    row i lives in row i's contiguous span, so a controller can read
    exactly its rows (:func:`read_mtx_row_range`) -- one-triangle files
    scatter row i's upper entries into other rows' spans."""
    if mtx.symmetry not in ("general", "symmetric"):
        raise AcgError(ErrorCode.NOT_SUPPORTED,
                       f"cannot expand {mtx.symmetry!r} storage (only "
                       f"general/symmetric)")
    r, c, v = mtx.to_coo()
    if mtx.symmetry == "symmetric":
        r, c, v = expand_symmetry(r, c, v, mtx.nrows)
    order = _rowcol_argsort(r, c, mtx.ncols)
    return MtxFile(object=mtx.object, format=mtx.format, field=mtx.field,
                   symmetry="general", nrows=mtx.nrows, ncols=mtx.ncols,
                   nnz=int(r.size), rowidx=r[order], colidx=c[order],
                   vals=None if v is None else np.asarray(v)[order],
                   comments=list(mtx.comments))


def apply_partition_rowsorted(mtx: MtxFile, part: np.ndarray):
    """Symmetrically permute FULL-storage ``mtx`` so each partition's
    rows are CONTIGUOUS: rows grouped by part id (stable -- natural
    order within a part), columns renumbered by the same permutation
    (P A P^T), entries re-sorted by (row, col).

    This is what lets an arbitrary (METIS/graph) partition ride the
    band-partition range-read machinery unchanged: after grouping,
    part p owns rows ``[bounds[p], bounds[p+1])`` of the permuted
    matrix, so :func:`read_mtx_row_range` +
    ``graph.subdomain_from_row_slice`` (which is fully general in
    column connectivity) reconstruct exactly the partition METIS chose.
    The role of the reference's partition/permute/compact of matrix
    files (``acgmtxfilepartition``, ``mtxfile.h:436,1450``) restated
    for rootless range reads.

    Returns ``(permuted, bounds, perm)``: ``bounds`` has nparts+1
    ascending row boundaries and ``perm[new] = old`` maps permuted row
    ids back to the input ordering (apply to solutions as
    ``x_orig[perm] = x_perm``).
    """
    if mtx.symmetry != "general":
        raise AcgError(ErrorCode.NOT_SUPPORTED,
                       "apply_partition_rowsorted needs FULL storage "
                       "(expand first)")
    part = np.asarray(part)
    if part.size != mtx.nrows:
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"partition vector has {part.size} entries, "
                       f"matrix has {mtx.nrows} rows")
    nparts = int(part.max()) + 1 if part.size else 0
    if part.size and part.min() < 0:
        raise AcgError(ErrorCode.INVALID_VALUE, "negative part id")
    perm = np.argsort(part, kind="stable").astype(np.int64)
    rank = np.empty_like(perm)
    rank[perm] = np.arange(perm.size, dtype=np.int64)
    counts = np.bincount(part, minlength=nparts)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    r, c, v = mtx.to_coo()
    nr, nc = rank[np.asarray(r)], rank[np.asarray(c)]
    order = _rowcol_argsort(nr, nc, mtx.ncols)
    permuted = MtxFile(object=mtx.object, format=mtx.format,
                       field=mtx.field, symmetry="general",
                       nrows=mtx.nrows, ncols=mtx.ncols, nnz=int(nr.size),
                       rowidx=nr[order], colidx=nc[order],
                       vals=None if v is None else np.asarray(v)[order],
                       comments=list(mtx.comments))
    return permuted, bounds, perm


def read_mtx_sizes(path) -> tuple[int, int, int]:
    """(nrows, ncols, nnz) from a Matrix Market header without reading
    the data section (O(1) I/O; used to derive band bounds before a
    range read)."""
    with _open_maybe_gzip(path, "rb") as f:
        _, _, _, _, _, nrows, ncols, nnz = _read_header_meta(f)
        return nrows, ncols, nnz


def read_mtx_row_range(path, row_lo: int, row_hi: int) -> MtxFile:
    """Read ONLY the entries with ``row_lo <= row < row_hi`` from a
    row-sorted BINARY coordinate file (``mtx2bin --expand`` output).

    The pod-scale ingest primitive (the role of the reference's
    root-read + ``acgmtxfile_scatterv``, ``mtxfile.h:997-1087``, without
    the root): the row span is located by BISECTION over the on-disk
    rowidx array (O(log nnz) 8-byte seeks), then exactly the three
    slices are read -- I/O and memory are O(local nnz), not O(nnz).
    Returns an :class:`MtxFile` with global ``nrows/ncols`` and the
    local ``nnz``; monotonicity of the slice is verified.
    """
    if not (0 <= row_lo <= row_hi):
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"bad row range [{row_lo}, {row_hi})")
    with open(path, "rb") as f:
        obj, fmt, field, sym, comments, nrows, ncols, nnz = \
            _read_header_meta(f)
        if fmt != "coordinate":
            raise AcgError(ErrorCode.INVALID_FORMAT,
                           "row-range reads need a coordinate file")
        data_off = f.tell()

        idx_sz = np.dtype(IDX_DTYPE).itemsize

        # probe that the data section IS binary before bisecting over it
        # (read_mtx takes an explicit ``binary`` flag; this reader has no
        # flag, and frombuffer over an ASCII data section would otherwise
        # fail with a misleading "not row-sorted" error, or worse, pass):
        # the binary layout's size is fully determined by the header
        # (rowidx, colidx, vals as consecutive raw arrays), and entry 0's
        # 1-based rowidx must be a plausible row number.
        val_sz = 0 if field == "pattern" else \
            (8 if field == "real" else 4)
        f.seek(0, os.SEEK_END)
        if f.tell() != data_off + nnz * (2 * idx_sz + val_sz):
            raise AcgError(ErrorCode.INVALID_FORMAT,
                           f"{path}: data section size does not match the "
                           f"binary layout for {nnz} entries -- not a "
                           f"binary file? (convert with mtx2bin --expand)")
        if nnz:
            f.seek(data_off)
            first = int(np.frombuffer(f.read(idx_sz), dtype=IDX_DTYPE)[0])
            if not (1 <= first <= nrows):
                raise AcgError(ErrorCode.INVALID_FORMAT,
                               f"{path}: first rowidx {first} out of range "
                               f"-- not a binary coordinate file?")

        def row_at(k: int) -> int:
            f.seek(data_off + idx_sz * k)
            buf = f.read(idx_sz)
            if len(buf) != idx_sz:
                raise AcgError(ErrorCode.EOF, "binary rowidx truncated")
            return int(np.frombuffer(buf, dtype=IDX_DTYPE)[0]) - 1

        def lower_bound(row: int) -> int:
            """First k with rowidx[k] >= row (file is row-sorted)."""
            lo, hi = 0, nnz
            while lo < hi:
                mid = (lo + hi) // 2
                if row_at(mid) < row:
                    lo = mid + 1
                else:
                    hi = mid
            return lo

        k0 = lower_bound(row_lo)
        k1 = lower_bound(row_hi)
        cnt = k1 - k0

        def read_block(block: int, dtype, item: int) -> np.ndarray:
            f.seek(data_off + block + item * k0)
            buf = f.read(item * cnt)
            if len(buf) != item * cnt:
                raise AcgError(ErrorCode.EOF, "binary data truncated")
            return np.frombuffer(buf, dtype=dtype).copy()

        rowidx = read_block(0, IDX_DTYPE, idx_sz) - 1
        colidx = read_block(idx_sz * nnz, IDX_DTYPE, idx_sz) - 1
        vals = None
        if field != "pattern":
            vdt = np.float64 if field == "real" else np.int32
            vals = read_block(2 * idx_sz * nnz, vdt, np.dtype(vdt).itemsize)
        if cnt:
            if (np.diff(rowidx) < 0).any():
                raise AcgError(ErrorCode.INVALID_FORMAT,
                               "file is not row-sorted; regenerate with "
                               "mtx2bin --expand")
            if rowidx[0] < row_lo or rowidx[-1] >= row_hi:
                raise AcgError(ErrorCode.INVALID_FORMAT,
                               "row-range bisection failed (unsorted file?)")
            if colidx.min() < 0 or colidx.max() >= ncols:
                raise AcgError(ErrorCode.INDEX_OUT_OF_BOUNDS,
                               "mtx indices out of range")
    return MtxFile(object=obj, format=fmt, field=field,
                   symmetry=sym, nrows=nrows, ncols=ncols, nnz=cnt,
                   rowidx=rowidx, colidx=colidx, vals=vals,
                   comments=comments)


def write_mtx(path, mtx: MtxFile, binary: bool = False, numfmt: str = "%.17g") -> None:
    """Write a Matrix Market file (text or raw binary).

    Equivalent of ``mtxfile_fwrite_double`` (``mtxfile.h:997``); the binary
    data section matches the reference's layout (rowidx, colidx, vals as
    consecutive raw arrays, 1-based int64 indices, ``mtxfile.c:1492-1497``).
    """
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
    # The reference's mtx2bin keeps the header text unchanged but the data
    # binary; readers distinguish via the --binary flag, as do we.
    f.write(f"%%MatrixMarket {mtx.object} {mtx.format} {field} {mtx.symmetry}\n".encode())
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
            from acg_tpu_torch import _native
            vals64 = (None if mtx.vals is None
                      else np.ascontiguousarray(mtx.vals, np.float64))
            if _native.available() and mtx.nnz > 0:
                try:
                    f.write(_native.format_coord(mtx.rowidx, mtx.colidx,
                                                 vals64, numfmt))
                    return
                except _native.NativeParseError:
                    pass  # exotic numfmt width: python fallback below
            r = np.asarray(mtx.rowidx) + 1
            c = np.asarray(mtx.colidx) + 1
            if mtx.vals is not None:
                lines = np.char.add(np.char.add(r.astype(str), " "), c.astype(str))
                valstr = np.array([numfmt % v for v in np.asarray(mtx.vals)])
                lines = np.char.add(np.char.add(lines, " "), valstr)
                f.write(("\n".join(lines.tolist()) + "\n").encode())
            else:
                lines = np.char.add(np.char.add(r.astype(str), " "), c.astype(str))
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
            from acg_tpu_torch import _native
            if _native.available() and vals.size:
                try:
                    f.write(_native.format_array(vals, numfmt))
                    return
                except _native.NativeParseError:
                    pass
            f.write(("\n".join(numfmt % v for v in vals) + "\n").encode())


def vector_binary_header(n: int) -> bytes:
    """The exact header bytes of a binary array double vector file of
    length ``n`` -- deterministic from ``n`` alone, which is what makes
    rootless range WRITES possible: every controller computes the same
    data offset with no coordination."""
    return f"%%MatrixMarket matrix array double general\n{n} 1\n".encode()


def write_vector_window(path, n: int, row_lo: int,
                        values: np.ndarray) -> None:
    """Range-WRITE ``values`` (float64) into rows ``[row_lo, row_lo +
    len(values))`` of a binary array vector file of global length ``n``
    -- the output mirror of :func:`read_mtx_row_range` and the rootless
    restatement of the reference's rank-ordered distributed solution
    output (``mtxfile_fwrite_mpi_double``, ``mtxfile.h:1087``): each
    controller writes exactly its owned windows, I/O is O(local rows),
    and no full vector is ever gathered anywhere.

    Creates the file if needed (sparse until every window lands); call
    :func:`finalize_vector_file` from ONE process to write the header
    and pin the exact length.
    """
    values = np.ascontiguousarray(values, dtype=np.float64)
    if not (0 <= row_lo and row_lo + values.size <= n):
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"window [{row_lo}, {row_lo + values.size}) outside "
                       f"[0, {n})")
    fd = os.open(os.fspath(path), os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.lseek(fd, len(vector_binary_header(n)) + 8 * row_lo, os.SEEK_SET)
        os.write(fd, values.tobytes())
    finally:
        os.close(fd)


def finalize_vector_file(path, n: int) -> None:
    """Write the deterministic header of a range-written vector file and
    truncate it to its exact size (one process -- the primary -- calls
    this; the reference's root writes the header the same way)."""
    hdr = vector_binary_header(n)
    fd = os.open(os.fspath(path), os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, hdr)
        os.ftruncate(fd, len(hdr) + 8 * n)
    finally:
        os.close(fd)


def _open_vector_binary(f, path, expect_nrows):
    """Validate an open binary array-vector stream and return
    ``(nrows, data_off, vdt)`` -- the shared header step of the window
    and gather readers (parsed ONCE per open; the gather reader issues
    many seek+reads against the same handle)."""
    if f.read(2) == b"\x1f\x8b":
        raise AcgError(ErrorCode.NOT_SUPPORTED,
                       f"{path}: gzipped vector files are not "
                       f"seekable for window reads; decompress to a "
                       f"raw binary array file first")
    f.seek(0)
    _, fmt, field, _, _, nrows, ncols, _ = _read_header_meta(f)
    if expect_nrows is not None and nrows != expect_nrows:
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"{path}: vector has {nrows} rows, "
                       f"need {expect_nrows}")
    if fmt != "array" or ncols != 1:
        raise AcgError(ErrorCode.INVALID_FORMAT,
                       f"{path}: vector window reads need a dense "
                       f"array vector file ({fmt} {ncols} cols)")
    if field == "real":
        vdt = np.dtype(np.float64)
    elif field == "integer":
        # the binary layout of integer array vectors (int32, same as
        # read_mtx binary=True) -- window reads of the perm/bounds
        # sidecars ride this
        vdt = np.dtype(np.int32)
    else:
        raise AcgError(ErrorCode.NOT_SUPPORTED,
                       f"{path}: vector windows read 'real'/'double'"
                       f"/'integer' fields (got {field!r})")
    data_off = f.tell()
    f.seek(0, os.SEEK_END)
    if f.tell() != data_off + vdt.itemsize * nrows:
        raise AcgError(ErrorCode.INVALID_FORMAT,
                       f"{path}: data section size does not match "
                       f"the binary array layout for {nrows} rows "
                       f"-- not a binary file?")
    return nrows, data_off, vdt


def _read_window_at(f, path, nrows, data_off, vdt, row_lo, row_hi):
    if not (0 <= row_lo <= row_hi):
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"bad row range [{row_lo}, {row_hi})")
    if row_hi > nrows:
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"window [{row_lo}, {row_hi}) outside "
                       f"[0, {nrows})")
    f.seek(data_off + vdt.itemsize * row_lo)
    buf = f.read(vdt.itemsize * (row_hi - row_lo))
    if len(buf) != vdt.itemsize * (row_hi - row_lo):
        raise AcgError(ErrorCode.EOF, "binary vector truncated")
    return np.frombuffer(buf, dtype=vdt).copy()


def read_vector_window(path, row_lo: int, row_hi: int,
                       expect_nrows: int | None = None) -> np.ndarray:
    """Read rows ``[row_lo, row_hi)`` of a BINARY array (dense vector)
    file -- the input mirror of :func:`write_vector_window`: one seek +
    one read of exactly the window, so per-controller right-hand-side
    ingest is O(local rows) (the b/x0 half of the reference's
    distributed file I/O, ``mtxfile.h:997-1087``).

    ``expect_nrows`` pins the file's global length: window reads only
    touch their slice, so without this check a wrong-sized vector
    (wrong problem) would be silently accepted wherever the windows
    happen to fit."""
    with open(path, "rb") as f:
        nrows, data_off, vdt = _open_vector_binary(f, path, expect_nrows)
        return _read_window_at(f, path, nrows, data_off, vdt,
                               row_lo, row_hi)


# gaps up to this many rows between requested indices are read over in
# one request rather than split into separate seeks (8 B rows: 64 rows
# = 512 B -- far below the cost of an extra syscall + disk round trip)
_GATHER_GAP_ROWS = 64


def read_vector_rows(path, rows: np.ndarray,
                     expect_nrows: int | None = None) -> np.ndarray:
    """Gather arbitrary ``rows`` (0-based, any order, duplicates OK) of
    a binary array vector file, as float64 in the requested order.

    The scattered-row mirror of :func:`read_vector_window` for
    partition-PERMUTED matrices under ``--distributed-read``: a
    controller's owned window of permuted rows maps through the perm
    sidecar to non-contiguous rows of the original-ordering b/x0 file
    (the reference reads these through its rowwise partitioned
    ``mtxfile`` gather, ``mtxfile.h:997-1087``).  I/O is coalesced:
    sorted unique indices are grouped into runs whose internal gaps are
    below ``_GATHER_GAP_ROWS``, one seek+read per run -- O(local rows)
    for the band-dominated permutations METIS produces, never worse
    than one syscall per ``_GATHER_GAP_ROWS``-spaced index."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if rows.size == 0:
        return np.zeros(0, dtype=np.float64)
    uniq, inverse = np.unique(rows, return_inverse=True)
    if uniq[0] < 0 or (expect_nrows is not None
                       and uniq[-1] >= expect_nrows):
        raise AcgError(ErrorCode.INVALID_VALUE,
                       f"gather rows outside [0, {expect_nrows})")
    # run boundaries: where the gap to the previous index exceeds the
    # coalescing threshold
    cuts = np.flatnonzero(np.diff(uniq) > _GATHER_GAP_ROWS) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [uniq.size]])
    vals = np.empty(uniq.size, dtype=np.float64)
    # ONE open + header parse for the whole gather: a scattered perm can
    # produce O(local rows / gap) runs, and per-run re-validation
    # (open + parse + seek-to-end) would multiply the syscall count
    with open(path, "rb") as f:
        nrows, data_off, vdt = _open_vector_binary(f, path, expect_nrows)
        # validate against the PARSED row count too (expect_nrows is
        # optional): an out-of-range gather row is named directly here
        # instead of surfacing as a window-range error mid-read
        if uniq[-1] >= nrows:
            raise AcgError(ErrorCode.INVALID_VALUE,
                           f"{path}: gather row {int(uniq[-1])} outside "
                           f"the file's [0, {nrows}) rows")
        for s, e in zip(starts, ends):
            lo, hi = int(uniq[s]), int(uniq[e - 1]) + 1
            chunk = _read_window_at(f, path, nrows, data_off, vdt, lo, hi)
            vals[s:e] = chunk[uniq[s:e] - lo]
    return vals[inverse]


def vector_mtx(x: np.ndarray, field: str = "real") -> MtxFile:
    """Wrap a dense vector as a Matrix Market array file object."""
    x = np.asarray(x)
    return MtxFile(object="matrix", format="array", field=field,
                   symmetry="general", nrows=x.size, ncols=1,
                   nnz=x.size, vals=x)


def multi_vector_mtx(X: np.ndarray, field: str = "real") -> MtxFile:
    """Wrap an (n, B) COLUMN BLOCK as a dense Matrix Market array file
    (the batched tier's multi-RHS b / solution container).  Values are
    stored column-major, the Matrix Market array convention."""
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    return MtxFile(object="matrix", format="array", field=field,
                   symmetry="general", nrows=X.shape[0],
                   ncols=X.shape[1], nnz=X.size,
                   vals=np.asarray(X, order="F").reshape(-1, order="F"))


def vector_columns(mtx: MtxFile, n: int, nrhs: int) -> np.ndarray:
    """Extract an (n, nrhs) column block from a dense array MtxFile --
    the multi-column b/x0 ingest of ``--nrhs``.  Accepts a file whose
    header declares exactly ``n x nrhs`` (column-major data, the MTX
    array convention); anything else refuses self-describingly rather
    than silently reshaping someone else's vector."""
    if mtx.format != "array":
        raise AcgError(
            ErrorCode.INVALID_FORMAT,
            f"--nrhs {nrhs} needs a DENSE array file of {n} x {nrhs} "
            f"values (one column per right-hand side); this file is "
            f"{mtx.format} format")
    vals = np.asarray(mtx.vals, dtype=np.float64).reshape(-1)
    if mtx.ncols != nrhs or mtx.nrows != n or vals.size != n * nrhs:
        raise AcgError(
            ErrorCode.INVALID_VALUE,
            f"--nrhs {nrhs} needs a {n} x {nrhs} array file; this "
            f"file declares {mtx.nrows} x {mtx.ncols} "
            f"({vals.size} values)")
    return vals.reshape((n, nrhs), order="F")
