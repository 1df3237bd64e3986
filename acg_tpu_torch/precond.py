"""Preconditioning: PCG and pipelined PCG on the port's solver tiers.

The counterpart of ``acg_tpu/precond.py``, with the same names.  Three
preconditioners, whose state is built once per solver and whose apply
runs inside the solve loop:

* **Jacobi** (``jacobi``): inverse-diagonal scaling.  The diagonal comes
  from the device matrix (:func:`acg_tpu_torch.ops.spmv.matrix_diagonal`,
  the operator hook for matrix-free stencils) or, on the stacked
  multi-part tier, from each part's local host block.
* **block-Jacobi** (``bjacobi[:BS]``): Cholesky factors of the BS x BS
  diagonal blocks (``torch.linalg.cholesky_ex``, batched), applied as
  two batched triangular solves; blocks never cross a part boundary.
  Empty diagonal rows (padding) become identity rows.
* **Chebyshev** (``cheby:K``): z = p_K(A) r, the degree-K Chebyshev
  approximation of 1/lambda on ``[lmax / CHEBY_RATIO, CHEBY_SAFETY *
  lmax]``: K SpMVs per apply through the tier's own SpMV (kernel K1/K7,
  and the halo exchange on stacked parts).  lambda_max comes from a
  power iteration at setup.

The single-device power iteration draws its start vector from an
explicit ``torch.Generator`` seeded with ``seed``: the JAX package's
threefry stream cannot be reproduced, so the two estimates agree only
to the power iteration's accuracy.  :func:`state_from_numpy` carries a
state (the JAX package's, say) across as tensors, for trajectory parity.
The stacked tier's start vector is numpy's ``default_rng(0)``, as in the
JAX package, so its estimate is the same.

:func:`make_apply_batched` broadcasts each apply over the ``(n, B)``
column block of the batched multi-RHS tier, and :class:`HostPrecond` is
the f64 numpy twin the host oracle solver runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_tpu_torch.errors import AcgError, ErrorCode

# Chebyshev interval policy: the spectrum is assumed inside
# [lmax / CHEBY_RATIO, CHEBY_SAFETY * lmax] (the power iteration
# underestimates lmax; the safety factor keeps p_K positive on the
# spectrum, so M stays SPD)
CHEBY_RATIO = 30.0
CHEBY_SAFETY = 1.05
POWER_ITERS = 24
DEFAULT_BLOCK = 32


@dataclasses.dataclass(frozen=True)
class PrecondSpec:
    """One parsed preconditioner selection (immutable, hashable)."""

    kind: str                 # "jacobi" | "bjacobi" | "cheby"
    degree: int = 0           # cheby: SpMVs per apply
    block: int = DEFAULT_BLOCK  # bjacobi: dense block size

    def __str__(self) -> str:
        if self.kind == "cheby":
            return f"cheby:{self.degree}"
        if self.kind == "bjacobi":
            return f"bjacobi:{self.block}"
        return self.kind


def parse_precond(text) -> PrecondSpec | None:
    """``none | jacobi | bjacobi[:BS] | cheby:K`` -> spec (None = off).
    Raises ``ValueError`` naming the offending token."""
    if text is None or isinstance(text, PrecondSpec):
        return text
    t = str(text).strip()
    if t in ("", "none"):
        return None
    fields = t.split(":")
    kind = fields[0]
    if kind == "jacobi":
        if len(fields) != 1:
            raise ValueError(f"precond spec {text!r}: jacobi takes no "
                             f"parameter")
        return PrecondSpec(kind="jacobi")
    if kind == "bjacobi":
        if len(fields) > 2:
            raise ValueError(f"precond spec {text!r}: expected "
                             f"bjacobi[:BLOCKSIZE]")
        bs = DEFAULT_BLOCK
        if len(fields) == 2:
            try:
                bs = int(fields[1])
            except ValueError:
                raise ValueError(f"precond spec {text!r}: bad block size "
                                 f"{fields[1]!r}")
            if bs < 1 or bs > 1024:
                raise ValueError(f"precond spec {text!r}: block size must "
                                 f"be in [1, 1024]")
        return PrecondSpec(kind="bjacobi", block=bs)
    if kind == "cheby":
        if len(fields) != 2:
            raise ValueError(f"precond spec {text!r}: cheby needs a "
                             f"degree (e.g. cheby:4)")
        try:
            k = int(fields[1])
        except ValueError:
            raise ValueError(f"precond spec {text!r}: bad degree "
                             f"{fields[1]!r}")
        if k < 1 or k > 64:
            raise ValueError(f"precond spec {text!r}: cheby degree must "
                             f"be in [1, 64]")
        return PrecondSpec(kind="cheby", degree=k)
    raise ValueError(f"precond spec {text!r}: unknown kind {kind!r} "
                     f"(none, jacobi, bjacobi[:BS], cheby:K)")


# -- device state builders (single-device tier) ---------------------------

def _inverse(d: torch.Tensor) -> torch.Tensor:
    """1/d with zero entries (padding rows) inverted to 0."""
    nz = d != 0
    return torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def jacobi_state(A, sdt) -> tuple:
    """``(dinv,)``: the inverse diagonal in the scalar dtype ``sdt``, on
    the matrix's device."""
    from acg_tpu_torch.ops.spmv import matrix_diagonal

    return (_inverse(matrix_diagonal(A).to(sdt)),)


def _dia_diag_blocks(planes, offsets, n: int, bs: int, sdt):
    """(nb, bs, bs) dense diagonal blocks of square DIA planes: one
    indexed add per in-band offset (|off| < bs; wider offsets cannot land
    inside a bs x bs diagonal block)."""
    nb = -(-n // bs)
    blocks = torch.zeros((nb, bs, bs), dtype=sdt, device=planes.device)
    rows = torch.arange(n, device=planes.device)
    for plane, off in zip(planes, offsets):
        off = int(off)
        if abs(off) >= bs:
            continue
        i = rows % bs
        j = i + off
        ok = (j >= 0) & (j < bs) & (rows + off >= 0) & (rows + off < n)
        r = rows[ok]
        blocks[r // bs, r % bs, j[ok]] += plane[:n][ok].to(sdt)
    return blocks


def _gather_diag_blocks(rows, cols, vals, n: int, bs: int, sdt, blocks):
    """Add flat (row, col, val) triples into ``blocks`` ((nb, bs, bs))
    wherever they land inside a diagonal block."""
    rows = rows.long()
    cols = cols.long()
    bi = rows // bs
    j = cols - bi * bs
    ok = (j >= 0) & (j < bs) & (rows < n)
    blocks.index_put_((bi[ok], (rows % bs)[ok], j[ok]), vals[ok].to(sdt),
                      accumulate=True)
    return blocks


def diag_blocks(A, bs: int, sdt):
    """(nb, bs, bs) dense diagonal blocks of any device matrix format,
    identity on empty-diagonal rows so the Cholesky stays defined."""
    from acg_tpu_torch.ops.spmv import (BinnedEllMatrix, CooMatrix,
                                        DiaMatrix, EllMatrix)

    n = A.nrows
    dev = A.device
    if isinstance(A, DiaMatrix):
        blocks = _dia_diag_blocks(A.data, A.offsets, n, bs, sdt)
    else:
        blocks = torch.zeros((-(-n // bs), bs, bs), dtype=sdt, device=dev)
        if isinstance(A, EllMatrix):
            rows = torch.arange(n, device=dev).repeat_interleave(
                A.data.shape[1])
            _gather_diag_blocks(rows, A.cols.reshape(-1),
                                A.data.reshape(-1), n, bs, sdt, blocks)
        elif isinstance(A, CooMatrix):
            _gather_diag_blocks(A.rows, A.cols, A.vals, n, bs, sdt, blocks)
        elif isinstance(A, BinnedEllMatrix):
            for brows, bdata, bcols in zip(A.bin_rows, A.bin_data,
                                           A.bin_cols):
                _gather_diag_blocks(
                    brows.repeat_interleave(bdata.shape[1]),
                    bcols.reshape(-1), bdata.reshape(-1), n, bs, sdt,
                    blocks)
            _gather_diag_blocks(A.tail_rows, A.tail_cols, A.tail_vals, n,
                                bs, sdt, blocks)
        else:
            raise TypeError(f"unsupported device matrix {type(A)}")
    dblk = torch.diagonal(blocks, dim1=1, dim2=2)
    dblk += (dblk == 0).to(sdt)
    return blocks


def bjacobi_state(A, bs: int, sdt) -> tuple:
    """``(chol,)``: batched lower Cholesky factors of the bs x bs
    diagonal blocks.  A block that is not positive definite gets a NaN
    factor, which the first apply carries into (r, z): the solve fails
    visibly instead of answering wrongly."""
    chol, info = torch.linalg.cholesky_ex(diag_blocks(A, bs, sdt))
    chol[info != 0] = float("nan")
    return (chol,)


def estimate_lmax(spmv_fn, A, n: int, sdt, iters: int = POWER_ITERS,
                  seed: int = 0):
    """Power-iteration largest-eigenvalue estimate through the solve's
    own SpMV, from a start vector drawn from ``torch.Generator(device).
    manual_seed(seed)``.  Returns a one-element device tensor."""
    dev = A.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    v = torch.randn(n, generator=gen, dtype=sdt, device=dev)
    for _ in range(iters):
        w = spmv_fn(A, v.to(sdt)).to(sdt)
        v = w / torch.linalg.norm(w)
    w = spmv_fn(A, v).to(sdt)
    return torch.dot(v, w) / torch.dot(v, v)


def cheby_state(lmax, sdt, device=None) -> tuple:
    """``(lmin, lmax)`` one-element tensors bounding the Chebyshev
    interval (the RATIO/SAFETY policy above)."""
    lmax = torch.as_tensor(lmax, dtype=sdt, device=device) * CHEBY_SAFETY
    return (lmax / CHEBY_RATIO, lmax)


def setup_single(spec: PrecondSpec, A, spmv_fn, sdt) -> tuple:
    """The state tuple of the single-device tier, on the matrix's
    device."""
    if spec.kind == "jacobi":
        return jacobi_state(A, sdt)
    if spec.kind == "bjacobi":
        from acg_tpu_torch.ops.operator import is_matrix_free
        if is_matrix_free(A):
            raise AcgError(
                ErrorCode.NOT_SUPPORTED,
                "bjacobi factors stored diagonal blocks, which a "
                "matrix-free operator does not have; use --precond "
                "jacobi (analytic diagonal) or cheby:K (applies only)")
        return bjacobi_state(A, spec.block, sdt)
    return cheby_state(estimate_lmax(spmv_fn, A, A.nrows, sdt), sdt,
                       A.device)


def state_from_numpy(spec: PrecondSpec, arrays, device) -> tuple:
    """A state given as numpy arrays (``(dinv,)``, ``(chol,)`` or
    ``(lmin, lmax)``, e.g. the JAX package's ``mstate``) as the port's
    tensors on ``device``, in the arrays' own dtypes."""
    spec = parse_precond(spec)
    want = 2 if spec.kind == "cheby" else 1
    arrays = tuple(arrays)
    if len(arrays) != want:
        raise ValueError(f"{spec} state has {want} array(s), got "
                         f"{len(arrays)}")
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in arrays)


# -- the in-loop apply ----------------------------------------------------

def make_apply(spec: PrecondSpec, spmv_fn):
    """``apply(mstate, A, r) -> z`` in plain torch.  ``spmv_fn(A, x)`` is
    the tier's own SpMV (kernel and halo exchange included), so a
    Chebyshev apply is exactly K extra SpMVs.  Works on one vector (n,)
    and on stacked parts (P, n) with per-part state."""
    from acg_tpu_torch.ops.spmv import acc_dtype

    if spec.kind == "jacobi":
        def apply(mstate, A, r):
            (dinv,) = mstate
            return (r.to(dinv.dtype) * dinv).to(r.dtype)
        return apply

    if spec.kind == "bjacobi":
        bs = spec.block

        def apply(mstate, A, r):
            (chol,) = mstate
            n = r.shape[-1]
            nb = chol.shape[-3]
            rp = r.to(chol.dtype)
            if nb * bs != n:
                rp = torch.nn.functional.pad(rp, (0, nb * bs - n))
            R = rp.reshape(chol.shape[:-1] + (1,))
            y = torch.linalg.solve_triangular(chol, R, upper=False)
            z = torch.linalg.solve_triangular(chol.mT, y, upper=True)
            # contiguous: the SpMV kernels take contiguous vectors, and
            # dropping the padding of stacked parts leaves a strided view
            z = z.reshape(r.shape[:-1] + (nb * bs,))[..., :n]
            return z.to(r.dtype).contiguous()
        return apply

    k = spec.degree

    def apply(mstate, A, r):
        # one-element scalars, or their per-part tiling (stacked tier)
        lmin, lmax = (s.reshape(-1)[0] for s in mstate)
        adt = acc_dtype(r.dtype)
        lmin = lmin.to(adt)
        lmax = lmax.to(adt)
        theta = (lmax + lmin) * 0.5
        delta = (lmax - lmin) * 0.5
        sigma = theta / delta
        rho = 1.0 / sigma
        rs = r.to(adt)
        d = rs / theta
        z = d
        rcur = rs
        # K steps of the Chebyshev semi-iteration on A z = r from z = 0
        for _ in range(k):
            rcur = rcur - spmv_fn(A, d.to(r.dtype)).to(adt)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * rcur
            z = z + d
            rho = rho_new
        return z.to(r.dtype)
    return apply


def make_apply_batched(spec: PrecondSpec, spmv_multi_fn=None):
    """``apply(mstate, A, R) -> Z`` over a multi-column residual block
    ``R`` of shape ``(n, B)`` (``acg_tpu.precond.make_apply_batched``):
    the preconditioner apply broadcast over the batch axis, in plain
    torch.  Jacobi broadcasts the inverse diagonal across the columns;
    block-Jacobi runs the same batched triangular solves with B
    right-hand sides per block; Chebyshev runs its K-step semi-iteration
    on the whole block through ``spmv_multi_fn`` (default: the
    single-device multi-vector SpMV), K matrix passes for all B
    columns."""
    from acg_tpu_torch.ops.spmv import acc_dtype

    if spec.kind == "jacobi":
        def apply(mstate, A, R):
            (dinv,) = mstate
            return (R.to(dinv.dtype) * dinv[:, None]).to(R.dtype)
        return apply

    if spec.kind == "bjacobi":
        bs = spec.block

        def apply(mstate, A, R):
            (chol,) = mstate
            n, ncols = R.shape
            nb = chol.shape[0]
            Rp = R.to(chol.dtype)
            if nb * bs != n:
                Rp = torch.nn.functional.pad(Rp, (0, 0, 0, nb * bs - n))
            Rb = Rp.reshape(nb, bs, ncols)
            y = torch.linalg.solve_triangular(chol, Rb, upper=False)
            z = torch.linalg.solve_triangular(chol.mT, y, upper=True)
            return z.reshape(nb * bs, ncols)[:n].to(R.dtype).contiguous()
        return apply

    k = spec.degree
    if spmv_multi_fn is None:
        from acg_tpu_torch.solvers.batched import spmv_multi as spmv_multi_fn

    def apply(mstate, A, R):
        lmin, lmax = (s.reshape(-1)[0] for s in mstate)
        adt = acc_dtype(R.dtype)
        lmin = lmin.to(adt)
        lmax = lmax.to(adt)
        theta = (lmax + lmin) * 0.5
        delta = (lmax - lmin) * 0.5
        sigma = theta / delta
        rho = 1.0 / sigma
        Rs = R.to(adt)
        d = Rs / theta
        z = d
        rcur = Rs
        for _ in range(k):
            rcur = rcur - spmv_multi_fn(A, d.to(R.dtype)).to(adt)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * rcur
            z = z + d
            rho = rho_new
        return z.to(R.dtype)
    return apply


# -- stacked host-side state builders (the multi-part tier) ---------------

def _np_diag_blocks_from_triples(rows, cols, vals, n: int, bs: int,
                                 out: np.ndarray) -> None:
    """Accumulate (row, col, val) triples into ``out`` ((nb, bs, bs)
    f64) wherever they land inside a bs x bs diagonal block."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    bi = rows // bs
    j = cols - bi * bs
    ok = (rows < n) & (j >= 0) & (j < bs) & (vals != 0)
    np.add.at(out, (bi[ok], (rows % bs)[ok], j[ok]), vals[ok])


def _np_local_block_triples(local, p: int):
    """Flat (rows, cols, vals) of part ``p``'s local block in any
    assembled :class:`~acg_tpu_torch.parallel.dist.StackedLocalBlock`
    format (host numpy)."""
    if local.format == "dia":
        n = local.nrows
        rows = np.arange(n, dtype=np.int64)
        rs, cs, vs = [], [], []
        for plane, off in zip(local.arrays[0], local.offsets):
            cols = rows + int(off)
            ok = (cols >= 0) & (cols < n)
            rs.append(rows[ok])
            cs.append(cols[ok])
            vs.append(np.asarray(plane[p], np.float64)[ok])
        return (np.concatenate(rs), np.concatenate(cs),
                np.concatenate(vs))
    if local.format == "ell":
        data, cols = local.arrays
        n, K = data.shape[1], data.shape[2]
        rows = np.repeat(np.arange(n, dtype=np.int64), K)
        return rows, np.asarray(cols[p], np.int64).reshape(-1), \
            np.asarray(data[p], np.float64).reshape(-1)
    # binnedell
    bin_rows, bin_data, bin_cols, t_rows, t_cols, t_vals = local.arrays
    rs, cs, vs = [], [], []
    for br, bd, bc in zip(bin_rows, bin_data, bin_cols):
        K = bd.shape[2]
        rs.append(np.repeat(np.asarray(br[p], np.int64), K))
        cs.append(np.asarray(bc[p], np.int64).reshape(-1))
        vs.append(np.asarray(bd[p], np.float64).reshape(-1))
    rs.append(np.asarray(t_rows[p], np.int64))
    cs.append(np.asarray(t_cols[p], np.int64))
    vs.append(np.asarray(t_vals[p], np.float64))
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)


def _np_dtype(sdt) -> np.dtype:
    return torch.empty((), dtype=sdt).numpy().dtype


def stacked_jacobi_state(prob, sdt) -> tuple:
    """``(dinv,)`` with dinv (nparts, nmax_owned) host numpy in ``sdt``:
    the inverse diagonal of each part's local block (diagonal entries
    are owned x owned), zero on padding rows.  A matrix-free local block
    takes the operator's analytic diagonal, sliced per part."""
    local = prob.local
    n = local.nrows
    dinv = np.zeros((prob.nparts, n), dtype=_np_dtype(sdt))
    if local.format == "matfree":
        dglob = prob.operator.host_diagonal()
        for p, s in enumerate(prob.subs):
            d = dglob[np.asarray(s.global_ids[: s.nowned], np.int64)]
            nz = d != 0
            dinv[p, : s.nowned][nz] = 1.0 / d[nz]
        return (dinv,)
    for p in range(prob.nparts):
        rows, cols, vals = _np_local_block_triples(local, p)
        d = np.zeros(n, np.float64)
        on_diag = rows == cols
        np.add.at(d, rows[on_diag], vals[on_diag])
        nz = d != 0
        dinv[p, nz] = 1.0 / d[nz]
    return (dinv,)


def stacked_bjacobi_state(prob, bs: int, sdt) -> tuple:
    """``(chol,)`` with chol (nparts, nb, bs, bs) host numpy in ``sdt``:
    Cholesky factors of each part's local diagonal blocks (padding rows
    become identity).  A block that is not positive definite is refused
    at setup."""
    local = prob.local
    if local.format == "matfree":
        raise AcgError(
            ErrorCode.NOT_SUPPORTED,
            "bjacobi factors stored local diagonal blocks, which the "
            "matrix-free tier does not have; use --precond jacobi "
            "(analytic diagonal) or cheby:K (applies only)")
    n = local.nrows
    nb = -(-n // bs)
    chol = np.zeros((prob.nparts, nb, bs, bs), dtype=_np_dtype(sdt))
    for p in range(prob.nparts):
        blocks = np.zeros((nb, bs, bs), np.float64)
        rows, cols, vals = _np_local_block_triples(local, p)
        _np_diag_blocks_from_triples(rows, cols, vals, n, bs, blocks)
        dblk = np.einsum("bii->bi", blocks)
        empty = dblk == 0
        np.einsum("bii->bi", blocks)[...] = np.where(empty, 1.0, dblk)
        try:
            chol[p] = np.linalg.cholesky(blocks)
        except np.linalg.LinAlgError:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"bjacobi:{bs}: a diagonal block of part {p} is not "
                f"positive definite -- the matrix (or this block size) "
                f"does not admit a block-Jacobi Cholesky")
    return (chol,)


# -- accounting (the stats block) -----------------------------------------

def flops_per_apply(spec: PrecondSpec, n: int, spmv_flops: float) -> float:
    """Analytic flops of one M^-1 apply (2n per vector op, 3 per stored
    nonzero per SpMV)."""
    if spec.kind == "jacobi":
        return float(n)
    if spec.kind == "bjacobi":
        # two triangular solves over nb blocks of bs^2/2 entries each
        return 2.0 * n * spec.block
    return spec.degree * (float(spmv_flops) + 8.0 * n)


def bytes_per_apply(spec: PrecondSpec, n: int, vec_bytes: int,
                    mat_bytes_per_spmv: float, state_bytes: float) -> float:
    """Analytic memory traffic of one apply: the state read and the
    vector passes (and the K SpMV passes of cheby)."""
    if spec.kind in ("jacobi", "bjacobi"):
        return state_bytes + 2.0 * n * vec_bytes
    return spec.degree * (mat_bytes_per_spmv + 6.0 * n * vec_bytes)


def state_bytes(mstate) -> int:
    """Total bytes of a state tuple (tensors or numpy arrays)."""
    total = 0
    for leaf in mstate:
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


# -- recovery hooks (the robustness tier) ---------------------------------

def state_finite(mstate) -> bool:
    """True when every tensor of the state is finite -- the recovery
    driver's preserve-vs-rebuild predicate (``acg_tpu/precond.py:614``)."""
    for leaf in mstate or ():
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            return False
    return True


def partition_sensitive(spec) -> bool:
    """True when the preconditioner operator depends on the row
    partition: bjacobi factors the local diagonal blocks on the stacked
    tier, so M changes with the partition, and a repartitioned resume
    continues under another M (flexible-CG).  Jacobi and Chebyshev are
    partition-invariant."""
    return spec is not None and getattr(spec, "kind", None) == "bjacobi"


def refresh_state(solver, driver) -> bool:
    """Restart hook: keep the preconditioner state across a restart when
    it is still finite, rebuild it from the matrix when it is not.
    Returns True when a rebuild happened; each decision lands in the
    recovery log (``acg_tpu/precond.py:638-660``)."""
    spec = getattr(solver, "precond_spec", None)
    if spec is None or getattr(solver, "_mstate", None) is None:
        return False
    if state_finite(solver._mstate):
        driver.record(f"preconditioner ({spec}) state preserved across "
                      f"restart")
        return False
    solver._mstate = None
    solver._ensure_precond_state()
    driver.record(f"preconditioner ({spec}) state non-finite; rebuilt "
                  f"from the matrix", kind="recovery")
    return True


# -- host (numpy/scipy) twins: the eager solver + the test oracle ---------

class HostPrecond:
    """Eager numpy preconditioner for the host reference solver (and
    the scipy-checked oracle the device applies are tested against).
    Same three kinds, same interval policy, f64 arithmetic."""

    def __init__(self, spec: PrecondSpec, csr):
        import scipy.sparse as sp

        self.spec = spec
        csr = sp.csr_matrix(csr)
        n = csr.shape[0]
        if spec.kind == "jacobi":
            d = csr.diagonal().astype(np.float64)
            dinv = np.zeros_like(d)
            dinv[d != 0] = 1.0 / d[d != 0]
            self.state = (dinv,)
        elif spec.kind == "bjacobi":
            bs = spec.block
            nb = -(-n // bs)
            blocks = np.zeros((nb, bs, bs), np.float64)
            coo = csr.tocoo()
            _np_diag_blocks_from_triples(coo.row, coo.col, coo.data, n,
                                         bs, blocks)
            dblk = np.einsum("bii->bi", blocks)
            np.einsum("bii->bi", blocks)[...] = np.where(dblk == 0, 1.0,
                                                         dblk)
            self.state = (np.linalg.cholesky(blocks),)
        else:
            rng = np.random.default_rng(0)
            v = rng.standard_normal(n)
            for _ in range(POWER_ITERS):
                w = csr @ v
                v = w / np.linalg.norm(w)
            lmax = float(v @ (csr @ v) / (v @ v)) * CHEBY_SAFETY
            self._csr = csr
            self.state = (lmax / CHEBY_RATIO, lmax)
        self.n = n

    def apply(self, r: np.ndarray) -> np.ndarray:
        spec = self.spec
        if spec.kind == "jacobi":
            return self.state[0] * r
        if spec.kind == "bjacobi":
            import scipy.linalg as sla

            (chol,) = self.state
            bs = spec.block
            npad = chol.shape[0] * bs
            rp = np.zeros(npad)
            rp[: self.n] = r
            out = np.empty_like(rp)
            for b in range(chol.shape[0]):
                out[b * bs:(b + 1) * bs] = sla.cho_solve(
                    (chol[b], True), rp[b * bs:(b + 1) * bs])
            return out[: self.n]
        lmin, lmax = self.state
        theta = (lmax + lmin) * 0.5
        delta = (lmax - lmin) * 0.5
        sigma = theta / delta
        rho = 1.0 / sigma
        d = r / theta
        z = d.copy()
        rcur = r.astype(np.float64).copy()
        for _ in range(spec.degree):
            rcur = rcur - self._csr @ d
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * rcur
            z = z + d
            rho = rho_new
        return z
