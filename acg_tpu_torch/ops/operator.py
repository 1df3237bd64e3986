"""Matrix-free operator tier: ``A`` as an apply, not a stored matrix.

The counterpart of ``acg_tpu/ops/operator.py``, with the same names:

* :class:`StencilOperator` -- a built-in stencil standing in for a
  :class:`~acg_tpu_torch.ops.spmv.DeviceMatrix`.  Its apply expresses
  the stencil as shifted views of the reshaped grid (pad + slice + the
  O(grid-side) coefficient tables) instead of reading O(ndiags * N)
  planes.  The per-element products equal the assembled planes'
  (constants are exact; variable coefficients are rounded once, on the
  host, from f64) and accumulate in the assembled ``dia_mv``'s ascending
  offset order, so solves match the assembled DIA tier bit for bit.  On
  the card the constant-coefficient Poisson apply is kernel K7
  (:func:`acg_tpu_torch.ops.kernels.stencil_spmv`).
* :class:`UserOperator` + :func:`register_operator` -- the registration
  hook for user-supplied operators: a torch callable ``apply_fn(captures,
  x)`` registered under a name.

Integration is by dispatch: :mod:`acg_tpu_torch.ops.spmv` recognises the
``matfree_*`` protocol, so the classic and pipelined loops run an
operator with no loop changes; :func:`acg_tpu_torch.parallel.dist.
arm_matfree` restates it per part for the stacked multi-part tier.

Built-in stencils: constant-coefficient Poisson 1D/2D/3D (the ``gen:``
family) and the variable-coefficient anisotropic 2D family
(:func:`acg_tpu_torch.io.generators.aniso_poisson2d_coo`, whose
coefficients depend only on the grid row, so three O(n) tables replace
O(n^2) planes).  Operators run in f32 and f64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from acg_tpu_torch._device import resolve_device
from acg_tpu_torch.errors import AcgError, ErrorCode
from acg_tpu_torch.ops.spmv import acc_dtype


def is_matrix_free(A) -> bool:
    """True for any operator speaking the ``matfree_*`` protocol."""
    return hasattr(A, "matfree_apply")


# -- plane generation ------------------------------------------------------

def stencil_planes(kind: str, grid: tuple, offsets: tuple, tables,
                   nrows: int, dtype, row0=0, nowned=None, device=None):
    """The generated DIA planes of a built-in stencil for global rows
    ``[row0, row0 + nrows)``, one per offset, as a (len(offsets), nrows)
    tensor -- or (len(offsets), P, nrows) when ``row0``/``nowned`` are
    per-part (P,) tensors and each of ``tables`` is stacked (P, L).

    Values are bitwise-equal to the assembled ingest's planes.
    ``nowned`` (the multi-part local-block mask) zeroes entries whose row
    or column falls outside ``[0, nowned)`` locally: the owned x owned
    split of ``dia_planes_fixed`` (out-of-part couplings live in the
    ghost block, padding rows are zero)."""
    n = grid[0]
    stacked = isinstance(row0, torch.Tensor)
    if stacked:
        device = row0.device
    glob = nowned is None and not stacked and row0 == 0
    i_loc = torch.arange(nrows, dtype=torch.int64, device=device)
    idx = (row0.reshape(-1, 1) + i_loc) if stacked else row0 + i_loc

    def axis_coord(stride: int):
        """The grid coordinate ``(idx // stride) % n`` per row: a
        broadcast of one arange over the (-1, n, stride) view on the
        whole grid, the index arithmetic on part windows."""
        if glob and nrows % (stride * n) == 0:
            c = torch.arange(n, dtype=torch.int64, device=device)
            return c[None, :, None].expand(nrows // (stride * n), n,
                                           stride).reshape(nrows)
        return (idx // stride) % n

    zero = torch.zeros((), dtype=dtype, device=device)

    def local_mask(plane, off):
        if nowned is None:
            return plane
        nown = (nowned.reshape(-1, 1) if isinstance(nowned, torch.Tensor)
                else nowned)
        ok = (i_loc < nown) & (i_loc + off >= 0) & (i_loc + off < nown)
        return torch.where(ok, plane, zero)

    shape = idx.shape
    planes = []
    if kind == "poisson":
        dim = grid[1]
        for off in offsets:
            if off == 0:
                plane = torch.full(shape, float(2 * dim), dtype=dtype,
                                   device=device)
            else:
                coord = axis_coord(abs(int(off)))
                keep = coord > 0 if off < 0 else coord < n - 1
                plane = torch.where(keep, -1.0, 0.0).to(dtype)
            planes.append(local_mask(plane, off))
        return torch.stack(planes)
    if kind == "aniso2d":
        wx, wy, dtab = tables

        def row_table(t):
            """``t[j]`` per row, j the grid row: a broadcast over the (n,
            n) view on the whole grid, a gather on part windows (padding
            rows past the grid read the last entry, as JAX's clamped
            gather does; the owned mask zeroes them)."""
            if glob and nrows == n * n:
                return t[:n, None].expand(n, n).reshape(nrows)
            j = (idx // n).clamp(max=t.shape[-1] - 1)
            if t.dim() == 2:   # per-part tables (P, L)
                return torch.gather(t, 1, j)
            return t[j]

        i = axis_coord(1)
        j = axis_coord(n)
        for off in offsets:
            if off == 0:
                plane = row_table(dtab)
            elif off == -1:
                plane = torch.where(i > 0, -row_table(wx), zero)
            elif off == 1:
                plane = torch.where(i < n - 1, -row_table(wx), zero)
            elif off == -n:
                plane = torch.where(j > 0, -row_table(wy), zero)
            elif off == n:
                plane = torch.where(j < n - 1, -row_table(wy[..., 1:]), zero)
            else:
                raise ValueError(f"aniso2d stencil has no offset {off}")
            planes.append(local_mask(plane, off))
        return torch.stack(planes)
    raise ValueError(f"unknown stencil kind {kind!r}")


@dataclasses.dataclass
class StencilOperator:
    """A built-in matrix-free stencil: the O(n) coefficient ``tables``
    (empty for constant-coefficient stencils) on ``device``, and the
    static description of the stencil."""

    tables: tuple       # () or small rounded coefficient tensors
    kind: str           # "poisson" | "aniso2d"
    grid: tuple         # (n, dim)
    param: float        # aniso stretch eps; 0.0 for constant stencils
    offsets: tuple      # static diagonal offsets, ascending
    nrows: int
    ncols_padded: int
    dtype: torch.dtype  # storage dtype the generated values take
    device: torch.device

    def planes(self, row0=0, nrows: int | None = None, nowned=None):
        return stencil_planes(self.kind, self.grid, self.offsets,
                              self.tables,
                              self.nrows if nrows is None else nrows,
                              self.dtype, row0=row0, nowned=nowned,
                              device=self.device)

    # -- the DeviceMatrix protocol (ops.spmv dispatch) -----------------

    def _shifted(self, x, stride: int, sign: int):
        """``out[idx] = x[idx + sign*stride]`` where the grid neighbour
        exists, else 0: a pad and slice of the reshaped (-1, n, stride)
        view of x, with no per-element index arithmetic."""
        n = self.grid[0]
        x3 = x.reshape(-1, n, stride)
        z = torch.zeros_like(x3[:, :1, :])
        if sign < 0:
            sh = torch.cat([z, x3[:, :-1, :]], dim=1)
        else:
            sh = torch.cat([x3[:, 1:, :], z], dim=1)
        return sh.reshape(x.shape)

    def matfree_apply(self, x):
        """y = A @ x with the stencil structure as shifted views of the
        reshaped grid: per ascending offset, one neighbour image times
        its coefficient, accumulated in the assembled ``dia_mv``'s
        offset order with the identical per-element products."""
        adt = acc_dtype(x.dtype)
        n, dim = self.grid
        y = torch.zeros(x.shape, dtype=adt, device=x.device)
        if self.kind == "poisson":
            for off in self.offsets:
                if off == 0:
                    y = y + float(2 * dim) * x.to(adt)
                else:
                    sh = self._shifted(x, abs(int(off)),
                                       1 if off > 0 else -1)
                    y = y + -1.0 * sh.to(adt)
            return y.to(x.dtype)
        # aniso2d: coefficients depend only on the grid row j, so each
        # offset is one broadcast of an O(n) table over the (n, n) view
        wx, wy, dtab = self.tables
        x2 = x.reshape(n, n)
        y2 = y.reshape(n, n)
        for off in self.offsets:
            if off == 0:
                y2 = y2 + dtab[:, None].to(adt) * x2.to(adt)
                continue
            stride = abs(int(off))
            sh = self._shifted(x, stride,
                               1 if off > 0 else -1).reshape(n, n)
            if stride == 1:
                coeff = -wx[:, None].to(adt)
            elif off < 0:
                coeff = -wy[:-1, None].to(adt)     # -wy[j]
            else:
                coeff = -wy[1:, None].to(adt)      # -wy[j+1]
            y2 = y2 + coeff * sh.to(adt)
        return y2.reshape(x.shape).to(x.dtype)

    def matfree_nnz(self) -> float:
        """Analytic stored-nonzero count (the assembled twin's nnz): each
        off-diagonal plane is zero on one boundary slice of N/n
        entries."""
        n, dim = self.grid
        N = self.nrows
        return float((2 * dim + 1) * N - 2 * dim * (N // n))

    def table_bytes(self) -> int:
        """Device bytes the generated planes read per apply: the O(n)
        coefficient tables, 0 for constant stencils."""
        return sum(int(t.numel()) * t.element_size() for t in self.tables)

    def identity(self) -> str:
        """The operator's provenance string."""
        n, dim = self.grid
        if self.kind == "poisson":
            return f"stencil:poisson{dim}d:{n}"
        return f"stencil:aniso2d:{n}:{self.param:g}"


def _operator_dtype(dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"matrix-free operators run f32 or f64, got {dtype}")
    return dtype


def poisson_stencil(n: int, dim: int, dtype=torch.float32,
                    device=None) -> StencilOperator:
    """Constant-coefficient Poisson stencil operator (1D/2D/3D), the
    matrix-free twin of ``io.generators.poisson_dia`` /
    ``poisson_dia_device`` (same offsets, same values, bitwise)."""
    if dim not in (1, 2, 3):
        raise ValueError(f"poisson stencil dim must be 1, 2 or 3 "
                         f"(got {dim})")
    if n < 2:
        raise ValueError(f"poisson stencil needs n >= 2 (got {n})")
    N = n ** dim
    offsets = sorted([s for a in range(dim)
                      for s in (-(n ** a), n ** a)] + [0])
    return StencilOperator(tables=(), kind="poisson", grid=(n, dim),
                           param=0.0,
                           offsets=tuple(int(o) for o in offsets),
                           nrows=N, ncols_padded=N,
                           dtype=_operator_dtype(dtype),
                           device=resolve_device(device))


def aniso2d_stencil(n: int, eps: float, dtype=torch.float32,
                    device=None) -> StencilOperator:
    """The variable-coefficient anisotropic 2D family as a matrix-free
    operator: three O(n) tables (x-edge weights, y-edge weights and the
    pre-summed diagonal) replace the O(n^2) planes.  Tables are computed
    in f64 and rounded once to the storage dtype, the single rounding
    the assembled ingest applies, so the generated values equal the
    assembled ones bitwise."""
    if not 0.0 < eps <= 1.0:
        raise ValueError(f"aniso stretch factor must be in (0, 1], "
                         f"got {eps}")
    dtype = _operator_dtype(dtype)
    device = resolve_device(device)
    j = np.arange(n)
    wx = eps ** ((j + 0.5) / n)                    # f64, like the generator
    e = np.arange(n + 1)
    wy = eps ** (-(e / n))
    dtab = 2 * wx + wy[:-1] + wy[1:]               # f64 sum, THEN round
    tables = tuple(torch.from_numpy(t).to(device=device, dtype=dtype)
                   for t in (wx, wy, dtab))
    N = n * n
    return StencilOperator(tables=tables, kind="aniso2d", grid=(n, 2),
                           param=float(eps), offsets=(-n, -1, 0, 1, n),
                           nrows=N, ncols_padded=N, dtype=dtype,
                           device=device)


# -- user-supplied operators (the registration hook) ----------------------

_USER_OPS: dict = {}


def register_operator(name: str, apply_fn, diagonal_fn=None,
                      nnz: float | None = None) -> None:
    """Register a user-supplied operator under ``name``: ``apply_fn(
    captures, x) -> y`` runs wherever the assembled SpMV would
    (``captures`` is the operator instance's tuple of tensors);
    ``diagonal_fn(captures)`` is kept for the preconditioned tier;
    ``nnz`` feeds the flop statistic (default: 0, unknown work)."""
    if not callable(apply_fn):
        raise ValueError(f"operator {name!r}: apply_fn must be callable")
    _USER_OPS[str(name)] = {"apply": apply_fn, "diagonal": diagonal_fn,
                            "nnz": nnz}


def registered_operators() -> tuple:
    return tuple(sorted(_USER_OPS))


@dataclasses.dataclass
class UserOperator:
    """A registered user operator as a solve argument: the closed-over
    tensors ride ``captures``, the registry ``name`` selects the apply."""

    captures: tuple
    name: str
    nrows: int
    ncols_padded: int
    dtype: torch.dtype
    device: torch.device

    def _entry(self):
        try:
            return _USER_OPS[self.name]
        except KeyError:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"operator {self.name!r} is not registered in this "
                f"process (register_operator must run before the solve)")

    def matfree_apply(self, x):
        return self._entry()["apply"](self.captures, x)

    def matfree_nnz(self) -> float:
        return float(self._entry()["nnz"] or 0.0)

    def table_bytes(self) -> int:
        return sum(int(np.prod(np.shape(t))) * (
            t.element_size() if isinstance(t, torch.Tensor)
            else np.asarray(t).itemsize) for t in self.captures)

    def identity(self) -> str:
        return f"user:{self.name}"


def user_operator(name: str, nrows: int, dtype=torch.float32,
                  captures: tuple = (), device=None) -> UserOperator:
    """Instantiate a registered operator for an ``nrows``-row system on
    ``device`` (the CUDA card unless the caller asks for the CPU)."""
    if str(name) not in _USER_OPS:
        raise AcgError(
            ErrorCode.INVALID_VALUE,
            f"operator {name!r} is not registered "
            f"(known: {', '.join(registered_operators()) or 'none'}); "
            f"call acg_tpu_torch.ops.operator.register_operator first")
    return UserOperator(captures=tuple(captures), name=str(name),
                        nrows=int(nrows), ncols_padded=int(nrows),
                        dtype=dtype, device=resolve_device(device))


# -- CLI spec parsing ------------------------------------------------------

def _gen_desc(gen) -> str:
    """Human spelling of a parsed gen: matrix spec for refusals."""
    kind, dim, n = gen[0], gen[1], gen[2]
    if kind == "poisson":
        return f"gen:poisson{dim}d:{n}"
    return f"gen:{kind}:{n}"


_SPEC_HELP = ("expected none, stencil, "
              "stencil:poisson1d|poisson2d|poisson3d:N, "
              "stencil:aniso2d:N:EPS, or user:NAME")


def parse_operator_spec(text):
    """``--operator`` grammar -> spec tuple (None = disarmed):

    * ``none``/empty             -> None (the assembled path)
    * ``stencil``                -> ("auto",): derive the stencil from
                                   the ``gen:`` matrix spec (+ --aniso)
    * ``stencil:poisson1d:N`` (2d/3d) -> ("poisson", dim, N)
    * ``stencil:aniso2d:N:EPS``  -> ("aniso2d", N, EPS)
    * ``user:NAME``              -> ("user", NAME)
    """
    if text is None:
        return None
    t = str(text).strip()
    if t in ("", "none"):
        return None
    if t == "stencil":
        return ("auto",)
    fields = t.split(":")
    if fields[0] == "user":
        if len(fields) != 2 or not fields[1]:
            raise ValueError(f"operator spec {text!r}: expected "
                             f"user:NAME")
        return ("user", fields[1])
    if fields[0] != "stencil":
        raise ValueError(f"operator spec {text!r}: {_SPEC_HELP}")
    kind = fields[1] if len(fields) > 1 else ""
    try:
        if kind in ("poisson1d", "poisson2d", "poisson3d"):
            if len(fields) != 3:
                raise ValueError
            dim = int(kind[7])
            n = int(fields[2])
            if n < 2:
                raise ValueError
            return ("poisson", dim, n)
        if kind == "aniso2d":
            if len(fields) != 4:
                raise ValueError
            n = int(fields[2])
            eps = float(fields[3])
            if n < 2 or not 0.0 < eps <= 1.0:
                raise ValueError
            return ("aniso2d", n, eps)
    except ValueError:
        pass
    raise ValueError(f"operator spec {text!r}: {_SPEC_HELP}")


def build_operator(spec, dtype, gen=None, aniso=None, nrows=None,
                   device=None):
    """Spec tuple -> operator instance on ``device``.  ``gen`` is the
    parsed ``gen:`` matrix spec tuple (kind, dim, n, N, avg) when the
    matrix came from a generator: the ``("auto",)`` spelling derives the
    stencil from it, and explicit spellings are validated against it (an
    operator that does not compute the matrix being solved would answer
    a different system)."""
    if spec is None:
        return None
    if spec[0] == "auto":
        if gen is None or gen[0] != "poisson":
            raise ValueError(
                "--operator stencil derives the stencil from a "
                "gen:poisson* matrix spec (files and gen:irregular are "
                "assembled by definition); name the stencil explicitly "
                "(stencil:poisson2d:N, stencil:aniso2d:N:EPS) or use a "
                "registered user:NAME operator")
        _, dim, n, _N, _ = gen
        if aniso is not None:
            return aniso2d_stencil(n, float(aniso), dtype=dtype,
                                   device=device)
        return poisson_stencil(n, dim, dtype=dtype, device=device)
    if spec[0] == "poisson":
        _, dim, n = spec
        # the gen: matrix must affirmatively match: another kind, dim or
        # n, or an --aniso selection, would solve a different system
        if gen is not None and (gen[0] != "poisson"
                                or (gen[1], gen[2]) != (dim, n)):
            raise ValueError(
                f"--operator stencil:poisson{dim}d:{n} does not compute "
                f"the gen: matrix being solved ({_gen_desc(gen)})")
        if aniso is not None:
            raise ValueError(
                "--aniso selects the variable-coefficient family; use "
                "--operator stencil (auto) or stencil:aniso2d:N:EPS")
        return poisson_stencil(n, dim, dtype=dtype, device=device)
    if spec[0] == "aniso2d":
        _, n, eps = spec
        if gen is not None and (gen[0] != "poisson" or gen[1] != 2
                                or gen[2] != n):
            raise ValueError(
                f"--operator stencil:aniso2d:{n}:{eps:g} does not "
                f"compute the gen: matrix being solved "
                f"({_gen_desc(gen)})")
        if gen is not None and aniso is None:
            # without --aniso the gen matrix is the constant-coefficient
            # family
            raise ValueError(
                f"--operator stencil:aniso2d:{n}:{eps:g} computes the "
                f"anisotropic family, but the matrix being solved is "
                f"the constant-coefficient gen:poisson2d:{n} (add "
                f"--aniso {eps:g} to solve the anisotropic system)")
        if aniso is not None and float(aniso) != float(eps):
            raise ValueError(
                f"--operator stencil:aniso2d:{n}:{eps:g} disagrees "
                f"with --aniso {aniso:g}")
        return aniso2d_stencil(n, eps, dtype=dtype, device=device)
    if spec[0] == "user":
        if nrows is None:
            raise ValueError("user operators need the system size")
        return user_operator(spec[1], nrows, dtype=dtype, device=device)
    raise ValueError(f"unknown operator spec {spec!r}")


def operator_identity(A) -> str | None:
    """Provenance string of a matrix-free operator (None for assembled
    matrices)."""
    if is_matrix_free(A) and hasattr(A, "identity"):
        return A.identity()
    return None
