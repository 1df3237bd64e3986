"""Model-problem generators: 2D/3D Poisson, the anisotropic 2D family
and irregular SPD matrices.

A copy of the numpy builders of ``acg_tpu/io/generators.py``: COO
triplets of the FULL symmetric matrix (callers needing one-triangle
storage filter ``r <= c``), DIA planes built directly (on the host, or
on the device with no host matrix: :func:`poisson_dia_device`), the
symmetric Matrix Market wrappers (:func:`poisson_mtx`,
:func:`irregular_mtx`) and the seeded right-hand-side block of
``--nrhs`` (:func:`batched_rhs`).
"""

from __future__ import annotations

import numpy as np

from acg_tpu_torch.io.mtxfile import IDX_DTYPE, MtxFile


def poisson2d_coo(n: int, dtype=np.float64):
    """5-point 2D Poisson stencil on an n x n grid -> full COO (N = n*n)."""
    idx = np.arange(n * n, dtype=IDX_DTYPE)
    i, j = idx // n, idx % n
    rows = [idx]
    cols = [idx]
    vals = [np.full(n * n, 4.0, dtype=dtype)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < n) & (jj >= 0) & (jj < n)
        rows.append(idx[ok])
        cols.append((ii * n + jj)[ok])
        vals.append(np.full(ok.sum(), -1.0, dtype=dtype))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n * n


def aniso_poisson2d_coo(n: int, eps: float, dtype=np.float64):
    """Anisotropic (stretched-grid) 2D Poisson on an n x n tensor grid ->
    full COO (N = n*n): the Laplacian assembled symmetrically (FV/FEM
    edge weights) on a grid whose y-spacings shrink geometrically by the
    stretch factor ``eps = h_min/h_max <= 1``.  x-edge weights span
    ``[eps, 1]`` and y-edge weights ``[1, 1/eps]``, so the diagonal
    varies by ~1/eps across the grid.  SPD: a positively weighted graph
    Laplacian plus Dirichlet boundary terms."""
    if not 0.0 < eps <= 1.0:
        raise ValueError(f"aniso stretch factor must be in (0, 1], "
                         f"got {eps}")
    j = np.arange(n)
    # x-edge weight in grid row j, and y-edge weight at horizontal edge e
    # (e = 0 and n are the Dirichlet boundary edges)
    wx = (eps ** ((j + 0.5) / n)).astype(dtype)
    e = np.arange(n + 1)
    wy = (eps ** (-(e / n))).astype(dtype)

    def idx(jj, ii):
        return (jj * n + ii).astype(IDX_DTYPE)

    J, I = np.meshgrid(j, j, indexing="ij")
    rows = [idx(J, I).ravel()]
    cols = [idx(J, I).ravel()]
    vals = [(2 * wx[J] + wy[J] + wy[J + 1]).ravel()]
    for di in (-1, 1):
        ok = (I + di >= 0) & (I + di < n)
        rows.append(idx(J, I)[ok])
        cols.append(idx(J, I + di)[ok])
        vals.append(-wx[J][ok])
    ok = J + 1 < n     # the edge between grid rows j and j+1 weighs wy[j+1]
    rows.append(idx(J, I)[ok])
    cols.append(idx(J + 1, I)[ok])
    vals.append(-wy[J + 1][ok])
    rows.append(idx(J + 1, I)[ok])
    cols.append(idx(J, I)[ok])
    vals.append(-wy[J + 1][ok])
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n * n)


def poisson3d_coo(n: int, dtype=np.float64):
    """7-point 3D Poisson stencil on an n^3 grid -> full COO (N = n^3)."""
    N = n * n * n
    idx = np.arange(N, dtype=IDX_DTYPE)
    i, j, k = idx // (n * n), (idx // n) % n, idx % n
    rows = [idx]
    cols = [idx]
    vals = [np.full(N, 6.0, dtype=dtype)]
    for di, dj, dk in ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                       (0, 0, -1), (0, 0, 1)):
        ii, jj, kk = i + di, j + dj, k + dk
        ok = ((ii >= 0) & (ii < n) & (jj >= 0) & (jj < n)
              & (kk >= 0) & (kk < n))
        rows.append(idx[ok])
        cols.append(((ii * n + jj) * n + kk)[ok])
        vals.append(np.full(ok.sum(), -1.0, dtype=dtype))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), N


def poisson_dia(n: int, dim: int = 2, dtype=np.float64):
    """Poisson stencil assembled directly as DIA planes -- no COO/CSR
    intermediate, no sort: O(ndiags * N) time and memory.

    Returns ``(planes, offsets, N)`` with the package DIA convention
    ``planes[d][r] = A[r, r + offsets[d]]`` (``ops.spmv.DiaMatrix``).
    """
    N = n ** dim
    diag_val = float(2 * dim)
    offsets, planes = [], []
    # axis a (0 = fastest-varying) has stride n^a; the entry A[r, r +- n^a]
    # exists unless the coordinate (r // n^a) % n sits on that boundary,
    # which is one slice of the middle axis of the (N/period, n, stride) view
    for a in range(dim):
        stride = n ** a
        lo = np.full(N, -1.0, dtype=dtype)
        lo.reshape(-1, n, stride)[:, 0, :] = 0.0
        hi = np.full(N, -1.0, dtype=dtype)
        hi.reshape(-1, n, stride)[:, -1, :] = 0.0
        offsets += [-stride, stride]
        planes += [lo, hi]
    offsets.append(0)
    planes.append(np.full(N, diag_val, dtype=dtype))
    order = np.argsort(offsets)
    return ([planes[i] for i in order],
            tuple(int(offsets[i]) for i in order), N)


def poisson_dia_device(n: int, dim: int = 2, dtype=None, device=None,
                       epsilon: float = 0.0):
    """Poisson DIA planes built on the device: no host matrix and no
    upload.  The same planes as :func:`poisson_dia`, bitwise, as one
    contiguous (2*dim + 1, N) tensor in ascending offset order: each
    plane is a device fill plus one strided zero write of its boundary
    slice; ``epsilon`` is added to the diagonal (``--epsilon``).
    ``dtype`` defaults to float32 (``acg_tpu.io.generators.
    poisson_dia_device``), ``device`` to the CUDA card.

    Returns ``(planes, offsets, N)``."""
    import torch

    from acg_tpu_torch._device import resolve_device

    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    N = n ** dim
    offsets = sorted([s for a in range(dim) for s in (-(n ** a), n ** a)]
                     + [0])
    planes = torch.empty((len(offsets), N), dtype=dtype, device=device)
    for d, off in enumerate(offsets):
        if off == 0:
            planes[d].fill_(float(2 * dim))
            if epsilon:
                planes[d] += torch.tensor(epsilon, dtype=dtype,
                                          device=device)
            continue
        planes[d].fill_(-1.0)
        edge = planes[d].view(-1, n, abs(off))
        edge[:, 0 if off < 0 else n - 1, :] = 0.0
    return planes, tuple(int(o) for o in offsets), N


def batched_rhs(n: int, nrhs: int, seed: int = 42,
                dtype=np.float64) -> np.ndarray:
    """Default multi-RHS block for ``--nrhs B``: B random unit-norm
    columns (seeded).  Random, NOT replicated ones: parallel columns
    would collapse the block Krylov space to rank 1, making every
    batched/block measurement degenerate -- a serving fleet's requests
    differ, and so must the default benchmark block."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, int(nrhs))).astype(dtype)
    B /= np.linalg.norm(B, axis=0, keepdims=True)
    return B


def irregular_spd_coo(n: int, avg_degree: float = 16.0, seed: int = 0,
                      dtype=np.float64):
    """Random irregular SPD matrix -> full COO.

    A configuration-model graph whose degrees follow a truncated power
    law (row lengths vary by orders of magnitude, defeating banded/DIA
    layouts and exercising the ELL/gather SpMV paths), with negative
    off-diagonal weights and a strictly diagonally dominant diagonal.

    Every row sums to exactly 1 (diag = 1 + sum|offdiag|), so ``b = ones``
    is an eigenvector and CG converges on it in one iteration -- use a
    manufactured solution for convergence behaviour.
    """
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(2.2, n) + 1.0) * (avg_degree * 0.546),
                     n // 4).astype(np.int64)
    stubs = np.repeat(np.arange(n, dtype=IDX_DTYPE), deg)
    rng.shuffle(stubs)
    if stubs.size % 2:
        stubs = stubs[:-1]
    u, v = stubs[0::2], stubs[1::2]
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    edges = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = (edges // n).astype(IDX_DTYPE), (edges % n).astype(IDX_DTYPE)
    w = -(0.1 + rng.random(lo.size)).astype(dtype)
    diag = np.ones(n, dtype=dtype)
    np.add.at(diag, lo, -w)
    np.add.at(diag, hi, -w)
    idx = np.arange(n, dtype=IDX_DTYPE)
    rows = np.concatenate([idx, lo, hi])
    cols = np.concatenate([idx, hi, lo])
    vals = np.concatenate([diag, w, w])
    return rows, cols, vals, n


def irregular_mtx(n: int, avg_degree: float = 16.0, seed: int = 0) -> MtxFile:
    """Irregular SPD matrix as a symmetric (lower-triangle) MtxFile."""
    r, c, v, N = irregular_spd_coo(n, avg_degree, seed)
    keep = r >= c
    order = np.lexsort((c[keep], r[keep]))
    return MtxFile(object="matrix", format="coordinate", field="real",
                   symmetry="symmetric", nrows=N, ncols=N, nnz=int(keep.sum()),
                   rowidx=r[keep][order], colidx=c[keep][order],
                   vals=v[keep][order])


def poisson_mtx(n: int, dim: int = 2) -> MtxFile:
    """Poisson matrix as a symmetric (lower-triangle) MtxFile."""
    if dim == 2:
        r, c, v, N = poisson2d_coo(n)
    elif dim == 3:
        r, c, v, N = poisson3d_coo(n)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    keep = r >= c  # store lower triangle once, symmetry declared in header
    order = np.lexsort((c[keep], r[keep]))
    return MtxFile(object="matrix", format="coordinate", field="real",
                   symmetry="symmetric", nrows=N, ncols=N, nnz=int(keep.sum()),
                   rowidx=r[keep][order], colidx=c[keep][order],
                   vals=v[keep][order],
                   comments=[f"% acg-tpu poisson{dim}d n={n}"])
