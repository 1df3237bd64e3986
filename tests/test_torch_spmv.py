"""The port's device formats and plain SpMV (acg_tpu_torch.ops.spmv)
against the JAX package's (acg_tpu.ops.spmv) and scipy.

Both packages get the same host CSR; the port's matrices are built from
the JAX matrices' own arrays through ``device_matrix_from_arrays``, so
both multiply the same values.  Tolerances: DIA in f64 on a stencil is
bitwise-equal (every product is exact, and the sums run in the same
offsets order); the gather formats sum each row in another order than
XLA's reductions, so they are held to 1e-13 relative, as the JAX
package's own scipy comparison is.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu_torch.io.generators import irregular_spd_coo, poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import spmv as tspmv

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

# the module, not the function acg_tpu.ops re-exports under its name
jspmv = importlib.import_module("acg_tpu.ops.spmv")

CPU = "cpu"


@pytest.fixture(scope="module")
def poisson16():
    csr = SymCsrMatrix.from_mtx(poisson_mtx(16, dim=2)).to_csr()
    # the JAX package's host matrix of the same file
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(16, dim=2)).to_csr()
    assert (csr != jcsr).nnz == 0
    return csr


@pytest.fixture(scope="module")
def irregular():
    r, c, v, N = irregular_spd_coo(300, avg_degree=8.0, seed=3)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def _arrays(A):
    """(fmt, arrays, meta) of a JAX device matrix, as numpy."""
    if isinstance(A, jspmv.DiaMatrix):
        return "dia", [np.asarray(p) for p in A.data], {
            "offsets": A.offsets, "nrows": A.nrows,
            "ncols_padded": A.ncols_padded}
    meta = {"nrows": A.nrows, "ncols_padded": A.ncols_padded}
    if isinstance(A, jspmv.EllMatrix):
        return "ell", (np.asarray(A.data), np.asarray(A.cols)), meta
    if isinstance(A, jspmv.CooMatrix):
        return "coo", (np.asarray(A.rows), np.asarray(A.cols),
                       np.asarray(A.vals)), meta
    return "bell", ([np.asarray(r) for r in A.bin_rows],
                    [np.asarray(d) for d in A.bin_data],
                    [np.asarray(c) for c in A.bin_cols],
                    np.asarray(A.tail_rows), np.asarray(A.tail_cols),
                    np.asarray(A.tail_vals)), dict(meta, bin_ks=A.bin_ks)


_KIND = {jspmv.DiaMatrix: tspmv.DiaMatrix, jspmv.EllMatrix: tspmv.EllMatrix,
         jspmv.CooMatrix: tspmv.CooMatrix,
         jspmv.BinnedEllMatrix: tspmv.BinnedEllMatrix}


def _scrambled(csr):
    perm = np.random.default_rng(0).permutation(csr.shape[0])
    Pm = sp.eye(csr.shape[0], format="csr")[perm]
    return (Pm @ csr @ Pm.T).tocsr()


def _arrow(n=200):
    a = sp.lil_matrix((n, n))
    a[0, :] = 1.0
    a[:, 0] = 1.0
    a.setdiag(n)
    return a.tocsr()


@pytest.mark.parametrize("case", ["poisson", "scrambled", "arrow",
                                  "irregular"])
def test_auto_format_choice_matches_jax(case, poisson16, irregular):
    csr = {"poisson": poisson16, "scrambled": _scrambled(poisson16),
           "arrow": _arrow(), "irregular": irregular}[case]
    want = jspmv.device_matrix_from_csr(csr, dtype=jnp.float64)
    got = tspmv.device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    assert isinstance(got, _KIND[type(want)])
    assert tspmv.matrix_index_bytes(got) == jspmv.matrix_index_bytes(want)
    assert tspmv.spmv_flops(got) == jspmv.spmv_flops(want)


# (an irregular matrix has hundreds of diagonals: no DIA case for it)
@pytest.mark.parametrize("case,fmt", [
    ("poisson", "dia"), ("poisson", "ell"), ("poisson", "coo"),
    ("poisson", "bell"), ("irregular", "ell"), ("irregular", "coo"),
    ("irregular", "bell"), ("hub", "bell")])
def test_spmv_matches_jax_and_scipy(case, fmt, poisson16, irregular):
    # "hub": a 700-entry row is wider than the widest bin (512) and
    # lands in binned ELL's COO tail
    csr = {"poisson": poisson16, "irregular": irregular,
           "hub": _arrow(700)}[case]
    x = np.random.default_rng(1).standard_normal(csr.shape[0])
    A = jspmv.device_matrix_from_csr(csr, dtype=jnp.float64, format=fmt)
    want = np.asarray(jspmv.spmv(A, jnp.asarray(x)))
    kind, arrays, meta = _arrays(A)
    B = tspmv.device_matrix_from_arrays(kind, arrays, meta,
                                        dtype=torch.float64, device=CPU)
    got = tspmv.spmv(B, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, csr @ x, rtol=1e-13, atol=1e-13)
    if fmt == "dia":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    # the port's own host builders give the same matrix
    C = tspmv.device_matrix_from_csr(csr, dtype=torch.float64, format=fmt,
                                     device=CPU)
    np.testing.assert_array_equal(tspmv.spmv(C, torch.from_numpy(x)).numpy(),
                                  got)


def test_dia_f64_bitwise_equals_dia_mv_and_offsets(poisson16):
    """DIA f64: bitwise-equal to the JAX dia_mv, and a nonsymmetric band
    with out-of-band clipping at both edges keeps its offsets."""
    A = jspmv.dia_from_csr(poisson16, dtype=jnp.float64)
    B = tspmv.dia_from_csr(poisson16, dtype=torch.float64, device=CPU)
    assert B.offsets == A.offsets
    np.testing.assert_array_equal(B.data.numpy(),
                                  np.stack([np.asarray(p) for p in A.data]))
    x = np.random.default_rng(2).standard_normal(poisson16.shape[0])
    np.testing.assert_array_equal(
        tspmv.dia_mv(B.data, B.offsets, B.nrows, torch.from_numpy(x)).numpy(),
        np.asarray(jspmv.dia_mv(A.data, A.offsets, A.nrows, jnp.asarray(x))))
    n = 50
    band = sp.diags([np.arange(1, n - 1, dtype=float), np.full(n, 4.0),
                     -np.ones(n - 3)], [-2, 0, 3]).tocsr()
    D = tspmv.dia_from_csr(band, dtype=torch.float64, device=CPU)
    assert D.offsets == (-2, 0, 3)
    y = np.random.default_rng(1).standard_normal(n)
    np.testing.assert_allclose(tspmv.spmv(D, torch.from_numpy(y)).numpy(),
                               band @ y, rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_low_precision_spmv_accumulates_in_f32(dtype, poisson16):
    """f32/bf16 storage accumulates in f32 and rounds once, as the JAX
    dia_mv and ELL einsum do: DIA bitwise (same order, exact products);
    ELL within a few f32 ulps (XLA's einsum sums a row in another
    order), which a bf16 result may turn into one bf16 ulp."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = np.random.default_rng(3).standard_normal(poisson16.shape[0])
    for fmt in ("dia", "ell"):
        A = jspmv.device_matrix_from_csr(poisson16, dtype=jdt, format=fmt)
        want = np.asarray(jspmv.spmv(A, jnp.asarray(x, jdt)), np.float64)
        B = tspmv.device_matrix_from_csr(poisson16, dtype=dtype, format=fmt,
                                         device=CPU)
        got = tspmv.spmv(B, torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        got = got.to(torch.float64).numpy()
        if fmt == "dia":
            np.testing.assert_array_equal(got, want)
        else:
            rtol = 1e-6 if dtype == torch.float32 else 2 ** -8
            np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_matrix_construction_refuses_missing_card(poisson16):
    """The default device is the card: without one, building a device
    matrix raises instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from acg_tpu_torch.errors import AcgError
    with pytest.raises(AcgError, match="no CUDA device"):
        tspmv.device_matrix_from_csr(poisson16)


@pytest.mark.parametrize("case", ["irregular", "hub", "empty-rows"])
def test_padded_rows_write_each_row_once(case, irregular):
    """The padded-row layout of COO entries and of the binned-ELL hub
    tail: every row in exactly one group, its entry positions in index
    order (-1 padding after), padding under 2x -- the layout that keeps
    the single-device SpMV free of scatter-adds, so every run on the
    card gives the same bits; and the COO SpMV on it equals scipy's."""
    csr = {"irregular": irregular, "hub": _arrow(1500),
           "empty-rows": sp.csr_matrix(sp.diags(
               np.r_[np.zeros(5), np.ones(5)]))}[case]
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    groups = tspmv.padded_rows(rows)
    dst = np.concatenate([d for d, _ in groups])
    assert np.array_equal(np.sort(dst), np.flatnonzero(np.diff(csr.indptr)))
    slots = sum(idx.size for _, idx in groups)
    assert csr.nnz <= slots < 2 * csr.nnz
    for d, idx in groups:
        for r, irow in zip(d, idx):
            lo, hi = csr.indptr[r], csr.indptr[r + 1]
            assert np.array_equal(irow[:hi - lo], np.arange(lo, hi))
            assert (irow[hi - lo:] == -1).all()
    A = tspmv.device_matrix_from_csr(csr, dtype=torch.float64, format="coo",
                                     device=CPU)
    x = np.random.default_rng(2).standard_normal(csr.shape[0])
    np.testing.assert_allclose(tspmv.spmv(A, torch.from_numpy(x)).numpy(),
                               csr @ x, rtol=1e-13, atol=1e-13)
