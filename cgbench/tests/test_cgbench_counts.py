"""The benchmark's byte counts, against the table its issue fixed."""

import pytest

from cgbench import counts


@pytest.mark.parametrize("n, dim, N, nnz, spmv, iteration", [
    (2048, 2, 4_194_304, 20_963_328, 234_815_488, 469_696_512),
    (512, 3, 134_217_728, 937_951_232, 9_651_093_504, 17_167_286_272),
])
def test_counts(n, dim, N, nnz, spmv, iteration):
    assert counts.operator_counts(n, dim) == (N, nnz)
    assert counts.spmv_bytes(n, dim) == spmv
    assert counts.iteration_bytes(n, dim) == iteration


@pytest.mark.parametrize("n, dim, spmv_us, iter_us", [
    (2048, 2, 70.1, 140.2), (512, 3, 2880.9, 5124.6)])
def test_bounds_at_the_published_rate(n, dim, spmv_us, iter_us):
    rate = counts.HBM_BYTES_PER_S
    assert counts.spmv_bytes(n, dim) / rate * 1e6 == pytest.approx(
        spmv_us, abs=0.05)
    assert counts.iteration_bytes(n, dim) / rate * 1e6 == pytest.approx(
        iter_us, abs=0.05)


def test_assembled_poisson_nnz_matches_scipy():
    sp = pytest.importorskip("scipy.sparse")
    for n, dim in ((7, 2), (5, 3)):
        one = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
        eye = sp.identity(n)
        A = one
        for _ in range(dim - 1):
            A = sp.kron(A, eye) + sp.kron(sp.identity(A.shape[0]), one)
        assert A.nnz == counts.operator_counts(n, dim)[1]
