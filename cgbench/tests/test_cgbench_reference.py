"""The plain reference against SciPy: the stencil against an assembled
matrix and classic CG against ``scipy.sparse.linalg.cg`` at 16^2."""

import numpy as np
import pytest
import torch

from cgbench import reference

sp = pytest.importorskip("scipy.sparse")
spla = pytest.importorskip("scipy.sparse.linalg")


def poisson(n, dim):
    one = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    A = one
    for _ in range(dim - 1):
        A = (sp.kron(A, sp.identity(n))
             + sp.kron(sp.identity(A.shape[0]), one))
    return sp.csr_matrix(A)


@pytest.mark.parametrize("n, dim", [(16, 2), (9, 3), (5, 1)])
def test_stencil_is_the_assembled_operator(n, dim):
    x = np.random.default_rng(0).standard_normal(n ** dim)
    y = reference.stencil_apply(torch.from_numpy(x.copy()), n, dim)
    np.testing.assert_allclose(y.numpy(), poisson(n, dim) @ x, rtol=0,
                               atol=1e-13)


def test_cg_matches_scipy_at_16():
    n, dim = 16, 2
    b = reference.manufactured_rhs(5, 1, n, dim, "cpu")[0]
    x, k = reference.cg(b, n, dim, 10_000, rtol=1e-10)
    xs, info = spla.cg(poisson(n, dim), b.numpy(), rtol=1e-10, atol=0.0,
                       maxiter=10_000)
    assert info == 0 and 0 < k < 10_000
    assert (np.linalg.norm(x.numpy() - xs) / np.linalg.norm(xs)) < 1e-8


def test_cg_fixed_iterations_and_float32():
    n, dim = 16, 2
    b = reference.manufactured_rhs(5, 1, n, dim, "cpu")[0]
    x64, k64 = reference.cg(b, n, dim, 12)
    x32, k32 = reference.cg(b, n, dim, 12, dtype=torch.float32)
    assert k64 == k32 == 12 and x32.dtype == torch.float32
    gap = (x32.double() - x64).norm() / x64.norm()
    assert 1e-9 < gap < 1e-4


def test_manufactured_rhs_is_the_seeds():
    a = reference.manufactured_rhs(2 ** 33 + 1, 3, 8, 2, "cpu")
    b = reference.manufactured_rhs(2 ** 33 + 1, 3, 8, 2, "cpu")
    c = reference.manufactured_rhs(2 ** 33 + 2, 3, 8, 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, 64) and a.dtype == torch.float64
