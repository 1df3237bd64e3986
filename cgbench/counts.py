"""The benchmark's own count of the bytes an assembled Poisson operator
moves, whatever implements it: each input byte read once and each
output byte written once, no index bytes, no stored zeros."""

# NVIDIA H100 SXM, published HBM3 bandwidth (data sheet; 700 W part)
HBM_BYTES_PER_S = 3.35e12


def operator_counts(n: int, dim: int) -> tuple[int, int]:
    """``(N, nnz)`` of the (2 dim + 1)-point Poisson operator on an
    ``n``-per-side grid with Dirichlet boundaries."""
    N = n ** dim
    return N, (2 * dim + 1) * N - 2 * dim * n ** (dim - 1)


def spmv_bytes(n: int, dim: int, value_bytes: int = 8) -> int:
    """One SpMV: the nonzero values, x read once, y written once."""
    N, nnz = operator_counts(n, dim)
    return (nnz + 2 * N) * value_bytes


def iteration_bytes(n: int, dim: int, value_bytes: int = 8) -> int:
    """One classic CG iteration: the values, plus nine vector passes
    (the SpMV reads p and writes Ap; the update reads x, r, p and Ap and
    writes x, r and p)."""
    N, nnz = operator_counts(n, dim)
    return (nnz + 9 * N) * value_bytes
