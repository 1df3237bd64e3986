"""The plain reference and the input generator, in plain PyTorch.

Nothing here imports the program: the Poisson operator is rebuilt from
``(n, dim)`` as a stencil, and classic CG is written out step by step.
The same stencil forms the right-hand sides the program is given, so the
program and the reference see the same inputs and nothing the program
derived from them.
"""

from __future__ import annotations

import torch


def stencil_apply(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``y = A x`` for the (2 dim + 1)-point Poisson operator on an
    ``n``-per-side grid, row-major, zero outside the grid: ``y_i = 2 dim
    x_i`` minus the grid neighbours along each axis."""
    g = x.view((n,) * dim)
    y = g * (2 * dim)
    for ax in range(dim):
        y.narrow(ax, 1, n - 1).sub_(g.narrow(ax, 0, n - 1))
        y.narrow(ax, 0, n - 1).sub_(g.narrow(ax, 1, n - 1))
    return y.reshape(-1)


def manufactured_rhs(seed: int, count: int, n: int, dim: int,
                     device) -> torch.Tensor:
    """``count`` right-hand sides ``b = A x*`` in float64, one a row,
    with ``x* ~ N(0, 1)`` drawn on ``device`` from ``seed`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    xs = torch.randn((count, n ** dim), generator=gen, dtype=torch.float64,
                     device=device)
    for j in range(count):
        xs[j] = stencil_apply(xs[j], n, dim)
    return xs


def cg(b: torch.Tensor, n: int, dim: int, maxits: int, rtol: float = 0.0,
       dtype=torch.float64) -> tuple[torch.Tensor, int]:
    """Classic CG from x0 = 0 in ``dtype`` (vectors, dots and stencil):
    ``maxits`` iterations, or fewer when ``rtol`` > 0 and the recurrence
    residual falls below ``rtol * ||b||``.  Returns ``(x, iterations)``."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    gamma = torch.dot(r, r)
    tol2 = gamma * (rtol * rtol)
    k = 0
    while k < maxits:
        if rtol > 0 and bool(gamma < tol2):
            break
        t = stencil_apply(p, n, dim)
        alpha = gamma / torch.dot(p, t)
        x.add_(alpha * p)
        r.sub_(alpha * t)
        del t
        gamma_next = torch.dot(r, r)
        p.mul_(gamma_next / gamma).add_(r)
        gamma = gamma_next
        k += 1
    return x, k
