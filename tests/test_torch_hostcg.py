"""The port's host oracles (acg_tpu_torch.solvers.host_cg, .petsc_cg,
.precond.HostPrecond, .vector) against the JAX package's.

Both packages run the same numpy/scipy operations in the same order, so
x, the iteration counts and the statistics block (every line but the
measured seconds and rates) are held bitwise, on 2D Poisson and on the
irregular SPD family.
"""

import re

import numpy as np
import pytest

from acg_tpu.io.generators import irregular_spd_coo, poisson2d_coo
from acg_tpu.matrix import SymCsrMatrix as JSym
from acg_tpu.solvers import host_cg as jh
from acg_tpu.solvers.petsc_cg import PetscBaselineSolver as JPetsc
from acg_tpu.solvers.stats import StoppingCriteria as JCrit
from acg_tpu_torch.errors import (IndefiniteMatrixError, NotConvergedError)
from acg_tpu_torch.matrix import SymCsrMatrix as TSym
from acg_tpu_torch.solvers import host_cg as th
from acg_tpu_torch.solvers.petsc_cg import PetscBaselineSolver as TPetsc
from acg_tpu_torch.solvers.stats import StoppingCriteria as TCrit


def _system(kind):
    if kind == "poisson":
        r, c, v, N = poisson2d_coo(20)
    else:
        r, c, v, N = irregular_spd_coo(400, avg_degree=8.0, seed=3)
    rng = np.random.default_rng(7)
    xsol = rng.standard_normal(N)
    jcsr = JSym.from_coo(N, r, c, v).to_csr()
    tcsr = TSym.from_coo(N, r, c, v).to_csr()
    assert (jcsr != tcsr).nnz == 0
    return jcsr, tcsr, jcsr @ xsol


_TIMED = re.compile(r"[-\d,.]+ (seconds|Gflop/s|GB/s)")


def _stats_lines(st):
    """The statistics block without its measured seconds and rates (and
    without the timings section, which holds only seconds)."""
    text = st.fwrite().split("timings:")[0]
    return [_TIMED.sub("<t>", ln) for ln in text.splitlines()]


def _crit(pkg, **kw):
    return (JCrit if pkg == "jax" else TCrit)(**kw)


@pytest.mark.parametrize("kind", ["poisson", "irregular"])
@pytest.mark.parametrize("precond", [None, "jacobi", "bjacobi:8",
                                     "cheby:3"])
def test_host_cg_bitwise(kind, precond):
    jcsr, tcsr, b = _system(kind)
    kw = dict(maxits=3000, residual_rtol=1e-10)
    js = jh.HostCGSolver(jcsr, precond=precond)
    ts = th.HostCGSolver(tcsr, precond=precond)
    xj = js.solve(b, criteria=_crit("jax", **kw))
    xt = ts.solve(b, criteria=_crit("torch", **kw))
    assert np.array_equal(xj, xt)
    assert ts.stats.niterations == js.stats.niterations > 0
    assert _stats_lines(ts.stats) == _stats_lines(js.stats)


def test_host_cg_diff_criterion_and_x0_bitwise():
    jcsr, tcsr, b = _system("poisson")
    x0 = np.full(b.size, 0.1)
    kw = dict(maxits=3000, diff_atol=1e-10)
    xj = jh.HostCGSolver(jcsr).solve(b, x0=x0, criteria=_crit("jax", **kw))
    xt = th.HostCGSolver(tcsr).solve(b, x0=x0,
                                     criteria=_crit("torch", **kw))
    assert np.array_equal(xj, xt)


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_host_dist_cg_bitwise(nparts):
    from acg_tpu.graph import partition_matrix as jpm
    from acg_tpu.partition import partition_rows as jpr
    from acg_tpu_torch.graph import partition_matrix as tpm
    from acg_tpu_torch.partition import partition_rows as tpr

    jcsr, tcsr, b = _system("irregular")
    jpart = jpr(jcsr, nparts, seed=0)
    tpart = tpr(tcsr, nparts, seed=0)
    assert np.array_equal(jpart, tpart)
    kw = dict(maxits=2000, residual_rtol=1e-10)
    js = jh.HostDistCGSolver(jpm(jcsr, jpart, nparts))
    ts = th.HostDistCGSolver(tpm(tcsr, tpart, nparts))
    xj = js.solve(b, criteria=_crit("jax", **kw))
    xt = ts.solve(b, criteria=_crit("torch", **kw))
    assert np.array_equal(xj, xt)
    assert ts.stats.niterations == js.stats.niterations > 0
    assert _stats_lines(ts.stats) == _stats_lines(js.stats)


@pytest.mark.parametrize("pipelined", [False, True])
def test_petsc_baseline_bitwise(pipelined):
    jcsr, tcsr, b = _system("poisson")
    kw = dict(maxits=2000, residual_rtol=1e-10)
    js = JPetsc(jcsr, pipelined=pipelined)
    ts = TPetsc(tcsr, pipelined=pipelined)
    xj = js.solve(b, criteria=_crit("jax", **kw))
    xt = ts.solve(b, criteria=_crit("torch", **kw))
    assert np.array_equal(xj, xt)
    assert _stats_lines(ts.stats) == _stats_lines(js.stats)


@pytest.mark.parametrize("kind", ["poisson", "irregular"])
def test_host_batched_and_block_oracles_bitwise(kind):
    jcsr, tcsr, b = _system(kind)
    B = np.column_stack([b, np.ones_like(b), np.arange(b.size) % 7 - 3.0])
    kw = dict(maxits=2000, residual_rtol=1e-9)
    jo = jh.host_batched_cg(jcsr, B, criteria=_crit("jax", **kw))
    to = th.host_batched_cg(tcsr, B, criteria=_crit("torch", **kw))
    for a, c in zip(jo, to):
        assert np.array_equal(a, c)
    jo = jh.host_block_cg(jcsr, B, criteria=_crit("jax", **kw))
    to = th.host_block_cg(tcsr, B, criteria=_crit("torch", **kw))
    assert to[3] == jo[3] > 0
    for a, c in zip(jo[:3], to[:3]):
        assert np.array_equal(a, c)


def test_host_precond_states_bitwise():
    from acg_tpu.precond import HostPrecond as JHP
    from acg_tpu.precond import parse_precond as jpp
    from acg_tpu_torch.precond import HostPrecond as THP
    from acg_tpu_torch.precond import parse_precond as tpp

    jcsr, tcsr, b = _system("irregular")
    for kind in ("jacobi", "bjacobi:16", "cheby:4"):
        jm, tm = JHP(jpp(kind), jcsr), THP(tpp(kind), tcsr)
        for a, c in zip(jm.state, tm.state):
            assert np.array_equal(np.asarray(a), np.asarray(c))
        assert np.array_equal(jm.apply(b), tm.apply(b))


def test_indefinite_and_not_converged_errors():
    import scipy.sparse as sp

    A = sp.csr_matrix(np.diag([1.0, -1.0]))
    b = np.ones(2)
    with pytest.raises(IndefiniteMatrixError,
                       match=r"\(p, Ap\) = 0 at iteration 0"):
        th.HostCGSolver(A).solve(b, criteria=TCrit(maxits=10,
                                                   residual_rtol=1e-12))
    from acg_tpu.errors import IndefiniteMatrixError as JInd
    with pytest.raises(JInd, match=r"\(p, Ap\) = 0 at iteration 0"):
        jh.HostCGSolver(A).solve(b, criteria=JCrit(maxits=10,
                                                   residual_rtol=1e-12))
    jcsr, tcsr, b = _system("poisson")
    msgs = []
    for pkg, mod, csr in (("jax", jh, jcsr), ("torch", th, tcsr)):
        with pytest.raises(Exception) as e:
            mod.HostCGSolver(csr).solve(
                b, criteria=_crit(pkg, maxits=3, residual_rtol=1e-14))
        msgs.append(str(e.value))
    assert isinstance(e.value, NotConvergedError)
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("hook", [dict(trace=-8), dict(progress=-10),
                                  dict(recovery=object()),
                                  dict(health=object()),
                                  dict(ckpt=object())])
def test_host_cg_refuses_hooks_of_later_modules(hook):
    """trace and progress, ported with the observability modules, refuse
    only a negative count; recovery, health and ckpt, ported with the
    robustness modules, refuse only an object of the wrong type."""
    _, tcsr, _ = _system("poisson")
    name = next(iter(hook))
    match = ("trace/progress must be >= 0" if name in ("trace", "progress")
             else f"{name} must be an acg_tpu_torch")
    with pytest.raises(ValueError, match=match):
        th.HostCGSolver(tcsr, **hook)


def test_pvector_matches_reference():
    from acg_tpu.vector import PVector as JV
    from acg_tpu_torch.vector import PVector as TV

    rng = np.random.default_rng(1)
    d = rng.standard_normal(12)
    jv, tv = JV(d.copy(), 3), TV(d.copy(), 3)
    for v in (jv, tv):
        v.axpy(0.5, v.__class__(d[::-1].copy(), 3))
        v.aypx(-2.0, v.__class__(d.copy(), 3))
        v.scal(1.5)
    assert np.array_equal(jv.data, tv.data)
    assert jv.dot(jv) == tv.dot(tv) and jv.nrm2() == tv.nrm2()
    assert tv.num_owned == 9 and np.array_equal(tv.gather([0, 11]),
                                                tv.data[[0, 11]])
