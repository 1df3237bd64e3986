"""The port's multi-part tier (stacked parts on one device, here the CPU)
against the JAX package's mesh tier (the conftest's 8-device CPU mesh).

Host build parity is bitwise: the partition vectors, the subdomains and
their halo plans, the stacked local blocks in all three formats, the
ghost blocks and the neighbour counts.  Solver parity: f64 solves take
the same number of iterations and agree to 1e-10 relative (the per-part
dots sum in another order than XLA's, and XLA:CPU contracts
multiply-adds); f32 within 2 iterations and the JAX f32 tests' bounds.
The port's ``kernels="pallas"`` runs the kernels' plain versions on the
CPU (K1 batched over parts, K5, and K6 under ``comm="dma"``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.graph import partition_matrix as jax_partition_matrix
from acg_tpu.graph import scatter_vector as jax_scatter_vector
from acg_tpu.io.generators import irregular_spd_coo as jax_irregular
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.spmv import dia_mv as jax_dia_mv
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.partition import edgecut as jax_edgecut
from acg_tpu.partition import partition_rows as jax_partition_rows
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.graph import (comm_matrix, gather_vector,
                                 partition_matrix, scatter_vector)
from acg_tpu_torch.io.generators import irregular_spd_coo, poisson_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel.dist import (COMM_ALIASES, DistCGSolver,
                                         DistributedProblem, resolve_comm)
from acg_tpu_torch.partition import edgecut, partition_rows
from acg_tpu_torch.solvers import StoppingCriteria

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"


def _poisson(n, dim):
    csr = SymCsrMatrix.from_mtx(poisson_mtx(n, dim=dim)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(n, dim=dim)).to_csr()
    assert (csr != jcsr).nnz == 0
    return csr


def _irregular(n, avg):
    r, c, v, N = irregular_spd_coo(n, avg_degree=avg, seed=0)
    jr, jc, jv, _ = jax_irregular(n, avg_degree=avg, seed=0)
    assert np.array_equal(r, jr) and np.array_equal(v, jv)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


@pytest.fixture(scope="module")
def mats():
    return {"p2d": _poisson(20, 2), "p3d": _poisson(7, 3),
            "irr": _irregular(1000, 6.0)}


def _manufactured(csr, seed=2):
    rng = np.random.default_rng(seed)
    xsol = rng.standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    return xsol, csr @ xsol


# -- host build ------------------------------------------------------------

@pytest.mark.parametrize("nparts", [2, 5, 8])
@pytest.mark.parametrize("method", ["band", "graph"])
@pytest.mark.parametrize("matrix", ["p2d", "p3d", "irr"])
def test_partition_rows_matches_jax(mats, matrix, method, nparts):
    csr = mats[matrix]
    part = partition_rows(csr, nparts, seed=3, method=method,
                          use_metis="never")
    jpart = jax_partition_rows(csr, nparts, seed=3, method=method,
                               use_metis="never")
    assert part.dtype == jpart.dtype
    np.testing.assert_array_equal(part, jpart)
    assert edgecut(csr, part) == jax_edgecut(csr, jpart)


def _same_subdomains(subs, jsubs):
    assert len(subs) == len(jsubs)
    for s, j in zip(subs, jsubs):
        assert (s.part, s.ninterior, s.nborder, s.nghost, s.owned_order) == \
            (j.part, j.ninterior, j.nborder, j.nghost, j.owned_order)
        np.testing.assert_array_equal(s.global_ids, j.global_ids)
        np.testing.assert_array_equal(s.ghost_owner, j.ghost_owner)
        for f in ("send_parts", "send_counts", "send_ptr", "send_idx",
                  "recv_parts", "recv_counts", "recv_ptr", "recv_idx"):
            a, b = getattr(s.halo, f), getattr(j.halo, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        for blk in ("A_local", "A_ghost"):
            a, b = getattr(s, blk), getattr(j, blk)
            assert a.shape == b.shape and (a != b).nnz == 0, blk


@pytest.mark.parametrize("matrix,method,nparts", [
    ("p2d", "graph", 4), ("p2d", "band", 8), ("p3d", "graph", 8),
    ("irr", "graph", 4)])
def test_subdomains_and_halo_plans_match_jax(mats, matrix, method, nparts):
    csr = mats[matrix]
    part = partition_rows(csr, nparts, seed=0, method=method,
                          use_metis="never")
    subs = partition_matrix(csr, part, nparts)
    jsubs = jax_partition_matrix(csr, part, nparts)
    _same_subdomains(subs, jsubs)
    x = np.random.default_rng(9).standard_normal(csr.shape[0])
    for a, b in zip(scatter_vector(subs, x, include_ghosts=True),
                    jax_scatter_vector(jsubs, x, include_ghosts=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        gather_vector(subs, scatter_vector(subs, x), csr.shape[0]), x)
    prob = DistributedProblem.build(csr, part, nparts, subs=subs)
    jprob = JaxProblem.build(csr, part, nparts, dtype=jnp.float64)
    _same_subdomains(prob.subs, jprob.subs)  # after the natural reorder
    np.testing.assert_array_equal(comm_matrix(subs, nparts),
                                  _jax_comm_matrix(jprob.subs, nparts))


def _jax_comm_matrix(subs, nparts):
    from acg_tpu.graph import comm_matrix as jcm
    return jcm(subs, nparts)


def _scatter_partition(csr, nparts):
    # a random scatter: local blocks no longer banded -> ELL
    return np.random.default_rng(0).integers(
        0, nparts, csr.shape[0]).astype(np.int32)


@pytest.mark.parametrize("fmt", ["dia", "ell", "binnedell"])
def test_stacked_build_matches_jax(mats, fmt):
    """The stacked local and ghost arrays, the padded halo plan and the
    neighbour counts of DistributedProblem.build, bitwise."""
    csr = mats["irr"] if fmt == "binnedell" else mats["p2d"]
    nparts = 4
    if fmt == "dia":
        part = partition_rows(csr, nparts, method="band")
    elif fmt == "ell":
        part = _scatter_partition(csr, nparts)
    else:
        part = partition_rows(csr, nparts, seed=0, method="graph",
                              use_metis="never")
    prob = DistributedProblem.build(csr, part, nparts)
    jprob = JaxProblem.build(csr, part, nparts, dtype=jnp.float64)
    assert prob.local.format == jprob.local.format == fmt
    assert prob.nmax_owned == jprob.nmax_owned
    assert prob.nnz_total == jprob.nnz_total
    loc, jloc = prob.local, jprob.local
    assert (loc.offsets, loc.nrows, loc.bin_ks) == \
        (jloc.offsets, jloc.nrows, jloc.bin_ks)
    if fmt == "dia":
        np.testing.assert_array_equal(loc.arrays[0], np.stack(jloc.arrays))
    else:
        import jax
        ours = jax.tree.leaves(loc.arrays)
        theirs = jax.tree.leaves(jloc.arrays)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))
    for f in ("rows", "data", "cols"):
        np.testing.assert_array_equal(getattr(prob.ghost, f),
                                      np.asarray(getattr(jprob.ghost, f)))
    assert prob.ghost.bmax == jprob.ghost.bmax
    for f in ("send_idx", "ghost_src", "ghost_valid"):
        np.testing.assert_array_equal(getattr(prob.halo, f),
                                      getattr(jprob.halo, f))
    assert (prob.halo.maxcnt, prob.halo.nmax_ghost) == \
        (jprob.halo.maxcnt, jprob.halo.nmax_ghost)
    for a, b in zip(prob.neighbor_counts(), jprob.neighbor_counts()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert prob.part_rows() == jprob.part_rows()
    x = np.random.default_rng(1).standard_normal(csr.shape[0])
    np.testing.assert_array_equal(prob.scatter(x), jprob.scatter(x))
    np.testing.assert_array_equal(prob.gather(prob.scatter(x)), x)


def test_batched_dia_plain_matches_jax_per_part(mats):
    """Kernel K1 batched over parts (its plain version on the CPU) is the
    JAX dia_mv of every shard, each part with its own edges."""
    csr = mats["p2d"]
    prob = DistributedProblem.build(csr, partition_rows(csr, 4, method="band"),
                                    4)
    planes = prob.local.arrays[0]
    offs = prob.local.offsets
    x = np.random.default_rng(5).standard_normal((4, prob.nmax_owned))
    x[2, 7] = np.inf   # a non-finite entry stays in its own part
    y = K.dia_spmv(torch.from_numpy(planes), offs, torch.from_numpy(x))
    assert K.launches["dia_spmv_batched"] == 0  # CPU: plain, not counted
    for p in range(4):
        want = jax_dia_mv(tuple(jnp.asarray(planes[d, p])
                                for d in range(len(offs))), offs,
                          prob.nmax_owned, jnp.asarray(x[p]))
        np.testing.assert_array_equal(y[p].numpy(), np.asarray(want))
    assert np.isfinite(y[[0, 1, 3]].numpy()).all()


# -- solver parity -----------------------------------------------------------

_JAX_CACHE = {}


def _jax_solve(csr, part, nparts, pipelined, b, crit, dtype=jnp.float64):
    key = (csr.shape[0], nparts, pipelined, str(dtype), crit.maxits,
           crit.residual_rtol, part.tobytes())
    if key not in _JAX_CACHE:
        prob = JaxProblem.build(csr, part, nparts, dtype=dtype)
        s = JaxDistCG(prob, pipelined=pipelined)
        x = s.solve(b, criteria=JaxCrit(maxits=crit.maxits,
                                        residual_rtol=crit.residual_rtol))
        _JAX_CACHE[key] = (np.asarray(x, np.float64), s.stats)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("comm,kernels", [("xla", "xla"), ("dma", "pallas")])
@pytest.mark.parametrize("nparts,method", [(2, "band"), (8, "graph")])
@pytest.mark.parametrize("pipelined", [False, True])
def test_f64_solve_matches_jax(mats, pipelined, nparts, method, comm,
                               kernels):
    csr = mats["p2d"]
    _, b = _manufactured(csr)
    part = partition_rows(csr, nparts, seed=1, method=method,
                          use_metis="never")
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-10)
    xj, jst = _jax_solve(csr, part, nparts, pipelined, b, crit)
    prob = DistributedProblem.build(csr, part, nparts)
    T = DistCGSolver(prob, pipelined=pipelined, comm=comm, kernels=kernels,
                     device=CPU)
    assert T.kernels == {"xla": "xla", "pallas": "pallas-plain"}[kernels]
    xt = T.solve(b, criteria=crit)
    assert T.stats.converged and jst.converged
    assert T.stats.niterations == jst.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    assert T.stats.r0nrm2 == pytest.approx(jst.r0nrm2, rel=1e-14)


def test_3d_and_binned_ell_solves_match_jax(mats):
    for key, nparts in (("p3d", 8), ("irr", 4)):
        csr = mats[key]
        _, b = _manufactured(csr, seed=3)
        part = partition_rows(csr, nparts, seed=2, use_metis="never")
        crit = StoppingCriteria(maxits=2000, residual_rtol=1e-9)
        xj, jst = _jax_solve(csr, part, nparts, False, b, crit)
        T = DistCGSolver(DistributedProblem.build(csr, part, nparts),
                         comm="dma", device=CPU)
        xt = T.solve(b, criteria=crit)
        assert T.stats.niterations == jst.niterations
        assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


def _with_hubs(csr, hubs=(10, 1600), width=700):
    """``csr`` plus symmetric couplings from each hub row h to the
    ``width`` rows after it, kept diagonally dominant: rows wider than
    the widest binned-ELL bin (512) that a band partition keeps local,
    so they land in the stacked block's hub tail."""
    import scipy.sparse as sp

    n = csr.shape[0]
    r, c = [], []
    for h in hubs:
        nb = np.arange(h + 1, h + 1 + width)
        r += [np.full(width, h), nb]
        c += [nb, np.full(width, h)]
    r, c = np.concatenate(r), np.concatenate(c)
    H = sp.csr_matrix((np.full(r.size, -0.01), (r, c)), shape=(n, n))
    return (csr + H + sp.diags(np.asarray(abs(H).sum(axis=1)).ravel())
            ).tocsr()


@pytest.mark.parametrize("comm", ["xla", "dma"])
def test_hub_rows_spmv_and_solve_match(comm):
    """Hub rows of the binned-ELL tail: the stacked SpMV is the global
    product, and a classic solve takes JAX's iterations to 1e-10."""
    csr = _with_hubs(_irregular(3000, 6.0))
    part = partition_rows(csr, 4, method="band")
    prob = DistributedProblem.build(csr, part, 4)
    assert prob.local.format == "binnedell"
    assert (prob.local.arrays[3] < prob.nmax_owned).sum() > 1000
    T = DistCGSolver(prob, comm=comm, device=CPU)
    x = np.random.default_rng(4).standard_normal(csr.shape[0])
    y = T._spmv()(torch.from_numpy(prob.scatter(x)))
    np.testing.assert_allclose(prob.gather(y.numpy()), csr @ x, rtol=1e-12,
                               atol=1e-12)
    pad = np.arange(prob.nmax_owned) >= np.array(prob.part_rows())[:, None]
    assert not y.numpy()[pad].any()   # padding rows stay 0
    _, b = _manufactured(csr, seed=3)
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-10)
    xj, jst = _jax_solve(csr, part, 4, False, b, crit)
    xt = T.solve(b, criteria=crit)
    assert T.stats.converged and T.stats.niterations == jst.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


@pytest.mark.parametrize("pipelined", [False, True])
def test_f32_tracks_jax(mats, pipelined):
    """tests/test_torch_cg.py's f32 bounds, on 4 graph parts."""
    csr = mats["p2d"]
    xsol, b = _manufactured(csr, seed=3)
    b = b.astype(np.float32)
    part = partition_rows(csr, 4, seed=0, use_metis="never")
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-4)
    xj, jst = _jax_solve(csr, part, 4, pipelined, b, crit, jnp.float32)
    T = DistCGSolver(DistributedProblem.build(csr, part, 4,
                                              dtype=torch.float32),
                     pipelined=pipelined, comm="dma", kernels="pallas",
                     device=CPU)
    xt = T.solve(b, criteria=crit)
    assert T.stats.converged
    assert np.linalg.norm(xt - xsol) < 1e-2
    assert abs(T.stats.niterations - jst.niterations) <= 2
    assert np.linalg.norm(xt - xj) < 1e-3


def test_maxits_stats_match_jax(mats):
    """tests/test_dist_cg.py::test_dist_cg_maxits_only's counts (17
    iterations: 18 halo exchanges, 34 allreduces), and every op row of
    the stats block equal to the JAX tier's."""
    csr = mats["p2d"]
    part = partition_rows(csr, 4, seed=3, use_metis="never")
    b = np.ones(csr.shape[0])
    crit = StoppingCriteria(maxits=17)
    _, jst = _jax_solve(csr, part, 4, False, b, crit)
    T = DistCGSolver(DistributedProblem.build(csr, part, 4), device=CPU)
    T.solve(b, criteria=crit)
    st = T.stats
    assert st.niterations == 17 and st.converged
    assert st.ops["halo"].n == 18 and st.ops["allreduce"].n == 34
    for op, o in st.ops.items():
        assert (o.n, o.bytes) == (jst.ops[op].n, jst.ops[op].bytes), op
    assert st.nflops == pytest.approx(jst.nflops, rel=1e-15)
    assert "MPI_HaloExchange: " in st.fwrite()


@pytest.mark.parametrize("pipelined,comm,kernels", [
    (False, "xla", "xla"), (True, "dma", "pallas")])
def test_padding_rows_stay_zero(mats, pipelined, comm, kernels):
    """Parts of very different sizes (n/8, 3n/8, n/2): every padding row
    of the stacked solution is exactly 0.0 after the solve."""
    csr = mats["p2d"]
    n = csr.shape[0]
    part = np.zeros(n, dtype=np.int32)
    part[n // 8:] = 1
    part[n // 2:] = 2
    prob = DistributedProblem.build(csr, part, 3)
    xsol, b = _manufactured(csr, seed=4)
    T = DistCGSolver(prob, pipelined=pipelined, comm=comm, kernels=kernels,
                     device=CPU)
    x = T.solve(b, criteria=StoppingCriteria(maxits=3000,
                                             residual_rtol=1e-9),
                host_result=False)
    assert x.shape == (3, prob.nmax_owned)
    for p, rows in enumerate(prob.part_rows()):
        assert rows < prob.nmax_owned or p == 2
        assert torch.all(x[p, rows:] == 0.0)
    assert np.linalg.norm(prob.gather(x.numpy()) - xsol) < 1e-6


# options ported since this test was written, with the combination each
# still refuses (on bf16 vectors, the replacement tier's), as the JAX
# tier does: the message names the option
_STILL_REFUSED = {"precond": {"replace_every": 4},
                  "precise_dots": {"replace_every": 4},
                  "trace": {"replace_every": 4},
                  "progress": {"replace_every": 4},
                  "algorithm": {"pipelined": True},
                  "kernels": {"precise_dots": True}}


@pytest.mark.parametrize("option,value", [
    ("precond", "jacobi"), ("health", object()), ("ckpt", object()),
    ("recovery", object()), ("trace", 8), ("progress", 10),
    ("replace_every", 4), ("algorithm", "sstep:2"), ("precise_dots", True),
    ("kernels", "fused"), ("comm", "nvshmem")])
def test_refused_options_raise(mats, option, value):
    csr = mats["p2d"]
    extra = _STILL_REFUSED.get(option, {})
    prob = DistributedProblem.build(
        csr, partition_rows(csr, 2, method="band"), 2,
        dtype=torch.bfloat16 if extra else torch.float64)
    name = "transport" if option == "comm" else option
    with pytest.raises(ValueError, match=name):
        DistCGSolver(prob, device=CPU, **{option: value}, **extra)


def test_comm_aliases():
    assert COMM_ALIASES == {"mpi": "xla", "nccl": "xla", "nvshmem": "dma"}
    assert [resolve_comm(c) for c in ("none", "xla", "dma", "mpi", "nccl",
                                      "nvshmem")] == \
        ["xla", "xla", "dma", "xla", "xla", "dma"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_single_part_solve_matches_jax(mats, pipelined):
    """One part: no ghosts, no exchange -- the JAX tier's single-shard
    program, the same iterations and x."""
    csr = mats["p2d"]
    _, b = _manufactured(csr, seed=5)
    part = np.zeros(csr.shape[0], dtype=np.int32)
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-10)
    xj, jst = _jax_solve(csr, part, 1, pipelined, b, crit)
    prob = DistributedProblem.build(csr, part, 1)
    assert not prob.halo.has_ghosts
    T = DistCGSolver(prob, pipelined=pipelined, comm="dma", device=CPU)
    xt = T.solve(b, criteria=crit)
    assert T.stats.niterations == jst.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    assert T.stats.ops["halo"].n == jst.ops["halo"].n
