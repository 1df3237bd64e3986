"""The port's halo exchange on stacked parts against the JAX package's
mesh transports (the conftest's 8-device CPU mesh; the Pallas one-sided
exchange runs in interpret mode there, as tests/test_halo_dma.py runs
it).

Ghost vectors agree bitwise for both transports (``comm="xla"``: the
transpose of the send plane; ``comm="dma"``: kernel K6's plain version).
JAX's interpret mode ignores the count gate (``gate_by_counts = not
interpret``), so the raw receive plane of the port's dense mode is held
against JAX's default, and the port's gated mode against the ring and
distance-2 patterns of tests/test_halo_dma.py, where the gate is uniform
per rotation round and interpret mode can run it gated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from acg_tpu._platform import shard_map
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.parallel.halo import halo_exchange as jax_halo_exchange
from acg_tpu.parallel.halo_dma import _exchange as jax_exchange
from acg_tpu.parallel.halo_dma import halo_exchange_dma as jax_halo_dma
from acg_tpu.parallel.mesh import PARTS_AXIS, solve_mesh
from acg_tpu_torch.io.generators import poisson2d_coo
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.parallel.halo import halo_exchange
from acg_tpu_torch.parallel.halo_dma import dma_exchange, halo_exchange_dma
from acg_tpu_torch.partition import partition_rows, partition_rows_band
from acg_tpu_torch.solvers import StoppingCriteria

torch.set_num_threads(min(2, torch.get_num_threads()))

SPEC = P(PARTS_AXIS)


def _poisson(side):
    r, c, v, N = poisson2d_coo(side)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def _topology_partition(csr, kind, nparts, side):
    """tests/test_halo_dma.py's partitions with qualitatively different
    neighbour graphs: a chain of bands, a hub touching every spoke, a
    random scatter."""
    if kind == "line":
        return partition_rows_band(csr, nparts)
    if kind == "star":
        part = np.zeros((side, side), np.int32)
        c0, c1 = side // 4, 3 * side // 4
        part[: side // 2, : side // 2] = 1
        part[: side // 2, side // 2:] = 2
        part[side // 2:, : side // 2] = 3
        part[side // 2:, side // 2:] = min(4, nparts - 1)
        part[c0:c1, c0:c1] = 0
        return part.reshape(-1) % nparts
    return np.random.default_rng(0).integers(
        0, nparts, csr.shape[0]).astype(np.int32)


def _jax_ghosts(csr, part, nparts, x_global):
    """The ghost vectors of both JAX transports on the CPU mesh."""
    prob = JaxProblem.build(csr, part, nparts, dtype=jnp.float64)
    s = JaxDistCG(prob, comm="xla")
    _, _, _, _, sidx, gsrc, gval, scnt, rcnt = s.device_args(
        np.ones(prob.n))
    x = jax.device_put(prob.scatter(x_global),
                       jax.sharding.NamedSharding(s.mesh, SPEC))

    def body(sidx, gsrc, gval, scnt, rcnt, x):
        sidx, gsrc, gval, scnt, rcnt, x = (
            a[0] for a in (sidx, gsrc, gval, scnt, rcnt, x))
        g_dma = jax_halo_dma(x, sidx, gsrc, gval, scnt, rcnt, PARTS_AXIS,
                             interpret=True)
        g_xla = jax_halo_exchange(x, sidx, gsrc, PARTS_AXIS)
        return g_dma[None], g_xla[None]

    f = jax.jit(shard_map(body, mesh=s.mesh, in_specs=(SPEC,) * 6,
                          out_specs=(SPEC, SPEC)))
    g_dma, g_xla = f(sidx, gsrc, gval, scnt, rcnt, x)
    return {"dma": np.asarray(g_dma), "xla": np.asarray(g_xla)}


def _port_ghosts(csr, part, nparts, x_global):
    prob = DistributedProblem.build(csr, part, nparts)
    halo = prob.halo.to("cpu")
    x = torch.from_numpy(prob.scatter(x_global))
    scnt = torch.from_numpy(prob.neighbor_counts()[0])
    recv = torch.zeros((nparts, nparts, max(halo.maxcnt, 1)),
                       dtype=torch.float64)
    g_xla = halo_exchange(x, halo.send_idx, halo.ghost_src)
    g_dma = halo_exchange_dma(x, halo.send_idx, halo.ghost_src,
                              halo.ghost_valid, scnt, recv)
    return prob, {"dma": g_dma.numpy(), "xla": g_xla.numpy()}


@pytest.mark.parametrize("nparts", [2, 4, 8])
def test_ghost_vectors_match_jax(nparts):
    csr = _poisson(20)
    part = partition_rows(csr, nparts, seed=0, use_metis="never")
    xg = np.random.default_rng(nparts).standard_normal(csr.shape[0])
    want = _jax_ghosts(csr, part, nparts, xg)
    prob, got = _port_ghosts(csr, part, nparts, xg)
    for comm in ("xla", "dma"):
        np.testing.assert_array_equal(got[comm], want[comm], err_msg=comm)
    # and they are the host plan's ghosts
    for p, s in enumerate(prob.subs):
        np.testing.assert_array_equal(got["dma"][p, : s.nghost],
                                      xg[s.global_ids[s.nowned:]])


@pytest.mark.parametrize("kind", ["line", "star", "clustered"])
def test_ghost_vectors_match_jax_topologies(kind):
    side = 24
    csr = _poisson(side)
    part = _topology_partition(csr, kind, 5, side)
    nparts = int(part.max()) + 1
    xg = np.random.default_rng(7).standard_normal(csr.shape[0])
    want = _jax_ghosts(csr, part, nparts, xg)
    _, got = _port_ghosts(csr, part, nparts, xg)
    for comm in ("xla", "dma"):
        np.testing.assert_array_equal(got[comm], want[comm], err_msg=comm)


def _plane(nparts, maxcnt):
    sb = np.zeros((nparts, nparts, maxcnt), np.float32)
    for p in range(nparts):
        for q in range(nparts):
            sb[p, q] = 100 * p + 10 * q + np.arange(maxcnt)
    return sb


def _jax_raw(sb, scnt, gate):
    nparts = sb.shape[0]
    mesh = solve_mesh(nparts)

    def body(sbuf, sc, rc):
        return jax_exchange(sbuf[0], sc[0], rc[0], PARTS_AXIS, True,
                            gate_by_counts=gate)[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(SPEC,) * 3,
                          out_specs=SPEC))
    return np.asarray(f(jnp.asarray(sb), jnp.asarray(scnt),
                        jnp.asarray(scnt.T.copy())))


@pytest.mark.parametrize("nparts", [4, 8])
def test_dense_receive_plane_matches_jax_interpret(nparts):
    """The port's dense mode against JAX's interpret default: every
    off-diagonal row arrives, whatever the counts say."""
    sb = _plane(nparts, 3)
    scnt = np.zeros((nparts, nparts), np.int32)
    scnt[0, 1] = 3   # the counts do not gate either side here
    want = _jax_raw(sb, scnt, None)
    got = dma_exchange(torch.from_numpy(sb), torch.from_numpy(scnt),
                       torch.from_numpy(scnt.T.copy()),
                       gate_by_counts=False).numpy()
    off = ~np.eye(nparts, dtype=bool)
    np.testing.assert_array_equal(got[off], want[off])
    assert not got[~off].any()   # the diagonal row is never written


@pytest.mark.parametrize("distances", [(1,), (1, 2)])
def test_gated_receive_plane_matches_jax_ring(distances):
    """Gated puts on tests/test_halo_dma.py's ring and distance-2
    patterns: real neighbours' rows match JAX's gated interpret kernel,
    every other row of the zeroed receive plane stays zero."""
    nparts = 8 if len(distances) > 1 else 4
    sb = _plane(nparts, 3)
    scnt = np.zeros((nparts, nparts), np.int32)
    for p in range(nparts):
        for d in distances:
            scnt[p, (p + d) % nparts] = 3
            scnt[p, (p - d) % nparts] = 3
    want = _jax_raw(sb, scnt, True)
    got = dma_exchange(torch.from_numpy(sb), torch.from_numpy(scnt),
                       torch.from_numpy(scnt.T.copy())).numpy()
    gated = scnt.T > 0
    np.testing.assert_array_equal(got[gated], want[gated])
    assert not got[~gated].any()
    assert K.launches["halo_put"] == 0   # CPU: the plain version


def test_dma_exchange_checks_counts_and_single_part():
    sb = torch.from_numpy(_plane(4, 2))
    scnt = torch.ones((4, 4), dtype=torch.int32)
    scnt[0, 1] = 0
    with pytest.raises(ValueError, match="transposed"):
        dma_exchange(sb, scnt, scnt)
    one = torch.ones((1, 1, 5))
    c1 = torch.ones((1, 1), dtype=torch.int32)
    assert not dma_exchange(one, c1, c1).any()   # JAX: zeros for 1 part


def test_transports_give_bitwise_equal_solves():
    """Both transports move the same bits: a dma solve and an xla solve
    take the same iterations to the same x, on every topology."""
    side = 24
    csr = _poisson(side)
    b = csr @ np.random.default_rng(3).standard_normal(csr.shape[0])
    crit = StoppingCriteria(maxits=400, residual_rtol=1e-9)
    for kind in ("line", "star", "clustered"):
        part = _topology_partition(csr, kind, 5, side)
        prob = DistributedProblem.build(csr, part, int(part.max()) + 1)
        xs = []
        for comm in ("xla", "dma"):
            s = DistCGSolver(prob, comm=comm, device="cpu")
            xs.append((s.solve(b, criteria=crit), s.stats.niterations))
        assert xs[0][1] == xs[1][1]
        np.testing.assert_array_equal(xs[0][0], xs[1][0])
