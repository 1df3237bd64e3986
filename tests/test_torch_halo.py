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


# -- across processes: 2 gloo ranks on the CPU ---------------------------

_RANKS_CHILD = r"""
import json
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from acg_tpu_torch.io.generators import poisson2d_coo
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel import mesh, multihost
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.parallel.halo import halo_exchange, halo_exchange_ranks
from acg_tpu_torch.parallel.halo_dma import (halo_exchange_dma,
                                             halo_exchange_peer)
from acg_tpu_torch.parallel.reductions import make_ldot, make_rank_psum, psum
from acg_tpu_torch.partition import partition_rows, partition_rows_band
from acg_tpu_torch.solvers import StoppingCriteria

port, rank = int(sys.argv[1]), int(sys.argv[2])


def poisson(side):
    r, c, v, N = poisson2d_coo(side)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def topology(csr, kind, nparts, side):
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


cases = {}
band = poisson(16)
cases["band4"] = (band, partition_rows(band, 4, seed=0, method="band"), 4)
graph = poisson(20)
cases["graph8"] = (graph, partition_rows(graph, 8, seed=0), 8)
side = 24
topo = poisson(side)
for kind in ("line", "star", "clustered"):
    part = topology(topo, kind, 5, side)
    cases[kind] = (topo, part, int(part.max()) + 1)
ldot = make_ldot(torch.float64)
crit = StoppingCriteria(maxits=300, residual_rtol=1e-8)
ref = {}
for name, (csr, part, nparts) in cases.items():
    prob = DistributedProblem.build(csr, part, nparts)
    h = prob.halo.to("cpu")
    x = torch.from_numpy(prob.scatter(
        np.random.default_rng(11).standard_normal(prob.n)))
    scnt = torch.from_numpy(prob.neighbor_counts()[0])
    recv = torch.zeros((nparts, nparts, max(h.maxcnt, 1)),
                       dtype=torch.float64)
    xs = {}
    if name in ("line", "star", "clustered", "band4"):
        # the stacked solve of the same build a rank makes: its shape and
        # format decisions come from the global matrix (ELL for a
        # scattered partition), as in the reference's restricted builds
        full = DistributedProblem.build(csr, part, nparts,
                                        owned_parts=range(nparts))
        b = csr @ np.random.default_rng(7).standard_normal(prob.n)
        for comm in ("xla", "dma"):
            s = DistCGSolver(full, comm=comm, device="cpu")
            xs[comm] = s.solve(b, criteria=crit)
    ref[name] = (halo_exchange(x, h.send_idx, h.ghost_src),
                 halo_exchange_dma(x, h.send_idx, h.ghost_src,
                                   h.ghost_valid, scnt, recv),
                 psum(ldot(x, x)), x, xs)

multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
out = {}
for name, (csr, part, nparts) in cases.items():
    ranges = mesh.part_ranges(nparts, 2)
    lo, hi = ranges[rank]
    owned = mesh.owned_parts(nparts, rank, 2)
    prob = DistributedProblem.build(csr, part, nparts, owned_parts=owned)
    h = prob.halo.take(lo, hi).to("cpu")
    g_xla, g_dma, dot, x, xs = ref[name]
    xl = x[lo:hi].contiguous()
    scnt, rcnt = prob.neighbor_counts()
    cnt = scnt.copy()
    cnt[:, lo:hi] = rcnt[lo:hi].T
    recv = torch.zeros((hi - lo, nparts, max(prob.halo.maxcnt, 1)),
                       dtype=torch.float64)
    r_xla = halo_exchange_ranks(xl, h.send_idx, h.ghost_src, ranges, rank)
    r_dma = halo_exchange_peer(xl, h.send_idx, h.ghost_src, h.ghost_valid,
                               torch.from_numpy(cnt), recv, ranges, rank)
    r_dot = make_rank_psum([b_ - a_ for a_, b_ in ranges])(ldot(xl, xl))
    res = {"xla": torch.equal(r_xla, g_xla[lo:hi]),
           "dma": torch.equal(r_dma, g_dma[lo:hi]),
           "psum": bool(r_dot == dot)}
    if xs:
        b = csr @ np.random.default_rng(7).standard_normal(prob.n)
        for comm in ("xla", "dma"):
            s = DistCGSolver(prob, comm=comm, device="cpu")
            res["solve-" + comm] = bool(np.array_equal(
                s.solve(b, criteria=crit), xs[comm]))
    out[name] = res
# the counts gate on 8 parts, tests/test_halo_dma.py:30-163's planes
P, m = 8, 3
sb = torch.zeros((P, P, m), dtype=torch.float64)
for p in range(P):
    for q in range(P):
        sb[p, q] = 100 * p + 10 * q + torch.arange(m)
ranges = mesh.part_ranges(P, 2)
lo, hi = ranges[rank]
for name, dists in (("all_pairs", None), ("ring", (1,)),
                    ("distance2", (1, 2))):
    scnt = torch.zeros((P, P), dtype=torch.int32)
    for p in range(P):
        for d in dists or range(1, P):
            scnt[p, (p + d) % P] = m
            scnt[p, (p - d) % P] = m
    got = K.halo_put_peer_plain(sb[lo:hi].contiguous(), scnt,
                                torch.full((hi - lo, P, m), -1.0),
                                ranges, rank, gate_by_counts=dists is not None)
    ok = True
    for p in range(lo, hi):
        for q in range(P):
            want = (100 * q + 10 * p + torch.arange(m, dtype=torch.float64)
                    if q != p and scnt[q, p] > 0 else torch.full((m,), -1.0))
            ok = ok and torch.equal(got[p - lo, q], want)
    out[name] = {"gate": ok}
print("RESULT " + json.dumps(out))
multihost.shutdown()
"""


def _two_gloo_processes(code, timeout=120):
    """``python -c code PORT RANK`` as ranks 0 and 1 on the CPU; both
    killed on timeout.  Returns [(rc, stdout, stderr), ...]."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(port),
                               str(r)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.fixture(scope="module")
def across_ranks():
    import json
    res = _two_gloo_processes(_RANKS_CHILD)
    out = []
    for rc, so, se in res:
        assert rc == 0, se
        line = next(ln for ln in so.splitlines() if ln.startswith("RESULT "))
        out.append(json.loads(line[len("RESULT "):]))
    return out


@pytest.mark.parametrize("case", ["band4", "graph8", "line", "star",
                                  "clustered"])
def test_cross_rank_exchange_and_psum_are_the_stacked_tier(across_ranks,
                                                           case):
    """On 2 gloo processes, each rank's ghost vectors -- the xla
    transport's all_to_all_single and K6's plain peer form -- and the
    cross-rank psum of the per-part dots are the stacked tier's bits."""
    for res in across_ranks:
        assert res[case]["xla"] and res[case]["dma"] and res[case]["psum"]


@pytest.mark.parametrize("case", ["band4", "line", "star", "clustered"])
def test_cross_rank_solves_are_the_stacked_solves(across_ranks, case):
    """The topologies of tests/test_halo_dma.py:272 (and a band): the
    2-rank solve on each transport is the one-process solve of the same
    restricted build (owning every part), bitwise."""
    for res in across_ranks:
        assert res[case]["solve-xla"] and res[case]["solve-dma"]


@pytest.mark.parametrize("case", ["all_pairs", "ring", "distance2"])
def test_peer_gate_matches_jax_patterns(across_ranks, case):
    """The counts gate of K6's peer form, on the planes and patterns of
    tests/test_halo_dma.py:30-163: gated pairs receive the sender's
    window (100 q + 10 p + k), the others keep their values."""
    for res in across_ranks:
        assert res[case]["gate"]
