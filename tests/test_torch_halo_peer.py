"""The schedule of K6's cross-process form (``acg_tpu_torch.parallel.
halo_dma.peer_schedule``): which flag and ack words each rank writes and
waits on around its put, held against the rows the JAX package's
exchange writes and the rows the port's plain cross-process version
writes, and run through a simulation of the ranks' streams.

On the card the schedule becomes stream memory operations (``csrc/
halo_put.cu``: ``acg_memops``); here it is plain data.  JAX's
``_exchange`` runs in interpret mode on the conftest's 8-device CPU mesh,
as tests/test_halo_dma.py runs it: rows no put writes hold NaN there, so
the written rows are the ones that are not NaN.  Interpret mode ignores
the count gate unless asked (``gate_by_counts = not interpret``), so
all-pairs runs its default and the ring and distance-2 patterns of
tests/test_halo_dma.py:30-163 (uniform per rotation round) run gated.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from acg_tpu._platform import shard_map
from acg_tpu.parallel.halo_dma import _exchange as jax_exchange
from acg_tpu.parallel.mesh import PARTS_AXIS, solve_mesh
from acg_tpu_torch.io.generators import poisson2d_coo
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel import halo as port_halo
from acg_tpu_torch.parallel.dist import DistributedProblem
from acg_tpu_torch.parallel.halo_dma import peer_schedule
from acg_tpu_torch.parallel.mesh import part_ranges
from acg_tpu_torch.partition import partition_rows

SPEC = P(PARTS_AXIS)


def _pattern(kind, nparts, maxcnt=3):
    """tests/test_halo_dma.py's count patterns: (counts, gate)."""
    scnt = np.zeros((nparts, nparts), np.int32)
    if kind == "all_pairs":
        scnt[:] = maxcnt
        return scnt, None          # interpret mode's default: no gate
    dists = (1,) if kind == "ring" else (1, 2)
    for p in range(nparts):
        for d in dists:
            scnt[p, (p + d) % nparts] = maxcnt
            scnt[p, (p - d) % nparts] = maxcnt
    return scnt, True


def _jax_written(scnt, gate, maxcnt=3):
    """{(p, q)}: the rows q of p's receive plane that JAX's exchange
    writes in interpret mode, checked to hold q's window for p."""
    nparts = scnt.shape[0]
    sb = np.zeros((nparts, nparts, maxcnt), np.float32)
    for q in range(nparts):
        for p in range(nparts):
            sb[q, p] = 1 + 100 * q + 10 * p + np.arange(maxcnt)
    mesh = solve_mesh(nparts)

    def body(sbuf, sc, rc):
        return jax_exchange(sbuf[0], sc[0], rc[0], PARTS_AXIS, True,
                            gate_by_counts=gate)[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(SPEC,) * 3,
                          out_specs=SPEC))
    out = np.asarray(f(jnp.asarray(sb), jnp.asarray(scnt),
                       jnp.asarray(scnt.T.copy())))
    written = set()
    for p in range(nparts):
        for q in range(nparts):
            if not np.isnan(out[p, q]).any():
                np.testing.assert_array_equal(out[p, q], sb[q, p])
                written.add((p, q))
    return written


def _owner(ranges, nparts):
    own = np.empty(nparts, dtype=np.int64)
    for r, (a, b) in enumerate(ranges):
        own[a:b] = r
    return own


def _schedule_matches(written, scnt, ranges, gate):
    """Every rank's schedule, at the first exchanges and in the steady
    state, names exactly the written rows that cross ranks: q's owner
    flags (p, q) and p's owner waits on it; p's owner acks (q, p) and
    q's owner waits on the ack before the plane comes round again.  Rows
    within one rank have no word (the stream orders them)."""
    nparts = scnt.shape[0]
    own = _owner(ranges, nparts)
    cross = {(p, q) for p, q in written if own[p] != own[q]}
    for seq in (1, 2, 3, 8):
        got = {k: set() for k in ("flag-write", "flag-wait", "ack-write",
                                  "ack-wait")}
        for rank in range(len(ranges)):
            pre, post = peer_schedule(scnt, ranges, rank, seq, gate=gate)
            # waits come after the writes of their list, as the stream
            # runs them
            for ops in (pre, post):
                kinds = [op for op, _, _ in ops]
                assert kinds == sorted(kinds, key=("write", "wait").index)
            for op, (kind, a, b), value in pre + post:
                pair = (a, b) if kind == "flag" else (b, a)   # (p, q)
                if kind == "flag":
                    assert value == seq
                    assert own[pair[1] if op == "write" else pair[0]] == rank
                else:
                    assert value == (seq - 1 if op == "write" else seq - 2)
                    assert own[pair[0] if op == "write" else pair[1]] == rank
                got[f"{kind}-{op}"].add(pair)
        assert got["flag-write"] == cross and got["flag-wait"] == cross
        assert got["ack-write"] == (cross if seq >= 2 else set())
        assert got["ack-wait"] == (cross if seq >= 3 else set())


@pytest.mark.parametrize("nranks", [2, 3])
@pytest.mark.parametrize("kind", ["all_pairs", "ring", "distance2"])
def test_schedule_covers_jax_written_rows(kind, nranks):
    """The schedule against the rows JAX's exchange writes in interpret
    mode, on tests/test_halo_dma.py's patterns, split over 2 and 3
    ranks."""
    nparts = 8 if kind == "distance2" else 4
    scnt, gate = _pattern(kind, nparts)
    written = _jax_written(scnt, gate)
    if kind == "all_pairs":
        assert written == {(p, q) for p in range(nparts)
                           for q in range(nparts) if p != q}
    _schedule_matches(written, scnt, part_ranges(nparts, nranks),
                      gate is not None)


def _irregular_counts(nparts=6):
    r, c, v, N = poisson2d_coo(24)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    prob = DistributedProblem.build(csr, partition_rows(
        csr, nparts, seed=0), nparts)
    return prob.neighbor_counts()[0], prob.halo.maxcnt


def _plain_written(scnt, ranges, maxcnt, gate, monkeypatch):
    """{(p, q)}: the rows each rank's plain cross-process K6 writes, with
    the collective it calls (``transpose_ranks``) served in-process from
    the whole send plane."""
    nparts = scnt.shape[0]
    full = torch.arange(nparts * nparts * maxcnt,
                        dtype=torch.float64).reshape(nparts, nparts,
                                                     maxcnt) + 1

    def transpose_ranks(send, rngs, rank):
        lo, hi = rngs[rank]
        return full.transpose(0, 1)[lo:hi].contiguous()

    monkeypatch.setattr(port_halo, "transpose_ranks", transpose_ranks)
    written = set()
    for rank, (lo, hi) in enumerate(ranges):
        recv = torch.full((hi - lo, nparts, maxcnt), float("nan"),
                          dtype=torch.float64)
        out = K.halo_put_peer(full[lo:hi].clone(), torch.from_numpy(scnt),
                              recv, ranges, rank, gate_by_counts=gate)
        assert out is recv
        for p in range(lo, hi):
            for q in range(nparts):
                if not torch.isnan(out[p - lo, q]).any():
                    assert torch.equal(out[p - lo, q], full[q, p])
                    written.add((p, q))
    return written


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("nranks", [2, 3])
def test_schedule_covers_plain_written_rows(nranks, gate, monkeypatch):
    """The schedule against the gated rows of ``halo_put_peer_plain`` on
    an irregular plan (6 graph parts of a 24x24 Poisson), gated and
    dense, split over 2 and 3 ranks."""
    scnt, maxcnt = _irregular_counts()
    nparts = scnt.shape[0]
    ranges = part_ranges(nparts, nranks)
    written = _plain_written(scnt, ranges, maxcnt, gate, monkeypatch)
    moves = ~np.eye(nparts, dtype=bool) & ((scnt > 0) if gate else True)
    assert written == {(p, q) for q in range(nparts) for p in range(nparts)
                       if moves[q, p]}
    if gate:
        assert len(written) < nparts * (nparts - 1)   # the gate bites
    _schedule_matches(written, scnt, ranges, gate)


# -- the ranks' streams, simulated ----------------------------------------

def _simulate(scnt, ranges, gate, nexch, seed, schedule=peer_schedule):
    """Run every rank's stream -- per exchange its pre operations, the
    put, its post operations and the unpack -- in a random interleaving
    in which a wait blocks until its word is >= its value.  Returns the
    first violation found, or None: a put into a plane whose previous
    exchange its receiver has not unpacked, an unpack of a row the
    exchange's put has not written, or a deadlock."""
    nparts = scnt.shape[0]
    moves = ~np.eye(nparts, dtype=bool)
    if gate:
        moves &= scnt > 0
    own = _owner(ranges, nparts)
    progs = []
    for rank in range(len(ranges)):
        prog = []
        for seq in range(1, nexch + 1):
            pre, post = schedule(scnt, ranges, rank, seq, gate)
            prog += pre + [("put", None, seq)] + post + [("unpack", None,
                                                         seq)]
        progs.append(prog)
    words: dict = {}
    plane: dict = {}        # (p, parity, q) -> the exchange that wrote it
    unpacked = [0] * len(ranges)
    pcs = [0] * len(ranges)
    rng = random.Random(seed)
    while any(pc < len(prog) for pc, prog in zip(pcs, progs)):
        ready = []
        for r, prog in enumerate(progs):
            if pcs[r] == len(prog):
                continue
            op, word, value = prog[pcs[r]]
            if op != "wait" or words.get(word, 0) >= value:
                ready.append(r)
        if not ready:
            return "deadlock"
        r = rng.choice(ready)
        op, word, value = progs[r][pcs[r]]
        pcs[r] += 1
        lo, hi = ranges[r]
        if op == "write":
            words[word] = value
        elif op == "put":
            for q in range(lo, hi):
                for p in range(nparts):
                    if moves[q, p]:
                        if unpacked[own[p]] < value - 2:
                            return (f"exchange {value} put {q} -> {p} before "
                                    f"exchange {value - 2} was unpacked")
                        plane[(p, value % 2, q)] = value
        elif op == "unpack":
            for p in range(lo, hi):
                for q in range(nparts):
                    if moves[q, p] and plane.get((p, value % 2, q)) != value:
                        return (f"exchange {value} unpacked {q} -> {p} "
                                f"before its put")
            unpacked[r] = value
    return None


def _one_way_counts(nparts, seed):
    rng = np.random.default_rng(seed)
    scnt = rng.integers(0, 3, (nparts, nparts)).astype(np.int32)
    np.fill_diagonal(scnt, 0)
    return scnt


@pytest.mark.parametrize("nranks", [2, 3])
@pytest.mark.parametrize("case", ["ring", "all_pairs", "one_way", "irregular"])
def test_schedule_orders_every_interleaving(case, nranks):
    """No put lands in a plane before its receiver unpacked the exchange
    that last used it (two in a row never touch one plane before its
    ack), no unpack reads a row before its put, and no interleaving of
    the ranks' streams deadlocks: 6 exchanges, 40 random interleavings,
    counts gated one way for some pairs."""
    if case == "irregular":
        scnt = _irregular_counts()[0]
    elif case == "one_way":
        scnt = _one_way_counts(5, 11)
        assert (scnt > 0).sum() != ((scnt > 0) & (scnt.T > 0)).sum()
    else:
        scnt = _pattern(case, 5)[0]
    ranges = part_ranges(scnt.shape[0], nranks)
    for seed in range(40):
        for gate in (True, False):
            assert _simulate(scnt, ranges, gate, 6, seed) is None, (seed,
                                                                    gate)


def _without_ack_waits(scnt, ranges, rank, seq, gate):
    pre, post = peer_schedule(scnt, ranges, rank, seq, gate)
    return [o for o in pre if o[0] != "wait"], post


def test_simulation_catches_a_plane_reused_before_its_ack():
    """The simulation has teeth: without the ack waits, a sender that
    no flag holds back (one-way gating) writes a plane its receiver has
    not unpacked yet, in some interleaving."""
    scnt = np.zeros((4, 4), np.int32)
    scnt[0, 2] = scnt[1, 3] = 1        # rank 0 sends, rank 1 never does
    ranges = part_ranges(4, 2)
    found = [_simulate(scnt, ranges, True, 6, seed, _without_ack_waits)
             for seed in range(40)]
    assert any(f and "before exchange" in f for f in found)
    assert all(_simulate(scnt, ranges, True, 6, seed) is None
               for seed in range(40))


def test_schedule_values_and_lists_are_pure():
    """The same arguments give the same lists; from exchange 3 on the
    lists are exchange 3's with every value shifted by seq - 3 (what
    PeerPlanes caches), and one rank alone has nothing to signal."""
    scnt = _one_way_counts(6, 5)
    ranges = part_ranges(6, 3)
    for rank in range(3):
        three = peer_schedule(scnt, ranges, rank, 3)
        assert three == peer_schedule(scnt, ranges, rank, 3)
        for seq in (4, 9, 1000):
            got = peer_schedule(scnt, ranges, rank, seq)
            for a, b in zip(three, got):
                assert [(op, w) for op, w, _ in a] == [(op, w)
                                                       for op, w, _ in b]
                assert [v + seq - 3 for _, _, v in a] == [v for _, _, v in b]
    assert peer_schedule(scnt, [(0, 6)], 0, 5) == ([], [])
