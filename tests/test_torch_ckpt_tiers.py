"""The CA recurrences' robustness on one device (checkpoints, fault
sites, the s-step audit), the sharded gen-direct tier's hooks and the
batched tiers' checkpoints, against the JAX package (tests/
test_checkpoint.py:224-361, tests/test_batched.py:280-360).

Chunked solves are held bitwise to the port's own uninterrupted ones;
iterations, restarts and audits to the reference's; refusals to the
reference's messages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu import checkpoint as jck
from acg_tpu import faults as jf
from acg_tpu.io.generators import aniso_poisson2d_coo as j_aniso
from acg_tpu.matrix import SymCsrMatrix as JSym
from acg_tpu.ops.spmv import device_matrix_from_csr as j_dev
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.resilience import RecoveryPolicy as JPolicy
from acg_tpu.solvers.stats import StoppingCriteria as JCrit
from acg_tpu_torch import checkpoint as ck
from acg_tpu_torch import faults
from acg_tpu_torch.errors import AcgError
from acg_tpu_torch.health import HealthSpec
from acg_tpu_torch.io.generators import aniso_poisson2d_coo, batched_rhs
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.parallel.dist_batched import BatchedDistCGSolver
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
from acg_tpu_torch.solvers.batched import BatchedCGSolver
from acg_tpu_torch.solvers.resilience import RecoveryPolicy

torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
CRIT = dict(maxits=2000, residual_rtol=1e-8)


@pytest.fixture(autouse=True)
def _disarmed():
    prev = os.environ.pop(faults.ENV_VAR, None)
    faults.install(None)
    jf.install(None)
    yield
    faults.install(None)
    jf.install(None)
    if prev is not None:
        os.environ[faults.ENV_VAR] = prev


@pytest.fixture(scope="module")
def system():
    """The ill-conditioned aniso family (p(l) restarts on it), both
    packages' assembly of it, and a random b."""
    r, c, v, N = aniso_poisson2d_coo(24, 0.1)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    jr, jc, jv, _ = j_aniso(24, 0.1)
    jcsr = JSym.from_coo(N, jr, jc, jv).to_csr()
    assert (csr != jcsr).nnz == 0
    b = csr @ np.random.default_rng(5).standard_normal(N)
    return csr, jcsr, b


@pytest.fixture(scope="module")
def poisson():
    """tests/test_checkpoint.py's system: Poisson 20^2 (no p(l) breakdown,
    so a chunked run replays no rollback)."""
    from acg_tpu.io.generators import poisson_mtx as j_poisson
    from acg_tpu_torch.io.generators import poisson_mtx
    csr = SymCsrMatrix.from_mtx(poisson_mtx(20, dim=2)).to_csr()
    jcsr = JSym.from_mtx(j_poisson(20, dim=2)).to_csr()
    xsol = np.random.default_rng(0).standard_normal(csr.shape[0])
    return csr, jcsr, csr @ (xsol / np.linalg.norm(xsol))


def _dev(csr):
    return device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)


# -- the CA recurrences: checkpoints -------------------------------------------

def test_ca_carry_names_match_the_reference():
    for kind in ("sstep", "pl"):
        assert ck.ca_carry_names(kind) == jck.ca_carry_names(kind)


@pytest.mark.parametrize("algorithm", ["sstep:4", "pipelined:2"])
def test_ca_chunk_parity_and_resume(poisson, tmp_path, algorithm):
    """The chunked CA solve is the uninterrupted one bit for bit (s-step
    snapshots at block boundaries, p(l) its whole working set), takes the
    reference's iterations, and --resume continues to the uninterrupted
    iteration count."""
    csr, jcsr, b = poisson
    ref = JaxCGSolver(j_dev(jcsr, dtype=jnp.float64), algorithm=algorithm)
    ref.solve(b, criteria=JCrit(**CRIT))
    solo = TorchCGSolver(_dev(csr), device=CPU, algorithm=algorithm)
    x0 = solo.solve(b, criteria=StoppingCriteria(**CRIT))
    p = str(tmp_path / "ck")
    s1 = TorchCGSolver(_dev(csr), device=CPU, algorithm=algorithm,
                       ckpt=ck.CheckpointConfig(path=p, every=16))
    x1 = s1.solve(b, criteria=StoppingCriteria(**CRIT))
    assert np.array_equal(x1, x0)
    assert s1.stats.niterations == solo.stats.niterations
    assert s1.stats.ckpt["snapshots"] >= 2
    assert solo.stats.niterations == ref.stats.niterations
    snap = ck.load_snapshot(p)
    assert snap.meta["algorithm"] == algorithm
    assert set(ck.ca_carry_names(algorithm.split(":")[0].replace(
        "pipelined", "pl"))) <= set(snap.arrays)
    s2 = TorchCGSolver(_dev(csr), device=CPU, algorithm=algorithm,
                       ckpt=ck.CheckpointConfig(resume=snap))
    x2 = s2.solve(b, criteria=StoppingCriteria(**CRIT))
    assert snap.iteration + s2.stats.niterations == solo.stats.niterations
    assert np.array_equal(x2, x0)
    assert s2.stats.ckpt["resumed_from"] == snap.iteration


def test_ca_snapshot_resumes_in_the_reference(system, tmp_path):
    """An s-step snapshot of the port resumes in the reference to its
    uninterrupted iteration count: the carry layout is the reference's."""
    csr, jcsr, b = system
    p = str(tmp_path / "ck")
    s1 = TorchCGSolver(_dev(csr), device=CPU, algorithm="sstep:4",
                       ckpt=ck.CheckpointConfig(path=p, every=16))
    s1.solve(b, criteria=StoppingCriteria(**CRIT))
    snap = jck.load_snapshot(p)
    j = JaxCGSolver(j_dev(jcsr, dtype=jnp.float64), algorithm="sstep:4",
                    ckpt=jck.CheckpointConfig(resume=snap))
    j.solve(b, criteria=JCrit(**CRIT))
    assert snap.iteration + j.stats.niterations == s1.stats.niterations


def test_ca_cross_recurrence_resume_refuses(system, tmp_path):
    csr, _, b = system
    p = str(tmp_path / "ck")
    TorchCGSolver(_dev(csr), device=CPU, algorithm="sstep:4",
                  ckpt=ck.CheckpointConfig(path=p, every=16)).solve(
        b, criteria=StoppingCriteria(**CRIT))
    snap = ck.load_snapshot(p)
    for other in ("pipelined:2", None):
        s = TorchCGSolver(_dev(csr), device=CPU, algorithm=other,
                          ckpt=ck.CheckpointConfig(resume=snap))
        with pytest.raises(AcgError, match="recurrence"):
            s.solve(b, criteria=StoppingCriteria(**CRIT))


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="sstep:4", ckpt="resume-repartition"), "repartition"),
    (dict(algorithm="pipelined:2", trace=8, ckpt="path"), "trace"),
    (dict(algorithm="pipelined:2", health="audit"), "no in-loop audit"),
    (dict(algorithm="sstep:4", health="abft"), "no checksum hook"),
    (dict(algorithm="sstep:4", trace=8, ckpt="path"), None),
    (dict(algorithm="pipelined:2", ckpt="path"), None),
    (dict(algorithm="sstep:4", health="audit"), None),
])
def test_ca_refusal_matrix_matches_the_reference(system, tmp_path, kw,
                                                 match):
    """What the CA carry or loops cannot honour refuses with the
    reference's message; the rest constructs in both packages."""
    from acg_tpu.health import HealthSpec as JHealth
    csr, jcsr, b = system
    p = str(tmp_path / "ck")
    TorchCGSolver(_dev(csr), device=CPU, ckpt=ck.CheckpointConfig(
        path=p, every=16)).solve(b, criteria=StoppingCriteria(**CRIT))

    def build(pkg):
        mod_ck, Health = (ck, HealthSpec) if pkg == "port" else \
            (jck, JHealth)
        o = dict(kw)
        if o.get("ckpt") == "path":
            o["ckpt"] = mod_ck.CheckpointConfig(path=p, every=16)
        elif o.get("ckpt") == "resume-repartition":
            o["ckpt"] = mod_ck.CheckpointConfig(
                resume=mod_ck.load_snapshot(p), repartition=True)
        if o.get("health"):
            o["health"] = Health(every=4, abft=o["health"] == "abft")
        if pkg == "port":
            return TorchCGSolver(_dev(csr), device=CPU, **o)
        return JaxCGSolver(j_dev(jcsr, dtype=jnp.float64), **o)

    if match is None:
        build("port")
        build("ref")
        return
    with pytest.raises(ValueError, match=match) as mine:
        build("port")
    with pytest.raises(ValueError) as theirs:
        build("ref")
    assert str(mine.value) == str(theirs.value)


# -- the CA recurrences: fault sites and the audit ----------------------------

@pytest.mark.parametrize("algorithm,spec", [
    ("sstep:4", "spmv:nan@8"), ("sstep:4", "dot:neg@5"),
    ("sstep:4", "spmv:inf@0"), ("pipelined:2", "spmv:inf@6"),
])
def test_ca_fault_sites_recover_like_the_reference(system, algorithm, spec):
    """A fault in an s-step loop breaks the attempt where the reference's
    does: the same breakdowns, restarts and iterations (the restart
    continues from the last finite iterate).  p(l), whose own square-root
    restarts land where rounding puts them, recovers on its default
    restart budget."""
    csr, jcsr, b = system
    crit = dict(CRIT, residual_rtol=1e-6)
    sstep = algorithm == "sstep:4"
    with jf.injected(spec):
        ref = JaxCGSolver(j_dev(jcsr, dtype=jnp.float64),
                          algorithm=algorithm,
                          recovery=JPolicy() if sstep else None)
        xj = np.asarray(ref.solve(b, criteria=JCrit(**crit)))
    with faults.injected(spec):
        port = TorchCGSolver(_dev(csr), device=CPU, algorithm=algorithm,
                             recovery=RecoveryPolicy() if sstep else None)
        x = port.solve(b, criteria=StoppingCriteria(**crit))
    assert port.stats.nbreakdowns >= 1
    if sstep:
        for key in ("nbreakdowns", "nrestarts", "niterations"):
            assert getattr(port.stats, key) == getattr(ref.stats, key), key
        assert np.linalg.norm(x - xj) <= 1e-6 * np.linalg.norm(xj)
    assert np.linalg.norm(b - csr @ x) <= 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("algorithm,spec,match", [
    ("sstep:4", "spmv:nan@5", "block boundaries"),
    ("pipelined:2", "dot:nan@5", r"no site in the p\(l\)"),
    ("sstep:4", "halo:nan@4", "halo fault injection needs"),
    ("sstep:4", "spmv:nan@4:part=1", "only part 0"),
])
def test_ca_fault_refusals_match_the_reference(system, algorithm, spec,
                                               match):
    csr, jcsr, b = system
    with faults.injected(spec):
        with pytest.raises(AcgError, match=match) as mine:
            TorchCGSolver(_dev(csr), device=CPU, algorithm=algorithm,
                          recovery=RecoveryPolicy()).solve(
                b, criteria=StoppingCriteria(**CRIT))
    with jf.injected(spec):
        with pytest.raises(Exception) as theirs:
            JaxCGSolver(j_dev(jcsr, dtype=jnp.float64),
                        algorithm=algorithm, recovery=JPolicy()).solve(
                b, criteria=JCrit(**CRIT))
    assert str(mine.value) == str(theirs.value)


def test_sstep_audit_matches_the_reference(system):
    """The s-step audit fires where a block crosses the cadence: the
    reference's audit count, and gaps at the rounding floor."""
    from acg_tpu.health import HealthSpec as JHealth
    csr, jcsr, b = system
    port = TorchCGSolver(_dev(csr), device=CPU, algorithm="sstep:4",
                         health=HealthSpec(every=10))
    port.solve(b, criteria=StoppingCriteria(**CRIT))
    ref = JaxCGSolver(j_dev(jcsr, dtype=jnp.float64), algorithm="sstep:4",
                      health=JHealth(every=10))
    ref.solve(b, criteria=JCrit(**CRIT))
    assert port.stats.health["naudits"] == ref.stats.health["naudits"] > 0
    assert port.stats.health["gap_max"] < 1e-8


# -- the sharded gen-direct tier's hooks ---------------------------------------

def test_sharded_chunk_parity_and_resume(tmp_path):
    """tests/test_checkpoint.py:342's case: the sharded tier's chunked
    solve is its unchunked one bit for bit under the tier name
    sharded-dia, and a resume continues to the same iteration count,
    which is the reference's."""
    from acg_tpu.parallel.sharded_dia import \
        build_sharded_poisson_solver as j_build
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver

    crit = dict(residual_rtol=1e-8, maxits=2000)
    solo = build_sharded_poisson_solver(24, 2, nparts=4,
                                        dtype=torch.float64, device=CPU)
    xs, b = solo.manufactured()
    x0 = solo.solve(b, criteria=StoppingCriteria(**crit), host_result=False)
    p = str(tmp_path / "ck")
    s1 = build_sharded_poisson_solver(
        24, 2, nparts=4, dtype=torch.float64, device=CPU,
        ckpt=ck.CheckpointConfig(path=p, every=16),
        health=HealthSpec(every=16), recovery=RecoveryPolicy())
    x1 = s1.solve(b, criteria=StoppingCriteria(**crit), host_result=False)
    assert torch.equal(x1, x0)
    snap = ck.load_snapshot(p)
    assert snap.meta["tier"] == "sharded-dia"
    s2 = build_sharded_poisson_solver(
        24, 2, nparts=4, dtype=torch.float64, device=CPU,
        ckpt=ck.CheckpointConfig(resume=snap))
    s2.solve(b, criteria=StoppingCriteria(**crit), host_result=False)
    assert snap.iteration + s2.stats.niterations == solo.stats.niterations
    ref = j_build(24, 2, dtype=jnp.float64)
    jx, jb = ref.manufactured()
    ref.solve(jb, criteria=JCrit(**crit))
    assert ref.stats.niterations == solo.stats.niterations


@pytest.mark.parametrize("spec,match", [
    ("spmv:nan@5:part=1", "cannot target part 1"),
    ("halo:nan@5", "halo fault injection needs"),
])
def test_sharded_fault_diagnosis_matches_the_reference(spec, match):
    from acg_tpu.parallel.sharded_dia import \
        build_sharded_poisson_solver as j_build
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver

    s = build_sharded_poisson_solver(16, 2, nparts=4, dtype=torch.float64,
                                     device=CPU, recovery=RecoveryPolicy())
    b = s.ones_b()
    with faults.injected(spec):
        with pytest.raises(AcgError, match=match) as mine:
            s.solve(b, criteria=StoppingCriteria(**CRIT))
    j = j_build(16, 2, dtype=jnp.float64, recovery=JPolicy())
    with jf.injected(spec):
        with pytest.raises(Exception) as theirs:
            j.solve(np.ones(256), criteria=JCrit(**CRIT))
    assert str(mine.value) == str(theirs.value).replace(
        f"{j._fault_nparts}", "4") or match in str(theirs.value)


def test_sharded_fault_recovers(tmp_path):
    """A fault in the sharded tier's global vector breaks the solve and
    the restart recovers it, as on one device."""
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver
    s = build_sharded_poisson_solver(16, 2, nparts=4, dtype=torch.float64,
                                     device=CPU, recovery=RecoveryPolicy())
    with faults.injected("spmv:nan@7"):
        x = s.solve(s.ones_b(), criteria=StoppingCriteria(**CRIT),
                    host_result=False)
    assert s.stats.nrestarts == 1 and bool(torch.isfinite(x).all())


# -- the batched tiers' checkpoints --------------------------------------------

BCRIT = dict(maxits=500, residual_rtol=1e-10)


@pytest.fixture(scope="module")
def batch():
    from acg_tpu_torch.io.generators import poisson2d_coo
    r, c, v, N = poisson2d_coo(16)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    return csr, _dev(csr), batched_rhs(N, 3, seed=0)


def test_batched_ckpt_chunked_is_bitwise(batch, tmp_path):
    _, A, B = batch
    Xp = BatchedCGSolver(A, device=CPU).solve(
        B, criteria=StoppingCriteria(**BCRIT))
    s = BatchedCGSolver(A, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck"), every=10))
    assert np.array_equal(s.solve(B, criteria=StoppingCriteria(**BCRIT)),
                          Xp)
    assert s.stats.ckpt["snapshots"] > 0 and s.stats.batch["nrhs"] == 3
    snap = ck.load_snapshot(str(tmp_path / "ck"))
    assert tuple(sorted(snap.arrays)) == tuple(sorted(
        ck.batched_carry_names(False)))


def test_batched_resume_continues_exactly(batch, tmp_path):
    _, A, B = batch
    Xp = BatchedCGSolver(A, device=CPU).solve(
        B, criteria=StoppingCriteria(**BCRIT))
    BatchedCGSolver(A, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck"), every=10)).solve(
        B, criteria=StoppingCriteria(maxits=25, residual_rtol=1e-10),
        raise_on_divergence=False)
    snap = ck.load_snapshot(str(tmp_path / "ck"))
    assert snap.meta["nrhs"] == 3 and snap.iteration == 25
    res = BatchedCGSolver(A, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck2"), every=10, resume=snap))
    assert np.array_equal(res.solve(B, criteria=StoppingCriteria(**BCRIT)),
                          Xp)
    assert res.stats.ckpt["resumed_from"] == 25


def test_batched_ckpt_unbounded_chunks_continue(batch, tmp_path):
    """tests/test_batched.py::test_batched_ckpt_unbounded_chunks_continue
    (which fails in the reference itself): fixed-work chunks continue
    across boundaries, held to the port's own uninterrupted solve."""
    _, A, B = batch
    crit = StoppingCriteria(maxits=100)
    Xp = BatchedCGSolver(A, device=CPU).solve(B, criteria=crit,
                                              raise_on_divergence=False)
    s = BatchedCGSolver(A, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck"), every=20))
    Xc = s.solve(B, criteria=crit, raise_on_divergence=False)
    assert s.stats.batch["iterations"] == [100, 100, 100]
    assert np.array_equal(Xc, Xp)


def test_batched_resume_refuses_wrong_nrhs(batch, tmp_path):
    _, A, B = batch
    BatchedCGSolver(A, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck"), every=10)).solve(
        B, criteria=StoppingCriteria(maxits=25, residual_rtol=1e-10),
        raise_on_divergence=False)
    snap = ck.load_snapshot(str(tmp_path / "ck"))
    res = BatchedCGSolver(A, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck2"), every=10, resume=snap))
    with pytest.raises(AcgError, match="right-hand-side count"):
        res.solve(batched_rhs(A.nrows, 5, seed=1),
                  criteria=StoppingCriteria(**BCRIT))


@pytest.mark.parametrize("mode", ["pipelined", "block"])
def test_batched_ckpt_refusals_match_the_reference(batch, mode):
    from acg_tpu.solvers.batched import BatchedCGSolver as JBatched
    csr, A, _ = batch
    with pytest.raises(ValueError) as mine:
        BatchedCGSolver(A, device=CPU, mode=mode,
                        ckpt=ck.CheckpointConfig(path="x", every=4))
    with pytest.raises(ValueError) as theirs:
        JBatched(j_dev(csr, dtype=jnp.float64), mode=mode,
                 ckpt=jck.CheckpointConfig(path="x", every=4))
    assert str(mine.value) == str(theirs.value)


def test_dist_batched_ckpt_and_repartition(batch, tmp_path):
    """A 4-part batched snapshot resumes bitwise on the same parts and
    restores onto 2 parts through --resume-repartition."""
    csr, _, B = batch
    prob4 = DistributedProblem.build(
        csr, partition_rows(csr, 4, seed=0, method="band"), 4)
    Xp = BatchedDistCGSolver(prob4, device=CPU).solve(
        B, criteria=StoppingCriteria(**BCRIT))
    BatchedDistCGSolver(prob4, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck"), every=10)).solve(
        B, criteria=StoppingCriteria(maxits=25, residual_rtol=1e-10),
        raise_on_divergence=False)
    snap = ck.load_snapshot(str(tmp_path / "ck"))
    assert snap.meta["nparts"] == 4 and "_rowperm" in snap.arrays
    res = BatchedDistCGSolver(prob4, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck2"), every=10, resume=snap))
    assert np.array_equal(res.solve(B, criteria=StoppingCriteria(**BCRIT)),
                          Xp)
    prob2 = DistributedProblem.build(
        csr, partition_rows(csr, 2, seed=0, method="band"), 2)
    rp = BatchedDistCGSolver(prob2, device=CPU, ckpt=ck.CheckpointConfig(
        path=str(tmp_path / "ck3"), every=10, resume=snap,
        repartition=True))
    X2 = rp.solve(B, criteria=StoppingCriteria(**BCRIT))
    assert rp.stats.ckpt["repartitioned_from"]["nparts"] == 4
    R = B - csr @ X2
    assert (np.linalg.norm(R, axis=0)
            <= 1e-9 * np.linalg.norm(B, axis=0)).all()
    with pytest.raises(ValueError, match="pipelined batched mode"):
        BatchedDistCGSolver(prob4, device=CPU, pipelined=True,
                            ckpt=ck.CheckpointConfig(path="x", every=4))
