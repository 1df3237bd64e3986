"""The port's communication-avoiding recurrences (acg_tpu_torch.recurrence,
``--algorithm sstep:S|pipelined:L``) against the JAX package's, on the
CPU, on the anisotropic 2D Poisson family 32^2 (eps = 0.1) of
tests/test_recurrence.py.

Tolerances, and why:

* s-step, single part and 4 stacked parts: the same iteration count as
  ``acg_tpu`` and x within 1e-10 relative (measured 2.7e-15 / 1.0e-12 /
  4.9e-12 for S = 2 / 4 / 8 on one part, 1.1e-12 for S = 4 on 4 parts:
  the basis products amplify the packages' different rounding -- XLA:CPU
  contracts multiply-adds, and its dots sum in another order).
* p(l): its restart points depend on rounding, so converged solves are
  held to the reference's acceptance (converged, true residual below 10
  rtol, iterations at most 3x classic) and to restarts recorded, not to
  the reference's counts.  Before the first breakdown x is compared
  directly: within 1e-12 of JAX's after 10 unbounded advances (measured
  <= 1.6e-14); after 30 the lag-l recovery has amplified the rounding by
  ~1e6 in both packages alike (port-vs-JAX measured 3.3e-8 / 1.9e-8 /
  1.9e-9 for l = 1 / 2 / 3, and JAX's own x drifts 1.2e-7 from classic
  CG's at l = 1), so the port is held within 1e-6 of JAX there and no
  farther from classic CG than 20x JAX's own distance plus 1e-12.
* The host oracle ``host_sstep_cg`` is the same numpy: bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from acg_tpu import recurrence as jrec
from acg_tpu.io.generators import aniso_poisson2d_coo
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dm
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.stats import StoppingCriteria as JCrit
from acg_tpu_torch import recurrence as rec
from acg_tpu_torch.io.generators import aniso_poisson2d_coo as t_aniso
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers.cg import TorchCGSolver
from acg_tpu_torch.solvers.stats import StoppingCriteria

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

RTOL = 1e-8
KW = dict(residual_rtol=RTOL, maxits=5000)
CPU = "cpu"


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def aniso():
    r, c, v, N = t_aniso(32, 0.1)
    jr, jc, jv, _ = aniso_poisson2d_coo(32, 0.1)
    assert np.array_equal(v, jv)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    jcsr = JaxSymCsr.from_coo(N, jr, jc, jv).to_csr()
    return {"csr": csr, "N": N,
            "Asp": sp.coo_matrix((v, (r, c)), shape=(N, N)).tocsr(),
            "A": device_matrix_from_csr(csr, dtype=torch.float64,
                                        device=CPU),
            "JA": jax_dm(jcsr, dtype=jnp.float64), "jcsr": jcsr,
            "b": np.random.default_rng(7).standard_normal(N)}


@pytest.fixture(scope="module")
def classic_iters(aniso):
    s = TorchCGSolver(aniso["A"], kernels="xla", device=CPU)
    s.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    return s.stats.niterations


def _true_rel(aniso, x):
    return _rel(aniso["Asp"] @ np.asarray(x), aniso["b"])


# -- specs -----------------------------------------------------------------

_SPELLINGS = [None, "auto", "", "classic", "pipelined", " SStep:4 ",
              "pipelined:1", "pipelined:2", "pipelined:3", "pipelined:4"] \
    + [f"sstep:{s}" for s in range(2, 17)]
_REFUSED = ["sstep:1", "sstep:0", "sstep:17", "sstep:99", "pipelined:0",
            "pipelined:5", "pipelined:9", "nope", "sstep:x", "sstep",
            "pipelined:-1", "chebyshev:4"]


def _spec_view(spec):
    if spec is None:
        return None
    return (spec.kind, spec.param, spec.basis, spec.needs_lam,
            spec.communication_avoiding, str(spec), spec.solver_name(),
            spec.solver_name("dist-cg"))


@pytest.mark.parametrize("name", _SPELLINGS)
def test_parse_algorithm_matches_jax(name):
    t, j = rec.parse_algorithm(name), jrec.parse_algorithm(name)
    assert _spec_view(t) == _spec_view(j)
    for pipelined in (False, True):
        for precond in (False, True):
            assert (rec.reduction_schedule(t, pipelined, precond)
                    == jrec.reduction_schedule(j, pipelined, precond))


@pytest.mark.parametrize("name", _REFUSED)
def test_parse_algorithm_refusals_match_jax(name):
    with pytest.raises(ValueError) as te:
        rec.parse_algorithm(name)
    with pytest.raises(ValueError) as je:
        jrec.parse_algorithm(name)
    assert str(te.value) == str(je.value)


def test_constants_and_restart_policy():
    assert (rec.POWER_ITERS, rec.LAM_SAFETY, rec.PL_RESTART_BUDGET) == (
        jrec.POWER_ITERS, jrec.LAM_SAFETY, jrec.PL_RESTART_BUDGET)
    # the reference's p(l) policy: restarts only, no fallback rung, as
    # the port's restart loop is
    jpol = jrec.pl_restart_policy()
    assert jpol.max_restarts == rec.PL_RESTART_BUDGET
    assert not (jpol.fallback_comm or jpol.fallback_host)


@pytest.mark.parametrize("s,basis", [(2, "monomial"), (3, "monomial"),
                                     (4, "chebyshev"), (8, "chebyshev")])
def test_basis_matrices_match_jax(s, basis):
    lam = (0.0, 33.9449869236727)
    for dt, jdt in ((torch.float64, jnp.float64),
                    (torch.float32, jnp.float32)):
        lt = (jnp.asarray(lam[0], jdt), jnp.asarray(lam[1], jdt))
        assert np.array_equal(
            rec.sstep_combined_bmat(s, basis, lam, dt).numpy(),
            np.asarray(jrec.sstep_combined_bmat(s, basis, lt, jdt)))
        assert np.array_equal(rec.pl_shifts(3, lam, dt).numpy(),
                              np.asarray(jrec.pl_shifts(3, lt, jdt)))


def test_estimate_lam_matches_jax(aniso):
    s = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                      algorithm="sstep:4")
    lam = s._ensure_lam()
    jlam = jrec.estimate_lam(aniso["JA"], aniso["N"], jnp.float64)
    assert lam[0] == jlam[0] == 0.0
    assert lam[1] == pytest.approx(jlam[1], rel=1e-13)


# -- s-step ------------------------------------------------------------------

@pytest.mark.parametrize("s", [2, 4, 8])
def test_sstep_matches_jax(aniso, classic_iters, s):
    js = JaxCGSolver(aniso["JA"], kernels="xla", algorithm=f"sstep:{s}")
    xj = np.asarray(js.solve(aniso["b"], criteria=JCrit(**KW)))
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm=f"sstep:{s}")
    xt = ts.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    assert ts.stats.converged
    assert ts.stats.niterations == js.stats.niterations
    assert _rel(xt, xj) <= 1e-10
    assert _true_rel(aniso, xt) < 10 * RTOL
    # the CA-CG band of the reference's acceptance: within a block
    assert abs(ts.stats.niterations - classic_iters) <= s


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
def test_sstep_kernel_choice_gives_the_same_bits(aniso, kernels):
    """On DIA planes K1's plain version (``pallas`` on the CPU) computes
    what the plain SpMV computes, bit for bit."""
    out = []
    for k in ("xla", kernels):
        s = TorchCGSolver(aniso["A"], kernels=k, device=CPU,
                          algorithm="sstep:4")
        out.append(s.solve(aniso["b"], criteria=StoppingCriteria(**KW)))
    assert np.array_equal(out[0], out[1])


@pytest.mark.parametrize("s,lam", [(2, None), (4, None),
                                   (4, (0.0, 33.9449869236727))])
def test_host_sstep_oracle_bitwise(aniso, s, lam):
    t = rec.host_sstep_cg(aniso["Asp"], aniso["b"], rtol=RTOL, maxits=5000,
                          s=s, lam=lam)
    j = jrec.host_sstep_cg(aniso["Asp"], aniso["b"], rtol=RTOL,
                           maxits=5000, s=s, lam=lam)
    assert np.array_equal(t[0], j[0])
    assert t[1] == j[1] and t[2] == j[2] and t[3] == j[3]


def test_sstep_matches_host_oracle(aniso):
    """The port's s-step against the host oracle on the port's own
    spectral estimate: the same iterations, x within 1e-10."""
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm="sstep:4")
    xt = ts.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    xh, kh, _, _ = rec.host_sstep_cg(aniso["Asp"], aniso["b"], rtol=RTOL,
                                     maxits=5000, s=4, lam=ts._lam)
    assert ts.stats.niterations == kh
    assert _rel(xt, xh) <= 1e-10


@pytest.mark.parametrize("algorithm,maxits", [("sstep:4", 37),
                                              ("sstep:8", 37),
                                              ("sstep:2", 5)])
def test_sstep_unbounded_runs_exactly_maxits(aniso, algorithm, maxits):
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm=algorithm)
    xt = ts.solve(aniso["b"], criteria=StoppingCriteria(maxits=maxits))
    js = JaxCGSolver(aniso["JA"], kernels="xla", algorithm=algorithm)
    xj = np.asarray(js.solve(aniso["b"], criteria=JCrit(maxits=maxits)))
    assert ts.stats.niterations == js.stats.niterations == maxits
    assert ts.stats.converged
    assert _rel(xt, xj) <= 1e-10


def test_sstep_block_after_convergence_changes_nothing(aniso):
    """A converged s-step solve stops mid-block: later blocks of the
    chunk (and a second solve from its x) leave x as it was."""
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm="sstep:8")
    x = ts.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    k = ts.stats.niterations
    assert k % 8 != 0   # stopped inside a block
    x2 = ts.solve(aniso["b"], x0=x, criteria=StoppingCriteria(
        maxits=5000, residual_atol=2 * ts.stats.rnrm2))
    assert ts.stats.niterations == 0 and np.array_equal(x2, x)


def test_sstep_f32_matches_jax(aniso):
    """f32 vectors: the same iterations, x within 1e-4 (an f32 solve to
    1e-5; measured 2.2e-5 relative)."""
    A32 = device_matrix_from_csr(aniso["csr"], dtype=torch.float32,
                                 device=CPU)
    ts = TorchCGSolver(A32, kernels="xla", device=CPU, algorithm="sstep:4")
    kw = dict(residual_rtol=1e-5, maxits=5000)
    xt = ts.solve(aniso["b"], criteria=StoppingCriteria(**kw))
    js = JaxCGSolver(jax_dm(aniso["jcsr"], dtype=jnp.float32),
                     kernels="xla", algorithm="sstep:4")
    xj = np.asarray(js.solve(aniso["b"], criteria=JCrit(**kw)))
    assert ts.stats.niterations == js.stats.niterations
    assert _rel(xt, xj) <= 1e-4


def test_sstep_census_matches_jax(aniso):
    """The op census (gemv, dot, nrm2, axpy rows and the flop total) is
    the reference's for the same iterations."""
    kw = dict(maxits=80)
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm="sstep:8")
    ts.solve(aniso["b"], criteria=StoppingCriteria(**kw))
    js = JaxCGSolver(aniso["JA"], kernels="xla", algorithm="sstep:8")
    js.solve(aniso["b"], criteria=JCrit(**kw))
    for op in ("gemv", "dot", "nrm2", "axpy", "copy"):
        assert (ts.stats.ops[op].n, ts.stats.ops[op].bytes) == (
            js.stats.ops[op].n, js.stats.ops[op].bytes)
    assert ts.stats.nflops == pytest.approx(js.stats.nflops, rel=1e-12)


# -- p(l) ----------------------------------------------------------------

@pytest.mark.parametrize("l", [1, 2, 3])
def test_pl_convergence_acceptance(aniso, classic_iters, l):
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm=f"pipelined:{l}")
    x = ts.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    assert ts.stats.converged
    assert _true_rel(aniso, x) < 10 * RTOL
    assert ts.stats.niterations <= 3 * classic_iters
    # the square-root breakdowns restarted, and the stats block says so
    st = ts.stats
    assert st.nrestarts >= 1 and st.nbreakdowns == st.nrestarts
    assert ts.max_restarts == rec.PL_RESTART_BUDGET
    text = st.fwrite()
    assert (f"  resilience: {st.nbreakdowns} breakdowns detected, "
            f"{st.nrestarts} restarts, 0 fallbacks") in text
    assert text.count("from the recomputed true residual") == st.nrestarts


def _cg_iterate(aniso, m):
    A, b = aniso["Asp"], aniso["b"]
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    g = r @ r
    for _ in range(m):
        t = A @ p
        a = g / (p @ t)
        x += a * p
        r -= a * t
        gn = r @ r
        p = r + gn / g * p
        g = gn
    return x


@pytest.mark.parametrize("advances,bound", [(10, 1e-12), (30, 1e-6)])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_pl_unbounded_advances_match_jax(aniso, l, advances, bound):
    """Before the first breakdown (30 advances, as the reference's
    Lanczos test) p(l) is compared directly; see the module docstring
    for the two bounds."""
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm=f"pipelined:{l}")
    xt = ts.solve(aniso["b"], criteria=StoppingCriteria(maxits=advances))
    js = JaxCGSolver(aniso["JA"], kernels="xla",
                     algorithm=f"pipelined:{l}")
    xj = np.asarray(js.solve(aniso["b"], criteria=JCrit(maxits=advances)))
    assert ts.stats.niterations == js.stats.niterations == advances
    assert ts.stats.nrestarts == js.stats.nrestarts == 0
    assert _rel(xt, xj) <= bound
    xc = _cg_iterate(aniso, advances)
    assert _rel(xt, xc) <= 20 * _rel(xj, xc) + 1e-12


def test_pl_converged_carry_freezes(aniso):
    """A converged p(l) solve reports no breakdown however many frozen
    steps its last chunk runs: the same x from a second solve at the
    reached tolerance, and zero iterations."""
    ts = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm="pipelined:2")
    # 50 advances, before the first breakdown; the chunk runs on to
    # step 64, past where a breakdown would come
    x = ts.solve(aniso["b"], criteria=StoppingCriteria(
        residual_rtol=3e-2, maxits=5000))
    assert ts.stats.converged and ts.stats.nbreakdowns == 0
    x2 = ts.solve(aniso["b"], x0=x, criteria=StoppingCriteria(
        maxits=5000, residual_atol=2 * ts.stats.rnrm2))
    assert ts.stats.niterations == 0 and np.array_equal(x2, x)


# -- stacked parts -----------------------------------------------------------

@pytest.fixture(scope="module")
def parts(aniso):
    part = partition_rows(aniso["csr"], 4, seed=0, method="band")
    from acg_tpu.partition import partition_rows as jax_partition_rows
    assert np.array_equal(part, jax_partition_rows(aniso["jcsr"], 4, seed=0,
                                                   method="band"))
    return (DistributedProblem.build(aniso["csr"], part, 4,
                                     dtype=torch.float64),
            JaxProblem.build(aniso["jcsr"], part, 4, dtype=jnp.float64))


@pytest.mark.parametrize("algorithm", ["sstep:2", "sstep:4", "sstep:8"])
def test_dist_sstep_matches_jax(aniso, parts, algorithm):
    prob, jprob = parts
    js = JaxDistCG(jprob, algorithm=algorithm)
    xj = np.asarray(js.solve(aniso["b"], criteria=JCrit(**KW)))
    xs = {}
    for comm in ("xla", "dma"):
        ts = DistCGSolver(prob, algorithm=algorithm, comm=comm,
                          kernels="pallas", device=CPU)
        xs[comm] = ts.solve(aniso["b"], criteria=StoppingCriteria(**KW))
        assert ts.stats.niterations == js.stats.niterations
        for op in ("gemv", "allreduce", "halo", "dot"):
            assert (ts.stats.ops[op].n, ts.stats.ops[op].bytes) == (
                js.stats.ops[op].n, js.stats.ops[op].bytes)
    # the one-sided transport (K6's plain version) moves the same bits
    assert np.array_equal(xs["xla"], xs["dma"])
    assert _rel(xs["xla"], xj) <= 1e-10
    assert _true_rel(aniso, xs["xla"]) < 10 * RTOL


def test_dist_pl_converges(aniso, parts, classic_iters):
    prob, _ = parts
    xs = {}
    for comm in ("xla", "dma"):
        ts = DistCGSolver(prob, algorithm="pipelined:2", comm=comm,
                          device=CPU)
        xs[comm] = ts.solve(aniso["b"], criteria=StoppingCriteria(**KW))
        assert ts.stats.converged and ts.stats.nrestarts >= 1
        assert ts.stats.niterations <= 3 * classic_iters
    assert np.array_equal(xs["xla"], xs["dma"])
    assert _true_rel(aniso, xs["xla"]) < 10 * RTOL


def test_dist_pl_unbounded_matches_single(aniso, parts):
    """Before any breakdown the stacked p(l) follows the single-part one
    (its psum'd dots add in another order)."""
    prob, _ = parts
    ts = DistCGSolver(prob, algorithm="pipelined:2", device=CPU)
    xd = ts.solve(aniso["b"], criteria=StoppingCriteria(maxits=10))
    s1 = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm="pipelined:2")
    x1 = s1.solve(aniso["b"], criteria=StoppingCriteria(maxits=10))
    assert _rel(xd, x1) <= 1e-12


# -- refusals ----------------------------------------------------------------

def _msg(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


_SINGLE_REFUSALS = [
    ("sstep:4", dict(precond="jacobi")),
    ("sstep:4", dict(precise_dots=True)),
    ("pipelined:2", dict(pipelined=True)),
    ("sstep:4", dict(replace_every=10, vector_dtype="bf16")),
    ("pipelined:2", dict(vector_dtype="bf16")),
    ("sstep:2", dict(precond="cheby:2", dtype="f32")),
]


@pytest.mark.parametrize("algorithm,kw", _SINGLE_REFUSALS)
def test_refusals_match_jax(aniso, algorithm, kw):
    kw = dict(kw)
    dt = kw.pop("dtype", "f64")
    tdt = {"f64": torch.float64, "f32": torch.float32}[dt]
    jdt = {"f64": jnp.float64, "f32": jnp.float32}[dt]
    if kw.get("vector_dtype") == "bf16":
        kw_t = dict(kw, vector_dtype=torch.bfloat16)
        kw_j = dict(kw, vector_dtype=jnp.bfloat16)
        tdt, jdt = torch.bfloat16, jnp.bfloat16
    else:
        kw_t = kw_j = kw
    At = device_matrix_from_csr(aniso["csr"], dtype=tdt, device=CPU)
    Aj = jax_dm(aniso["jcsr"], dtype=jdt)
    assert _msg(lambda: TorchCGSolver(At, device=CPU, algorithm=algorithm,
                                      **kw_t)) \
        == _msg(lambda: JaxCGSolver(Aj, algorithm=algorithm, **kw_j))


def test_diff_criteria_refused_at_solve_like_jax(aniso):
    crit = dict(diff_rtol=1e-6, maxits=10)
    t = TorchCGSolver(aniso["A"], device=CPU, algorithm="sstep:4")
    j = JaxCGSolver(aniso["JA"], algorithm="sstep:4")
    assert _msg(lambda: t.solve(aniso["b"],
                                criteria=StoppingCriteria(**crit))) \
        == _msg(lambda: j.solve(aniso["b"], criteria=JCrit(**crit)))


@pytest.mark.parametrize("alias,pipelined", [("pipelined", True),
                                             ("classic", False)])
def test_classic_and_pipelined_aliases(aniso, alias, pipelined):
    s = TorchCGSolver(aniso["A"], device=CPU, algorithm=alias,
                      pipelined=not pipelined)
    assert s.algo is None and s.pipelined == pipelined and \
        s.max_restarts is None


_DIST_REFUSALS = [dict(pipelined=True), dict(precise_dots=True),
                  dict(precond="jacobi"), dict(vector_dtype="bf16"),
                  dict(replace_every=4, vector_dtype="bf16")]


@pytest.mark.parametrize("kw", _DIST_REFUSALS)
def test_dist_refusals_match_jax(aniso, kw):
    kw = dict(kw)
    bf16 = kw.pop("vector_dtype", None) == "bf16"
    part = partition_rows(aniso["csr"], 2, method="band")
    prob = DistributedProblem.build(
        aniso["csr"], part, 2, dtype=torch.float64,
        vector_dtype=torch.bfloat16 if bf16 else None)
    jprob = JaxProblem.build(aniso["jcsr"], part, 2, dtype=jnp.float64,
                             vector_dtype=jnp.bfloat16 if bf16 else None)
    assert _msg(lambda: DistCGSolver(prob, device=CPU, algorithm="sstep:4",
                                     **kw)) \
        == _msg(lambda: JaxDistCG(jprob, algorithm="sstep:4", **kw))


_CLI_REFUSALS = [
    ["--algorithm", "sstep:4", "--precond", "jacobi"],
    ["--algorithm", "sstep:33"],
    ["--algorithm", "nope"],
    ["--algorithm", "pipelined:2", "--nrhs", "2"],
    ["--algorithm", "sstep:4", "--refine", "--precise-dots"],
    ["--algorithm", "sstep:4", "--solver", "host"],
    ["--algorithm", "pipelined:3", "--kernels", "fused", "--diff-rtol",
     "1e-3"],
    ["--algorithm", "sstep:2", "--replace-every", "5", "--dtype", "bf16"],
]


@pytest.mark.parametrize("flags", _CLI_REFUSALS)
def test_cli_refusals_match_jax(flags):
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main as torch_main
    msgs = []
    for main, extra, prog in ((jax_main, [], "acg-tpu: "),
                              (torch_main, ["--device", "cpu"],
                               "acg-tpu-torch: ")):
        with pytest.raises(SystemExit) as e:
            main(["gen:poisson2d:8", "--warmup", "0", "-q"] + flags + extra)
        msgs.append(str(e.value.code).replace(prog, ""))
    assert msgs[0] == msgs[1]


# -- the CA recurrences' ring and heartbeat ---------------------------------

@pytest.mark.parametrize("algorithm,window,tail_rtol", [
    ("sstep:4", 512, 2e-4), ("sstep:2", 32, 1e-9), ("sstep:8", 512, 5e-2)])
def test_ca_ring_matches_jax(aniso, algorithm, window, tail_rtol):
    """The sstep:S ring records each inner step's plain CG scalars
    (|r|, alpha, beta, p^T A p) in the slot of its trajectory iteration,
    as the reference's does: the same window and iterations; every row
    but the last 8 within 1e-8 (measured 1.7e-9 at S = 8, 2.0e-11 at
    S = 4, 8.6e-14 at S = 2), and |r| within 1e-9 of |r0| on every row
    (measured 6.6e-11 / 1.3e-12 / 1.0e-18).  The last 8
    rows' scalars, computed from residuals near 1e-8 of r0 through the
    basis Gram products, are held to ``tail_rtol``, a few times the
    gap measured there (1.2e-2 / 5.2e-5 / 1.9e-10): the two packages
    sum in different orders and the S-step basis amplifies the
    difference, the more the larger S."""
    J = JaxCGSolver(aniso["JA"], kernels="xla", algorithm=algorithm,
                    trace=window)
    J.solve(aniso["b"], criteria=JCrit(**KW))
    T = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                      algorithm=algorithm, trace=window)
    T.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    assert T.stats.niterations == J.stats.niterations
    tj, tt = J.last_trace, T.last_trace
    assert (tt.niterations, tt.wrapped, tt.solver) == \
        (tj.niterations, tj.wrapped, tj.solver)
    assert np.array_equal(tt.iterations, tj.iterations)
    _same_window(tt.records, np.asarray(tj.records), J.stats.r0nrm2,
                 tail_rtol)


def _same_window(got, want, r0: float, tail_rtol: float, tail: int = 8):
    head = max(want.shape[0] - tail, 1)
    for col in range(want.shape[1]):
        np.testing.assert_allclose(got[:head, col], want[:head, col],
                                   rtol=1e-8,
                                   atol=1e-9 * np.abs(want[:, col]).max())
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-9 * r0)
    np.testing.assert_allclose(got[head:], want[head:], rtol=tail_rtol)


@pytest.mark.parametrize("l,its,rtol", [(1, 30, 5e-5), (2, 30, 5e-6),
                                        (3, 30, 1e-6), (2, 40, 2e-3)])
def test_pl_ring_matches_jax_in_the_first_attempt(aniso, l, its, rtol):
    """p(l)'s ring against the reference's over a fixed count of
    advances inside the first attempt (the aniso family's first sqrt
    breakdown comes later, in both packages): the same iterations, no
    restart, the same rows; the first 15 within 1e-10 (measured
    <= 9.0e-12 for l = 1, 2, 3), every row within ``rtol``, a few times
    the gap measured on the last (8.8e-6 / 9.3e-7 / 1.2e-7 after 30
    advances, 4.1e-4 after 40 for l = 2): the lag-l recovery amplifies
    the packages' different rounding ~1e6 in 30 advances, as the
    module docstring records for x."""
    J = JaxCGSolver(aniso["JA"], kernels="xla", algorithm=f"pipelined:{l}",
                    trace=4096)
    J.solve(aniso["b"], criteria=JCrit(maxits=its))
    T = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                      algorithm=f"pipelined:{l}", trace=4096)
    T.solve(aniso["b"], criteria=StoppingCriteria(maxits=its))
    assert T.stats.niterations == J.stats.niterations == its
    assert T.stats.nrestarts == J.stats.nrestarts == 0
    tj, tt = J.last_trace, T.last_trace
    assert (tt.niterations, tt.wrapped, tt.solver) == \
        (tj.niterations, tj.wrapped, tj.solver)
    assert np.array_equal(tt.iterations, tj.iterations)
    want = np.asarray(tj.records)
    assert tt.records.shape == want.shape == (its, 4)
    np.testing.assert_allclose(tt.records[:15], want[:15], rtol=1e-10)
    np.testing.assert_allclose(tt.records, want, rtol=rtol)


@pytest.mark.parametrize("l,window", [(2, 512), (1, 24)])
def test_pl_ring_survives_the_restart_rung(aniso, l, window):
    """p(l)'s ring records (q^2, 1/d, l^2, d) at each solution advance
    (classic-aligned rows); after the restart rung's restarts the solve's
    ring is the last attempt's, ending at the reported residual.  (p(l)
    restarts at other iterations than the reference's -- its breakdowns
    are rounding-driven -- so past the first attempt the window is held
    to the port's own solve; the first attempt's ring is held to the
    reference's above.)"""
    T = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                      algorithm=f"pipelined:{l}", trace=window)
    T.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    st, tr = T.stats, T.last_trace
    assert st.nrestarts >= 1 and tr is st.trace
    assert tr.solver == f"cg-pl{l}"
    assert 0 < tr.niterations <= st.niterations
    its = tr.iterations
    assert np.array_equal(its, np.arange(its[0], its[0] + its.size))
    assert tr.records[-1, 0] == pytest.approx(st.rnrm2, rel=1e-12)
    assert np.isfinite(tr.records).all()
    # 1/d and d are one another's reciprocals, l^2 >= 0
    np.testing.assert_allclose(tr.records[:, 1] * tr.records[:, 3], 1.0,
                               rtol=1e-12)
    assert (tr.records[:, 2] >= 0).all()


@pytest.mark.parametrize("algorithm", ["sstep:4", "pipelined:2"])
def test_ca_heartbeat_prints_on_the_period(aniso, algorithm, capsys):
    T = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                      algorithm=algorithm, progress=20)
    T.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    err = capsys.readouterr().err
    its = [int(ln.split(": iteration ")[1].split(":")[0])
           for ln in err.splitlines() if ": iteration " in ln]
    assert its and all(i % 20 == 0 for i in its)
    assert max(its) <= T.stats.ntotaliterations


def test_stacked_ca_ring_matches_single_device(aniso, parts):
    prob, _ = parts
    s1 = TorchCGSolver(aniso["A"], kernels="xla", device=CPU,
                       algorithm="sstep:4", trace=64)
    s1.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    s4 = DistCGSolver(prob, device=CPU, algorithm="sstep:4", trace=64)
    s4.solve(aniso["b"], criteria=StoppingCriteria(**KW))
    assert s4.stats.niterations == s1.stats.niterations
    assert np.array_equal(s4.last_trace.iterations, s1.last_trace.iterations)
    # the stacked dots sum by part: the last rows' gap measured 5.4e-5,
    # the others' 4.2e-11, |r|'s 2.9e-13 of |r0|
    _same_window(s4.last_trace.records, s1.last_trace.records,
                 s1.stats.r0nrm2, 2e-4)


def test_cli_ca_convergence_log(tmp_path, capsys):
    from acg_tpu_torch.cli import main
    from acg_tpu_torch.telemetry import read_convergence_log
    log = tmp_path / "ca.jsonl"
    assert main(["gen:poisson2d:16", "--device", "cpu", "--algorithm",
                 "sstep:4", "--max-iterations", "500", "--residual-rtol",
                 "1e-8", "-q", "--convergence-log", str(log),
                 "--progress", "8"]) == 0
    meta, recs = read_convergence_log(log)
    assert meta["solver"].endswith("sstep4") and recs
    assert ": iteration 8:" in capsys.readouterr().err
