"""The port's precision tier against the JAX package's: the compensated
dot primitives (``acg_tpu_torch.ops.precision``), ``precise_dots``
solves, the bf16 residual-replacement program (``replace_every``) and
``RefinedSolver``, single-part and on 4 stacked parts, and their CLI
flags.

Tolerances:

* ``two_sum``/``two_prod`` are exact (checked in f64, as
  ``tests/test_precision.py`` checks them); ``dot2`` and ``df_sum`` agree
  with the JAX functions within 2 ulps of the working dtype (XLA:CPU may
  contract ``ah*bh - p`` into a fused multiply-add; eager torch does not).
* ``precise_dots`` solves take the same iteration count as
  ``JaxCGSolver``; x agrees within 1e-5 relative in f32 classic and 5e-3
  in bf16.  Pipelined f32 is held to 1e-4: its recurrences amplify the
  one-ulp differences of XLA:CPU's contracted multiply-adds, and the same
  solve with plain dots differs between the packages by as much (the
  test measures both and shows it).
* ``replace_every``: the same iteration count, the reported residual
  equal to the true residual of the returned x within 1e-5 of ||b||
  (``tests/test_bf16.py``'s bound), ``maxits`` honoured exactly.
* ``RefinedSolver``: the same outer passes and x within 1e-10 relative;
  the same inner iteration total except where a pass solves for storage
  rounding noise (f32/bf16 inner solves: within 5 %, see the test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from acg_tpu.cli import main as jax_main
from acg_tpu.io.generators import poisson2d_coo as jax_poisson2d_coo
from acg_tpu.ops import precision as jprec
from acg_tpu.ops.spmv import device_matrix_from_csr as jax_dev_matrix
from acg_tpu.parallel.dist import DistCGSolver as JaxDistCG
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.partition import partition_rows as jax_partition_rows
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.refine import RefinedSolver as JaxRefined
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.errors import NotConvergedError
from acg_tpu_torch.io.generators import poisson2d_coo
from acg_tpu_torch.io.mtxfile import read_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import precision as P
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver
from acg_tpu_torch.solvers.refine import RefinedSolver

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float64: jnp.float64}


def _poisson(n):
    r, c, v, N = poisson2d_coo(n)
    jr, jc, jv, _ = jax_poisson2d_coo(n)
    assert np.array_equal(r, jr) and np.array_equal(v, jv)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


@pytest.fixture(scope="module")
def p16():
    return _poisson(16)


@pytest.fixture(scope="module")
def p32():
    return _poisson(32)


@pytest.fixture(scope="module")
def p64():
    return _poisson(64)


def _manufactured(csr, seed):
    rng = np.random.default_rng(seed)
    xsol = rng.standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    return xsol, csr @ xsol


def _ulps(got, want, dtype) -> float:
    return abs(float(got) - float(want)) / float(
        np.spacing(np.asarray(abs(float(want)), dtype)))


# -- the primitives -------------------------------------------------------

def test_two_sum_exact():
    """s + e == a + b exactly (checked in f64)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.standard_normal(1000) * 1e6).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(1000) * 1e-3).astype(
        np.float32))
    s, e = P.two_sum(a, b)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  a.double().numpy() + b.double().numpy())


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
            for _ in range(2))
    p, e = P.two_prod(a, b)
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(),
                                  a.double().numpy() * b.double().numpy())


def test_split_dtype_aware():
    """The split constant follows the dtype: f64 splits are exact, and
    the f64 two-product reproduces the square exactly."""
    a = torch.from_numpy(np.random.default_rng(7).standard_normal(100))
    hi, lo = P.split(a)
    assert torch.equal(hi + lo, a)
    p, e = P.two_prod(a, a)
    assert torch.equal(p + e, a * a)


@pytest.mark.parametrize("n", [1, 7, 1000, 12345, 1 << 15])
def test_dot2_and_df_sum_match_jax(n):
    """Within 2 ulps of f32 of the JAX functions on the same inputs, and
    dot2 closer to the f64 dot than the plain f32 one."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(0, 4, n)).astype(
        np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    got = P.dot2(torch.from_numpy(x), torch.from_numpy(y))
    want = jax.jit(jprec.dot2)(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float32
    assert _ulps(got, want, np.float32) <= 2
    hi, lo = P.df_sum(torch.from_numpy(x))
    jhi, jlo = jax.jit(jprec.df_sum)(jnp.asarray(x))
    assert _ulps(hi + lo, jhi + jlo, np.float32) <= 2
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    plain = float(torch.dot(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(got) - exact) <= abs(plain - exact) + 1e-12


def test_stacked_dot2_is_per_part():
    """On stacked parts (P, n) every part reduces on its own, with the
    fold of a single vector."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 1001)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((3, 1001)).astype(np.float32))
    hi, lo = P.dot_compensated(x, y)
    assert hi.shape == (3,)
    for p in range(3):
        assert torch.equal(hi[p] + lo[p], P.dot2(x[p], y[p]))


# -- precise_dots solves ------------------------------------------------------

def _precise_pair(csr, dtype, pipelined, precise, rtol, seed=4):
    _, b = _manufactured(csr, seed)
    J = JaxCGSolver(jax_dev_matrix(csr, dtype=JDT[dtype]),
                    pipelined=pipelined, precise_dots=precise,
                    kernels="pallas")
    T = TorchCGSolver(device_matrix_from_csr(csr, dtype=dtype, device=CPU),
                      pipelined=pipelined, precise_dots=precise,
                      kernels="pallas", device=CPU)
    crit = dict(maxits=3000, residual_rtol=rtol)
    xj = np.asarray(J.solve(b, criteria=JaxCrit(**crit)), np.float64)
    xt = np.asarray(T.solve(b, criteria=StoppingCriteria(**crit)),
                    np.float64)
    assert J.stats.converged and T.stats.converged
    rel = np.linalg.norm(xt - xj) / np.linalg.norm(xj)
    return J.stats.niterations, T.stats.niterations, rel


@pytest.mark.parametrize("dtype,rtol,bound", [
    (torch.float32, 1e-6, 1e-5), (torch.bfloat16, 1e-2, 5e-3)])
def test_precise_classic_matches_jax(p16, dtype, rtol, bound):
    jits, tits, rel = _precise_pair(p16, dtype, False, True, rtol)
    assert tits == jits
    assert rel <= bound, rel


def test_precise_pipelined_f32_matches_jax(p16):
    """The same iterations; x within 1e-4, the distance the same solve
    with plain dots already shows between the two packages."""
    jits, tits, rel = _precise_pair(p16, torch.float32, True, True, 1e-6)
    pj, pt, rel_plain = _precise_pair(p16, torch.float32, True, False, 1e-6)
    assert tits == jits and pt == pj
    assert rel <= 1e-4 and rel_plain <= 1e-4
    assert rel <= 3 * rel_plain, (rel, rel_plain)


def test_precise_pipelined_bf16_matches_jax(p16):
    jits, tits, rel = _precise_pair(p16, torch.bfloat16, True, True, 3e-2)
    assert tits == jits
    assert rel <= 5e-3, rel


def test_precise_dots_f32_converges_deeper(p32):
    """tests/test_precision.py's contract: f32 storage with compensated
    dots reaches 2e-6 and an error below 5e-4."""
    xsol, b = _manufactured(p32, 4)
    T = TorchCGSolver(device_matrix_from_csr(p32, dtype=torch.float32,
                                             device=CPU),
                      precise_dots=True, device=CPU)
    x = T.solve(b.astype(np.float32),
                criteria=StoppingCriteria(maxits=5000, residual_rtol=2e-6))
    assert T.stats.converged
    assert np.linalg.norm(x - xsol) < 5e-4


def test_precise_dots_stacked_matches_jax_mesh(p16):
    """4 stacked parts psum compensated pairs: the iterations of the JAX
    mesh tier and of the single-part port."""
    _, b = _manufactured(p16, 4)
    crit = dict(maxits=3000, residual_rtol=1e-6)
    part = partition_rows(p16, 4, seed=0, method="band")
    jpart = jax_partition_rows(p16, 4, seed=0, method="band")
    assert np.array_equal(part, jpart)
    J = JaxDistCG(JaxProblem.build(p16, jpart, 4, dtype=jnp.float32),
                  precise_dots=True)
    xj = J.solve(b, criteria=JaxCrit(**crit))
    T = DistCGSolver(DistributedProblem.build(p16, part, 4,
                                              dtype=torch.float32),
                     precise_dots=True, device=CPU)
    xt = T.solve(b, criteria=StoppingCriteria(**crit))
    S = TorchCGSolver(device_matrix_from_csr(p16, dtype=torch.float32,
                                             device=CPU),
                      precise_dots=True, device=CPU)
    S.solve(b, criteria=StoppingCriteria(**crit))
    assert T.stats.niterations == J.stats.niterations == S.stats.niterations
    assert np.linalg.norm(xt - xj) <= 1e-5 * np.linalg.norm(xj)


# -- replace_every ------------------------------------------------------------

@pytest.mark.parametrize("restart", [True, False])
@pytest.mark.parametrize("crit", [dict(maxits=130),
                                  dict(maxits=3000, residual_rtol=1e-5)])
def test_replaced_matches_jax(p64, restart, crit):
    """The same iterations as JaxCGSolver's replacement program (maxits
    130 with K = 64: the last segment runs short and the count is exactly
    130), and the reported residual is the true one."""
    _, b = _manufactured(p64, 1)
    J = JaxCGSolver(jax_dev_matrix(p64, dtype=jnp.bfloat16), kernels="xla",
                    replace_every=64, replace_restart=restart)
    J.solve(b, criteria=JaxCrit(**crit), raise_on_divergence=False)
    T = TorchCGSolver(device_matrix_from_csr(p64, dtype=torch.bfloat16,
                                             device=CPU),
                      kernels="pallas", replace_every=64,
                      replace_restart=restart, device=CPU)
    x = T.solve(b, criteria=StoppingCriteria(**crit))
    assert T.kernels == "pallas-plain"
    assert T.stats.niterations == J.stats.niterations
    if "residual_rtol" not in crit:
        assert T.stats.niterations == 130
    assert x.dtype == np.float32
    true_r = np.linalg.norm(b - p64 @ x.astype(np.float64))
    assert abs(T.stats.rnrm2 - true_r) <= 1e-5 * np.linalg.norm(b)
    assert T.stats.converged
    # the census bills the bf16 inner iterations and one mixed
    # replacement SpMV per segment, as the JAX tier does
    assert T.stats.ops["gemv"].n == J.stats.ops["gemv"].n
    assert T.stats.ops["dot"].n == J.stats.ops["dot"].n


def test_replaced_sound_beyond_kappa_limit():
    """tests/test_bf16.py's contract at n = 128 (kappa ~ 6.6e3): the
    replaced tier reaches an f32-class residual where plain bf16 stalls."""
    csr = _poisson(128)
    _, b = _manufactured(csr, 1)
    A = device_matrix_from_csr(csr, dtype=torch.bfloat16, device=CPU)
    crit = StoppingCriteria(maxits=1500)
    x = TorchCGSolver(A, replace_every=50, device=CPU).solve(b, criteria=crit)
    xp = TorchCGSolver(A, device=CPU).solve(b, criteria=crit)
    rel = np.linalg.norm(b - csr @ x) / np.linalg.norm(b)
    rel_plain = np.linalg.norm(b - csr @ xp) / np.linalg.norm(b)
    assert rel < 1e-5
    assert np.isnan(rel_plain) or rel < 0.1 * rel_plain


def test_replaced_stacked_matches_jax_mesh(p64):
    _, b = _manufactured(p64, 1)
    crit = dict(maxits=3000, residual_rtol=1e-5)
    part = partition_rows(p64, 4, seed=0, method="band")
    J = JaxDistCG(JaxProblem.build(p64, part, 4, dtype=jnp.bfloat16),
                  replace_every=50)
    J.solve(b, criteria=JaxCrit(**crit))
    for comm in ("xla", "dma"):
        T = DistCGSolver(DistributedProblem.build(p64, part, 4,
                                                  dtype=torch.bfloat16),
                         replace_every=50, comm=comm, kernels="pallas",
                         device=CPU)
        x = T.solve(b, criteria=StoppingCriteria(**crit))
        assert T.stats.niterations == J.stats.niterations
        true_r = np.linalg.norm(b - p64 @ x.astype(np.float64))
        assert abs(T.stats.rnrm2 - true_r) <= 1e-5 * np.linalg.norm(b)


def _refusal(build):
    with pytest.raises(ValueError) as e:
        build()
    return str(e.value)


def test_replaced_refusals_match_jax(p16):
    """Each refusal of the JAX tiers, with its message."""
    N = p16.shape[0]
    cases = [(torch.float32, dict(replace_every=50)),
             (torch.bfloat16, dict(replace_every=50, pipelined=True)),
             (torch.bfloat16, dict(replace_every=50, precise_dots=True)),
             (torch.bfloat16, dict(replace_every=-1)),
             (torch.float32, dict(kernels="fused", precise_dots=True))]
    for dt, kw in cases:
        jmsg = _refusal(lambda: JaxCGSolver(
            jax_dev_matrix(p16, dtype=JDT[dt]), **kw))
        tmsg = _refusal(lambda: TorchCGSolver(
            device_matrix_from_csr(p16, dtype=dt, device=CPU), device=CPU,
            **kw))
        assert tmsg == jmsg, kw
    crit = dict(maxits=10, diff_rtol=1e-3)
    jmsg = _refusal(lambda: JaxCGSolver(
        jax_dev_matrix(p16, dtype=jnp.bfloat16), replace_every=50).solve(
            np.ones(N), criteria=JaxCrit(**crit)))
    tmsg = _refusal(lambda: TorchCGSolver(
        device_matrix_from_csr(p16, dtype=torch.bfloat16, device=CPU),
        replace_every=50, device=CPU).solve(
            np.ones(N), criteria=StoppingCriteria(**crit)))
    assert tmsg == jmsg
    part = partition_rows(p16, 2, seed=0, method="band")
    for dt, kw in [(torch.float32, dict(replace_every=50)),
                   (torch.bfloat16, dict(replace_every=50, pipelined=True)),
                   (torch.bfloat16, dict(replace_every=50,
                                         precise_dots=True))]:
        jmsg = _refusal(lambda: JaxDistCG(
            JaxProblem.build(p16, part, 2, dtype=JDT[dt]), **kw))
        tmsg = _refusal(lambda: DistCGSolver(
            DistributedProblem.build(p16, part, 2, dtype=dt), device=CPU,
            **kw))
        assert tmsg == jmsg, kw


# -- RefinedSolver ------------------------------------------------------------

def test_refined_wrapper_matches_jax_on_one_inner_solver(p16):
    """Both wrappers around the same inner solver class (the JAX one, so
    the inner solves are identical): the same passes, inner iterations
    and bits of x -- the host refinement loop is the same."""
    _, b = _manufactured(p16, 5)
    crit = dict(maxits=20000, residual_rtol=1e-12)
    runs = []
    for W, C in ((JaxRefined, JaxCrit), (RefinedSolver, StoppingCriteria)):
        s = W(JaxCGSolver(jax_dev_matrix(p16, dtype=jnp.float32)), p16,
              inner_rtol=1e-4)
        runs.append((s.solve(b, criteria=C(**crit)), s.stats))
    (xj, jst), (xt, tst) = runs
    assert (tst.nrefine, tst.niterations, tst.converged) == \
        (jst.nrefine, jst.niterations, jst.converged)
    assert np.array_equal(xt, xj)


@pytest.mark.parametrize("dtype,kw", [
    (torch.float64, dict(inner_rtol=1e-4)),
    (torch.float32, dict(inner_rtol=1e-5, inner_maxits=20)),
    (torch.float32, dict(inner_rtol=1e-4)),
    (torch.bfloat16, dict(inner_rtol=1e-2))])
def test_refined_matches_jax(p16, dtype, kw):
    """Port inner solves against JAX inner solves: the same outer passes
    and x within 1e-10 relative.  The inner iteration total is the same
    where no pass's right-hand side is rounding noise (f64 inner solves;
    passes capped by ``inner_maxits``).  In f32 and bf16 the last pass
    solves for the storage rounding of the previous correction, which
    differs between the packages, so its count may too: the totals are
    held within 5 %."""
    xsol, b = _manufactured(p16, 5)
    crit = dict(maxits=20000, residual_rtol=1e-12)
    J = JaxRefined(JaxCGSolver(jax_dev_matrix(p16, dtype=JDT[dtype])), p16,
                   **kw)
    xj = J.solve(b, criteria=JaxCrit(**crit))
    T = RefinedSolver(TorchCGSolver(device_matrix_from_csr(
        p16, dtype=dtype, device=CPU), device=CPU), p16, **kw)
    xt = T.solve(b, criteria=StoppingCriteria(**crit))
    assert T.stats.nrefine == J.stats.nrefine >= 3
    assert T.stats.converged and J.stats.converged
    if dtype == torch.float64 or "inner_maxits" in kw:
        assert T.stats.niterations == J.stats.niterations
    else:
        assert abs(T.stats.niterations - J.stats.niterations) <= \
            0.05 * J.stats.niterations
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    assert np.linalg.norm(xt - xsol) < 1e-10


def test_refined_budget_stall_and_unbounded(p32):
    """The wrapper's contracts: the total inner budget holds, an
    unreachable tolerance raises, no tolerance spends the budget."""
    A = device_matrix_from_csr(p32, dtype=torch.float32, device=CPU)
    b = np.ones(p32.shape[0])
    s = RefinedSolver(TorchCGSolver(A, device=CPU), p32, inner_rtol=1e-6)
    with pytest.raises(NotConvergedError):
        s.solve(b, criteria=StoppingCriteria(maxits=37, residual_rtol=1e-14))
    assert s.stats.niterations <= 37
    with pytest.raises(NotConvergedError, match="refinement stalled"):
        s.solve(b, criteria=StoppingCriteria(maxits=2000,
                                             residual_rtol=1e-300))
    x = s.solve(b, criteria=StoppingCriteria(maxits=50))
    assert s.stats.converged and s.stats.niterations <= 50
    assert np.isfinite(x).all()


# -- the CLI ------------------------------------------------------------------

def _line(text, key):
    return next(line for line in text.splitlines()
                if line.strip().startswith(key + ":"))


def _keys(text):
    return {line.split(":")[0].strip() for line in text.splitlines()
            if ":" in line}


@pytest.mark.parametrize("extra", [
    ["--dtype", "f32", "--precise-dots", "--residual-rtol", "1e-6"],
    ["--dtype", "f32", "--precise-dots", "--residual-rtol", "1e-6",
     "--nparts", "3"],
    ["--dtype", "bf16", "--replace-every", "20", "--residual-rtol", "1e-4"],
    ["--dtype", "bf16", "--replace-every", "20", "--residual-rtol", "1e-4",
     "--nparts", "3", "--comm", "dma"],
    ["--dtype", "f32", "--refine", "--residual-rtol", "1e-12",
     "--refine-rtol", "1e-4"],
    ["--dtype", "f32", "--refine", "--residual-rtol", "1e-12",
     "--nparts", "3"]])
def test_cli_flags_match_jax_cli(tmp_path, capsys, extra):
    """Each flag through both CLIs on gen:poisson2d:20: the same
    iteration lines (``--refine``: within 5 %, as
    test_refined_matches_jax explains) and stats-block keys, and x within
    1e-5 relative (bf16: 5e-3)."""
    common = ["gen:poisson2d:20", "--manufactured-solution",
              "--max-iterations", "3000", "--warmup", "0"] + extra
    if "--nparts" not in extra:
        common += ["--comm", "none"]
    jx, tx = tmp_path / "j.bin", tmp_path / "t.bin"
    assert jax_main(common + ["-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(common + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    if "--refine" in extra:
        its = [int(_line(e, "iterations").split(":")[1].replace(",", ""))
               for e in (jerr, terr)]
        assert abs(its[1] - its[0]) <= 0.05 * its[0], its
    else:
        assert _line(terr, "iterations") == _line(jerr, "iterations")
    assert _keys(terr) == _keys(jerr)
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    bound = 5e-3 if "bf16" in extra else 1e-5
    assert np.linalg.norm(xt - xj) <= bound * np.linalg.norm(xj)


def test_cli_refine_inner_maxits_caps_each_pass(tmp_path, capsys):
    """``--refine-inner-maxits`` caps each inner solve (the JAX
    package's RefinedSolver ``inner_maxits``): the passes and inner
    iterations of the library wrapper with the same cap."""
    csr = _poisson(20)
    argv = ["gen:poisson2d:20", "--manufactured-solution", "--warmup", "0",
            "--dtype", "f32", "--refine", "--residual-rtol", "1e-12",
            "--refine-inner-maxits", "15", "--max-iterations", "3000",
            "--device", "cpu", "-q"]
    assert torch_main(argv) == 0
    terr = capsys.readouterr().err
    _, b = _manufactured(csr, 42)
    J = JaxRefined(JaxCGSolver(jax_dev_matrix(csr, dtype=jnp.float32)),
                   csr, inner_rtol=1e-5, inner_maxits=15)
    J.solve(b, criteria=JaxCrit(maxits=3000, residual_rtol=1e-12))
    assert _line(terr, "iterations") == f"  iterations: " \
        f"{J.stats.niterations:,}"


@pytest.mark.parametrize("extra,msg", [
    (["--dtype", "bf16", "--replace-every", "8", "--diff-rtol", "1e-3"],
     "--replace-every supports residual criteria only"),
    (["--dtype", "f32", "--replace-every", "8"],
     "replace_every is the bf16 tier's accuracy contract"),
    (["--dtype", "bf16", "--replace-every", "8", "--solver",
      "acg-pipelined"], "replace_every implements classic CG")])
def test_cli_replace_refusals_match_jax(capsys, extra, msg):
    argv = ["gen:poisson2d:8", "--warmup", "0", "-q"] + extra
    rcs, errs = [], []
    for main, more in ((jax_main, ["--comm", "none"]),
                       (torch_main, ["--device", "cpu"])):
        try:
            rcs.append(main(argv + more))
        except SystemExit as e:
            rcs.append(1 if e.code else 0)
            errs.append(str(e.code))
        errs.append(capsys.readouterr().err)
    assert rcs == [1, 1]
    assert sum(msg in e for e in errs) == 2, errs


def test_cli_refine_refused_at_gen_direct_sizes():
    """At gen-direct sizes --refine takes the sharded tier's df64
    refinement, which refuses f64 storage with the reference's message."""
    with pytest.raises(SystemExit, match=r"sharded --refine runs df64 outer "
                                         r"residuals over f32 inner solves"):
        torch_main(["gen:poisson3d:300", "--device", "cpu", "--refine"])
