"""The port's sharded gen-direct tier (``acg_tpu_torch.parallel.
sharded_dia``, ``gen:`` specs above ``ACG_TPU_GEN_DIRECT_MIN`` under
``--nparts``, ``--manufactured-solution`` or ``--refine``) against the
JAX package's (``tests/test_sharded_dia.py``, the cases without
multi-controller or HLO content), on the conftest's CPU mesh.

The port keeps its vectors whole and runs the SpMV over row parts, so
its sharded solves are bitwise its single-device solves; K1 on the
whole planes (its plain version here) is bitwise the roll SpMV, and both are
bitwise the JAX roll SpMV in f32 (every product by a Poisson plane
value, -1 or 2d, is exact).  Against JAX's sharded solves the f64
iterations agree and x within 1e-10 relative (JAX psums per-shard dots).
JAX draws manufactured solutions with ``jax.random``: parity runs hand
the port JAX's x.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.cli import main as jax_main
from acg_tpu.io.generators import poisson_mtx as jax_poisson_mtx
from acg_tpu.matrix import SymCsrMatrix as JaxSymCsr
from acg_tpu.ops.spmv import dia_mv_roll as jax_dia_mv_roll
from acg_tpu.parallel.sharded_dia import \
    build_sharded_poisson_solver as jax_build
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.io.generators import poisson_mtx
from acg_tpu_torch.io.mtxfile import read_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops.spmv import device_matrix_from_csr, dia_from_csr
from acg_tpu_torch.parallel.sharded_dia import (
    ShardedDiaCGSolver, build_sharded_poisson_solver, dia_mv_roll_df,
    spot_check_manufactured)
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _csr(n, dim):
    csr = SymCsrMatrix.from_mtx(poisson_mtx(n, dim=dim)).to_csr()
    jcsr = JaxSymCsr.from_mtx(jax_poisson_mtx(n, dim=dim)).to_csr()
    assert (csr != jcsr).nnz == 0
    return csr


def _build(n, dim, nparts=4, **kw):
    kw.setdefault("device", CPU)
    return build_sharded_poisson_solver(n, dim, nparts=nparts, **kw)


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
def test_sharded_spmv_matches_scipy_and_jax(dim, n):
    """Both forms against scipy (1e-5 relative in f32, the reference's
    bound), K1 on the whole planes bitwise the roll form, and the roll form
    bitwise JAX's roll SpMV over JAX's sharded planes."""
    csr = _csr(n, dim)
    x = np.random.default_rng(0).standard_normal(n ** dim).astype(np.float32)
    y_ref = csr @ x.astype(np.float64)
    ys = []
    for kernels in ("pallas", "xla"):
        s = _build(n, dim, nparts=8, kernels=kernels)
        assert s.kernels == {"pallas": "pallas-roll-plain",
                             "xla": "xla-roll"}[kernels]
        y = s._spmv_of()(s.A, torch.from_numpy(x))
        assert y.dtype == torch.float32 and y.shape == (n ** dim,)
        ys.append(y)
        y64 = y.double().numpy()
        assert np.linalg.norm(y64 - y_ref) <= 1e-5 * np.linalg.norm(y_ref)
    assert torch.equal(ys[0], ys[1])
    js = jax_build(n, dim, nparts=8)
    yj = np.asarray(jax_dia_mv_roll(js.A.data, js.A.offsets,
                                    jnp.asarray(x)))
    np.testing.assert_array_equal(ys[1].numpy(), yj)


@pytest.mark.parametrize("kernels", ["pallas", "xla"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_sharded_solve_matches_unsharded_and_jax(pipelined, kernels):
    """The 4-part solve is bitwise the single-device solve of the same
    planes (the dots and updates are the single-device tier's), and
    takes JAX's sharded iterations with x within 1e-10 in f64."""
    n, dim = 24, 2
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-10)
    s = _build(n, dim, dtype=F64, pipelined=pipelined, kernels=kernels)
    x = s.solve(s.ones_b(), criteria=crit, host_result=False).numpy()
    A = device_matrix_from_csr(_csr(n, dim), dtype=F64, device=CPU)
    ref = TorchCGSolver(A, pipelined=pipelined, device=CPU,
                        kernels="pallas" if kernels == "pallas" else "xla")
    x1 = ref.solve(np.ones(n ** dim), criteria=crit)
    assert s.stats.converged and ref.stats.converged
    assert s.stats.niterations == ref.stats.niterations
    np.testing.assert_array_equal(x, x1)
    js = jax_build(n, dim, nparts=4, dtype=jnp.float64, pipelined=pipelined)
    xj = np.asarray(js.solve(js.ones_b(), criteria=JaxCrit(
        maxits=2000, residual_rtol=1e-10), host_result=False))
    assert s.stats.niterations == js.stats.niterations
    assert np.linalg.norm(x - xj) <= 1e-10 * np.linalg.norm(xj)


def test_sharded_manufactured_b_matches_scipy_and_jax():
    """JAX's manufactured x handed to the port gives JAX's b within 1e-7
    (the products are exact, but XLA reassociates the jitted f32 sum:
    19 % of the entries differ by an ulp), and b matches scipy; the
    port's own draw is a unit-norm x from a seeded generator, the same
    for the same seed."""
    n, dim = 16, 3
    js = jax_build(n, dim, nparts=8)
    jx, jb = js.manufactured(seed=7)
    s = _build(n, dim, nparts=8)
    xsol, b = s.manufactured(seed=7, xsol=np.asarray(jx))
    np.testing.assert_array_equal(xsol.numpy(), np.asarray(jx))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(b.double().numpy(),
                               _csr(n, dim) @ xsol.double().numpy(),
                               atol=1e-5)
    x1, b1 = s.manufactured(seed=7)
    x2, _ = s.manufactured(seed=7)
    assert x1.dtype == torch.float32 and torch.equal(x1, x2)
    assert float(torch.linalg.norm(x1.double())) == pytest.approx(1.0,
                                                                 abs=1e-5)
    np.testing.assert_allclose(b1.double().numpy(),
                               _csr(n, dim) @ x1.double().numpy(), atol=1e-5)


def test_sharded_mixed_dtype():
    """bf16 planes with f32 vectors solve bitwise like all-f32 (the
    Poisson planes are exact in bf16), on both SpMV forms."""
    crit = StoppingCriteria(maxits=400, residual_rtol=1e-6)
    for kernels in ("pallas", "xla"):
        s32 = _build(24, 2, nparts=8, kernels=kernels)
        x32 = s32.solve(s32.ones_b(), criteria=crit, host_result=False)
        sm = _build(24, 2, nparts=8, kernels=kernels, dtype=torch.bfloat16,
                    vector_dtype=torch.float32)
        xm = sm.solve(sm.ones_b(), criteria=crit, host_result=False)
        assert torch.equal(x32, xm)


def test_epsilon_shift_applies():
    """--epsilon shifts the diagonal (the spot check's stencil is then
    gone), and both SpMV forms solve alike."""
    s = _build(8, 2, nparts=2, epsilon=1.5, kernels="pallas")
    js = jax_build(8, 2, nparts=2, epsilon=1.5)
    d = s.A.offsets.index(0)
    assert float(s.A.data[d][0]) == pytest.approx(4.0 + 1.5)
    np.testing.assert_array_equal(s.A.data.numpy(),
                                  np.stack([np.asarray(p)
                                            for p in js.A.data]))
    assert s.stencil is None
    crit = StoppingCriteria(maxits=200, residual_rtol=1e-6)
    x = s.solve(s.ones_b(), criteria=crit, host_result=False)
    r = _build(8, 2, nparts=2, epsilon=1.5, kernels="xla")
    assert torch.equal(x, r.solve(r.ones_b(), criteria=crit,
                                  host_result=False))


def test_dia_mv_roll_df_matches_f64():
    """The double-float roll SpMV agrees with f64 to df64 class."""
    csr = _csr(16, 3)
    A = dia_from_csr(csr, dtype=torch.float32, device=CPU)
    x = np.random.default_rng(0).standard_normal(csr.shape[0]).astype(
        np.float32)
    xt = torch.from_numpy(x)
    yh, yl = dia_mv_roll_df(A.data, A.offsets, xt, torch.zeros_like(xt))
    y = yh.double().numpy() + yl.double().numpy()
    ref = csr @ x.astype(np.float64)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-13


@pytest.mark.parametrize("kernels", ["xla-roll", "pallas-roll"])
def test_sharded_refine_reaches_f64_class_error(kernels):
    """df64 outer residuals over f32 inner solves reach 1e-9-class
    solution error (the reference's bounds), on either SpMV form."""
    s = _build(16, 3, nparts=8, kernels=kernels)
    xsol, b = s.manufactured_df(seed=0)
    xh, xl = s.solve_refined(b, criteria=StoppingCriteria(
        maxits=20000, residual_rtol=1e-11), inner_rtol=1e-5)
    err0, err = s.error_norms_df(xh, xl, xsol)
    assert err0 == pytest.approx(1.0, rel=1e-5)
    assert err < 1e-8
    assert s.stats.nrefine >= 2
    csr = _csr(16, 3)
    x64 = xh.double().numpy() + xl.double().numpy()
    b64 = b[0].double().numpy() + b[1].double().numpy()
    assert np.linalg.norm(b64 - csr @ x64) / np.linalg.norm(b64) < 1e-10


def test_sharded_refine_with_jax_manufactured_x():
    """The refine of JAX's manufactured system (its x handed over) reaches
    f64-class error beside JAX's own refine of it."""
    js = jax_build(16, 3, nparts=8)
    jx, jb = js.manufactured_df(seed=3)
    jh, jl = js.solve_refined(jb, criteria=JaxCrit(maxits=20000,
                                                   residual_rtol=1e-11))
    _, jerr = js.error_norms_df(jh, jl, jx)
    s = _build(16, 3, nparts=8)
    xsol, b = s.manufactured_df(xsol=np.asarray(jx))
    xh, xl = s.solve_refined(b, criteria=StoppingCriteria(
        maxits=20000, residual_rtol=1e-11))
    _, err = s.error_norms_df(xh, xl, xsol)
    assert err < 1e-8 and jerr < 1e-8


def test_spot_check_catches_corrupt_b():
    s = _build(12, 2)
    xsol, b = s.manufactured(seed=1)
    assert spot_check_manufactured(s, xsol, b, nsample=64) < 1e-6
    bad = b.clone()
    bad[137] *= 1.01
    assert spot_check_manufactured(s, xsol, bad, nsample=4096) > 1e-4


def test_sharded_pallas_roll_with_bf16rr():
    """K1 on the whole planes composes with the sound-bf16 replacement
    program (f32 b, bf16 inner solves)."""
    s = _build(32, 2, nparts=8, dtype=torch.bfloat16,
               vector_dtype=torch.bfloat16, replace_every=25,
               kernels="pallas")
    xsol, b = s.manufactured(seed=1)
    assert b.dtype == torch.float32
    x = s.solve(b, criteria=StoppingCriteria(maxits=800, residual_rtol=1e-5),
                host_result=False, raise_on_divergence=False)
    b64 = b.double().numpy()
    rel = (np.linalg.norm(b64 - _csr(32, 2) @ x.double().numpy())
           / np.linalg.norm(b64))
    assert rel < 1e-4


def test_sharded_sstep_rides_the_sharded_spmv():
    """--algorithm rides the inherited programs: sstep:4 over K1 on the
    whole planes takes the single-device sstep:4's iterations and bits."""
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-8)
    s = _build(24, 2, dtype=F64, kernels="pallas", algorithm="sstep:4")
    x = s.solve(s.ones_b(), criteria=crit, host_result=False)
    A = device_matrix_from_csr(_csr(24, 2), dtype=F64, device=CPU)
    ref = TorchCGSolver(A, device=CPU, kernels="pallas", algorithm="sstep:4")
    x1 = ref.solve(np.ones(24 * 24), criteria=crit)
    assert s.stats.niterations == ref.stats.niterations
    np.testing.assert_array_equal(x.numpy(), x1)


@pytest.mark.parametrize("option,value", [
    ("health", object()), ("ckpt", object()), ("recovery", object()),
    ("trace", 8), ("progress", 10)])
def test_unported_options_refused_by_name(option, value):
    """The robustness hooks are refused by name on the sharded tier;
    trace/progress ride its programs, the CA recurrences' too since
    their ring and heartbeat were ported."""
    if option in ("trace", "progress"):
        s = _build(8, 2, **{option: value}, algorithm="sstep:2")
        assert getattr(s, option) == value
        return
    with pytest.raises(ValueError, match=option):
        _build(8, 2, **{option: value})


def test_one_part_runs_k1_on_the_whole_planes():
    """One part: K1 (its plain version here) on the whole planes, bitwise
    the roll SpMV's solve."""
    crit = StoppingCriteria(maxits=500, residual_rtol=1e-10)
    xs = []
    for kernels in ("pallas", "xla"):
        s = _build(12, 3, nparts=1, dtype=F64, kernels=kernels)
        xs.append(s.solve(s.ones_b(), criteria=crit, host_result=False))
    assert s.kernels == "xla-roll" and torch.equal(xs[0], xs[1])


@pytest.mark.parametrize("n,nparts", [(7, 4), (8, 3), (4, 16)])
def test_any_parts_run_k1_on_the_whole_planes(n, nparts):
    """Parts that do not divide N, or are narrower than the band, refuse
    nothing: K1 on the whole planes runs, bitwise the roll SpMV's solve;
    auto keeps the roll SpMV on the CPU."""
    crit = StoppingCriteria(maxits=500, residual_rtol=1e-10)
    s = _build(n, 2, nparts=nparts, dtype=F64, kernels="pallas")
    assert s.kernels == "pallas-roll-plain"
    r = _build(n, 2, nparts=nparts, dtype=F64)
    assert r.kernels == "xla-roll"
    assert torch.equal(s.solve(s.ones_b(), criteria=crit, host_result=False),
                       r.solve(r.ones_b(), criteria=crit, host_result=False))


def _cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, ACG_TPU_GEN_DIRECT_MIN="0",
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "acg_tpu_torch"] + args,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def _err(text):
    return float([ln for ln in text.splitlines()
                  if ln.startswith("error 2-norm:")][0].split(":")[1])


def test_cli_sharded_refine(tmp_path):
    """gen: sharded --refine reports 1e-9-class error and the spot-check
    line, and writes the df64 sum (not f32-representable values)."""
    out = tmp_path / "x.bin.mtx"
    r = _cli(["gen:poisson3d:16", "--device", "cpu", "--nparts", "8",
              "--refine", "--dtype", "f32", "--manufactured-solution",
              "--max-iterations", "20000", "--residual-rtol", "1e-11",
              "--warmup", "0", "--quiet", "-o", str(out)])
    assert r.returncode == 0, r.stderr
    assert "manufactured-b spot check" in r.stderr
    assert _err(r.stderr) < 1e-8
    x = np.asarray(read_mtx(str(out), binary=True).vals).reshape(-1)
    assert x.size == 16 ** 3
    assert not np.array_equal(x, x.astype(np.float32).astype(np.float64))


def test_cli_sharded_replace_every():
    r = _cli(["gen:poisson2d:48", "--device", "cpu", "--nparts", "8",
              "--dtype", "bf16", "--replace-every", "25",
              "--manufactured-solution", "--max-iterations", "4000",
              "--residual-rtol", "1e-5", "--warmup", "0", "--quiet"])
    assert r.returncode == 0, r.stderr
    dev = float(r.stderr.split("max rel dev ")[1].split()[0])
    assert dev < 1e-5   # an f32-manufactured b, not bf16-rounded


def test_cli_sharded_plain_bf16_spot_check_threshold():
    r = _cli(["gen:poisson2d:24", "--device", "cpu", "--nparts", "8",
              "--dtype", "bf16", "--manufactured-solution",
              "--max-iterations", "400", "--warmup", "0", "--quiet"])
    assert r.returncode == 0, r.stderr
    assert "FAILED the independent spot check" not in r.stderr


def _line(text, key):
    return next(line for line in text.splitlines()
                if line.strip().startswith(key + ":"))


@pytest.mark.parametrize("extra", [[], ["--epsilon", "0.5"],
                                   ["--solver", "acg-pipelined"]])
def test_cli_sharded_matches_jax_cli(tmp_path, capsys, monkeypatch, extra):
    """gen-direct --nparts 4 on b = ones: the JAX CLI's iterations and x
    within 1e-10 in f64."""
    monkeypatch.setenv("ACG_TPU_GEN_DIRECT_MIN", "100")
    argv = ["gen:poisson3d:12", "--nparts", "4", "--max-iterations", "500",
            "--residual-rtol", "1e-10", "--warmup", "0"] + extra
    jx, tx = tmp_path / "jax.bin", tmp_path / "torch.bin"
    assert jax_main(argv + ["-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    assert _line(terr, "iterations") == _line(jerr, "iterations")
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


@pytest.mark.parametrize("extra", [["--nparts", "4", "--kernels", "fused"],
                                   ["--nparts", "4", "--operator",
                                    "stencil"],
                                   ["--refine"]])
def test_cli_sharded_refusals_match_jax(monkeypatch, capsys, extra):
    """The refusals the sharded branch keeps, with the reference's
    messages (the port's --operator message names its stored planes)."""
    monkeypatch.setenv("ACG_TPU_GEN_DIRECT_MIN", "100")
    msgs = []
    for main, more in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        try:
            rc = main(["gen:poisson3d:8", "--warmup", "0"] + extra + more)
            msg = capsys.readouterr().err.strip()
        except SystemExit as e:
            rc, msg = 1, str(e.code)
        assert rc == 1
        msgs.append(msg.split(": ", 1)[1])
    if "--operator" in extra:
        assert all("--operator does not reach the sharded gen-direct tier"
                   in m for m in msgs)
    else:
        assert msgs[0] == msgs[1]


def test_solver_refuses_rectangular_planes():
    s = _build(8, 2)
    A = s.A
    A2 = type(A)(data=A.data, offsets=A.offsets, nrows=A.nrows,
                 ncols_padded=A.nrows + 1)
    with pytest.raises(ValueError, match="square"):
        ShardedDiaCGSolver(A2, device=CPU)
