"""The port's matrix-free tier (K7's plain version, the operator solves on
one part and on stacked parts, the CLI's --operator/--aniso and the
single-device gen-direct tier) against the JAX package's, and against
the port's own assembled tier.

Tolerances: the port's operator solves equal its assembled DIA solves
bitwise (same products, same order, no contraction on the CPU).  K7's
plain version equals the JAX kernel in interpret mode bitwise in 1D and
2D; in 3D XLA contracts the 6 * x term into a fused multiply-add, so
there within one rounding (rtol 2e-6 f32, 1e-15 f64).  Port against JAX
on the same operator: Poisson the same iterations and x within 1e-10;
aniso2d, whose coefficient products XLA contracts, iterations within 3
and x within rtol 1e-7 / atol 1e-9 (``tests/test_matfree.py:125-127``).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from acg_tpu.cli import main as jax_main
from acg_tpu.io.generators import aniso_poisson2d_coo as jax_aniso_coo
from acg_tpu.ops import operator as J
from acg_tpu.ops.pallas_kernels import stencil_spmv as jax_stencil_spmv
from acg_tpu.parallel.dist import DistributedProblem as JaxProblem
from acg_tpu.parallel.dist import arm_matfree as jax_arm_matfree
from acg_tpu.solvers.jax_cg import JaxCGSolver
from acg_tpu.solvers.stats import StoppingCriteria as JaxCrit
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.errors import AcgError
from acg_tpu_torch.io.generators import (aniso_poisson2d_coo,
                                         poisson_dia_device, poisson_mtx)
from acg_tpu_torch.io.mtxfile import read_mtx
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops import operator as T
from acg_tpu_torch.ops.spmv import device_matrix_from_csr
from acg_tpu_torch.parallel.dist import (DistCGSolver, DistributedProblem,
                                         arm_matfree)
from acg_tpu_torch.partition import partition_rows
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64,
                                                     torch.float64)}


def _csr(kind, n):
    if kind == "poisson":
        return SymCsrMatrix.from_mtx(poisson_mtx(n, dim=2)).to_csr()
    r, c, v, N = aniso_poisson2d_coo(n, 0.1)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def _op(kind, n, dtype=torch.float64):
    if kind == "poisson":
        return T.poisson_stencil(n, 2, dtype=dtype, device=CPU)
    return T.aniso2d_stencil(n, 0.1, dtype=dtype, device=CPU)


def _jop(kind, n):
    if kind == "poisson":
        return J.poisson_stencil(n, 2, dtype=jnp.float64)
    return J.aniso2d_stencil(n, 0.1, dtype=jnp.float64)


# -- K7's plain version ----------------------------------------------------

@pytest.mark.parametrize("dim,n,tile", [(1, 512, 128), (2, 32, 256),
                                        (3, 8, 128)])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_stencil_plain_matches_jax_kernel(dim, n, tile, dtype):
    jdt, tdt = DT[dtype]
    x = np.random.default_rng(dim).standard_normal(n ** dim)
    want = np.asarray(jax_stencil_spmv(J.poisson_stencil(n, dim, dtype=jdt),
                                       jnp.asarray(x, jdt), interpret=True,
                                       tile=tile, align=8))
    op = T.poisson_stencil(n, dim, dtype=tdt, device=CPU)
    got = K.stencil_spmv(op, torch.from_numpy(x).to(tdt)).numpy()
    assert K.launches["stencil_spmv"] == 0   # CPU: plain, not counted
    if dim < 3:
        np.testing.assert_array_equal(got, want)
    else:
        tol = {"f32": 2e-6, "f64": 1e-15}[dtype]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["poisson", "aniso2d"])
def test_stacked_plain_matches_jax_shard_mv(kind):
    """The armed stacked block (K7's stacked plain version for Poisson,
    the generated planes for aniso2d) against JAX's shard_mv per part,
    and the armed arrays against JAX's."""
    n = 20
    csr = _csr(kind, n)
    part = partition_rows(csr, 3, method="band")
    jprob = JaxProblem.build(csr, part, 3, dtype=jnp.float64)
    jax_arm_matfree(jprob, _jop(kind, n))
    prob = DistributedProblem.build(csr, part, 3)
    arm_matfree(prob, _op(kind, n))
    assert prob.local.format == jprob.local.format == "matfree"
    for a, b in zip(prob.local.arrays, jprob.local.arrays):
        np.testing.assert_array_equal(a, np.asarray(b).reshape(a.shape))
    x = np.random.default_rng(3).standard_normal((3, prob.nmax_owned))
    la = prob.local.to(torch.device(CPU), torch.float64)
    y = prob.local.mv(la, torch.from_numpy(x), use_kernel=True).numpy()
    if kind == "poisson":
        np.testing.assert_array_equal(y, K.stencil_spmv_plain(
            prob.operator, torch.from_numpy(x), la[0], la[1]).numpy())
    for p in range(3):
        arrays = tuple(jnp.asarray(np.asarray(a)[p])
                       for a in jprob.local.arrays)
        want = np.asarray(jprob.local.shard_mv(arrays, jnp.asarray(x[p])))
        if kind == "poisson":
            np.testing.assert_array_equal(y[p], want)
        else:
            np.testing.assert_allclose(y[p], want, rtol=1e-15, atol=1e-15)


def test_generated_local_planes_equal_assembled_stacking():
    n = 20
    for kind in ("poisson", "aniso2d"):
        csr = _csr(kind, n)
        part = partition_rows(csr, 4, method="band")
        asm = DistributedProblem.build(csr, part, 4)
        mf = arm_matfree(DistributedProblem.build(csr, part, 4), _op(kind, n))
        row0, nowned, *tables = mf.local.to(torch.device(CPU), torch.float64)
        gen = T.stencil_planes(kind, mf.operator.grid, mf.local.offsets,
                               tuple(tables), mf.nmax_owned, torch.float64,
                               row0=row0, nowned=nowned)
        assert asm.local.offsets == mf.local.offsets
        np.testing.assert_array_equal(gen.numpy(), asm.local.arrays[0])


# -- solves: matrix-free against assembled, in the port -------------------

def _b(N, seed=5):
    return np.random.default_rng(seed).standard_normal(N)


@pytest.mark.parametrize("kind", ["poisson", "aniso2d"])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("kernels", ["xla", "pallas"])
def test_single_part_matfree_equals_assembled(kind, pipelined, kernels):
    n = 16
    csr = _csr(kind, n)
    b = _b(csr.shape[0])
    crit = StoppingCriteria(maxits=800, residual_rtol=1e-10)
    out = []
    for A in (device_matrix_from_csr(csr, dtype=torch.float64, device=CPU),
              _op(kind, n)):
        s = TorchCGSolver(A, pipelined=pipelined, kernels=kernels,
                          device=CPU)
        out.append((s.solve(b, criteria=crit), s.stats.niterations))
    assert out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][0], out[1][0])


@pytest.mark.parametrize("kind", ["poisson", "aniso2d"])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("comm,kernels", [("xla", "xla"),
                                          ("dma", "pallas")])
def test_stacked_matfree_equals_assembled(kind, pipelined, comm, kernels):
    n = 16
    csr = _csr(kind, n)
    b = _b(csr.shape[0])
    part = partition_rows(csr, 4, method="band")
    crit = StoppingCriteria(maxits=800, residual_rtol=1e-10)
    out = []
    for armed in (False, True):
        prob = DistributedProblem.build(csr, part, 4)
        if armed:
            arm_matfree(prob, _op(kind, n))
        s = DistCGSolver(prob, pipelined=pipelined, comm=comm,
                         kernels=kernels, device=CPU)
        out.append((s.solve(b, criteria=crit), s.stats.niterations,
                    s.stats.ops["gemv"].bytes))
    assert out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[1][2] < out[0][2]   # the tables in place of the planes


# -- solves: the port against JAX on the same operator --------------------

@pytest.mark.parametrize("kind", ["poisson", "aniso2d"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_operator_solve_matches_jax(kind, pipelined):
    n = 16
    b = _b(n * n, seed=6)
    js = JaxCGSolver(_jop(kind, n), pipelined=pipelined, kernels="xla")
    xj = np.asarray(js.solve(b, criteria=JaxCrit(maxits=800,
                                                 residual_rtol=1e-10)))
    ts = TorchCGSolver(_op(kind, n), pipelined=pipelined, device=CPU)
    xt = ts.solve(b, criteria=StoppingCriteria(maxits=800,
                                               residual_rtol=1e-10))
    if kind == "poisson":
        assert ts.stats.niterations == js.stats.niterations
        assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    else:
        assert abs(ts.stats.niterations - js.stats.niterations) <= 3
        np.testing.assert_allclose(xt, xj, rtol=1e-7, atol=1e-9)
    if ts.stats.niterations == js.stats.niterations:
        for key in ("gemv", "dot", "axpy"):
            assert ts.stats.ops[key].n == js.stats.ops[key].n
        assert ts.stats.nflops == pytest.approx(js.stats.nflops, rel=1e-12)


# -- refusals ----------------------------------------------------------------

def test_arm_matfree_refusals():
    n = 16
    csr = _csr("aniso2d", n)
    prob = DistributedProblem.build(
        csr, partition_rows(csr, 4, seed=0, method="graph"), 4)
    with pytest.raises(AcgError, match="band partition"):
        arm_matfree(prob, _op("aniso2d", n))
    prob = DistributedProblem.build(
        csr, partition_rows(csr, 4, method="band"), 4)
    with pytest.raises(AcgError, match="rows"):
        arm_matfree(prob, _op("aniso2d", 8))
    with pytest.raises(AcgError, match="dtype"):
        arm_matfree(prob, _op("aniso2d", n, dtype=torch.float32))
    T.register_operator("torch_dist_refusal_probe", lambda caps, x: x)
    with pytest.raises(AcgError, match="single-device"):
        arm_matfree(prob, T.user_operator("torch_dist_refusal_probe",
                                          csr.shape[0], device=CPU))
    assert prob.local.format == "dia" and prob.operator is None


def test_solver_refusals_and_user_operator_solve():
    op = _op("poisson", 8)
    with pytest.raises(ValueError, match="bf16"):
        TorchCGSolver(op, vector_dtype=torch.bfloat16, device=CPU)
    with pytest.raises(ValueError, match="needs a square DIA"):
        TorchCGSolver(_op("poisson", 8, torch.float32), kernels="fused",
                      device=CPU)
    with pytest.raises(ValueError, match="no stencil kernel"):
        TorchCGSolver(op, kernels="pallas", vector_dtype=torch.float32,
                      device=CPU)
    assert TorchCGSolver(op, device=CPU).kernels == "xla"
    assert TorchCGSolver(op, kernels="pallas",
                         device=CPU).kernels == "pallas-plain"
    # a registered user operator solves through the same loops
    d = torch.linspace(1.0, 4.0, 64, dtype=torch.float64)
    T.register_operator("torch_solve_diag", lambda caps, x: caps[0] * x,
                        nnz=64)
    uop = T.user_operator("torch_solve_diag", 64, dtype=torch.float64,
                          captures=(d,), device=CPU)
    b = _b(64)
    x = TorchCGSolver(uop, kernels="pallas", device=CPU).solve(
        b, criteria=StoppingCriteria(maxits=200, residual_rtol=1e-12))
    np.testing.assert_allclose(x, b / d.numpy(), rtol=1e-10)


# -- CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["gen:poisson2d:12", "--operator", "stencil", "--dtype", "bf16"],
    ["gen:poisson2d:12", "--operator", "stencil", "--dtype", "mixed"],
    ["gen:poisson2d:12", "--operator", "stencil", "--spmv-format", "ell"],
    ["gen:poisson2d:12", "--operator", "stencil", "--epsilon", "0.5"],
    ["gen:poisson2d:12", "--operator", "stencil:poisson4d:8"],
    ["gen:poisson2d:12", "--operator", "stencil:poisson2d:16"],
    ["gen:poisson2d:12", "--operator", "stencil:aniso2d:12:0.1"],
    ["gen:poisson2d:12", "--operator", "stencil:aniso2d:12:0.1",
     "--aniso", "0.5"],
    ["gen:irregular:200", "--operator", "stencil"],
    ["gen:poisson2d:12", "--aniso", "1.5"],
    ["gen:poisson3d:6", "--aniso", "0.5"],
    ["A.mtx", "--operator", "stencil"],
    ["gen:poisson2d:12", "--operator", "user:no_such_cli_operator"]])
def test_cli_refusals_match_jax(argv, capsys):
    """The port refuses what acg_tpu refuses, the same way (an exit
    message, or exit status 1 after the error line), with the same text
    after the program name."""
    def refusal(main, extra):
        try:
            rc = main(argv + extra + ["-q", "--warmup", "0"])
        except SystemExit as e:
            return "exit", str(e.code)
        assert rc == 1
        return "rc 1", capsys.readouterr().err.strip().splitlines()[-1]

    jhow, jmsg = refusal(jax_main, ["--comm", "none"])
    thow, tmsg = refusal(torch_main, ["--device", "cpu"])
    assert jhow == thow
    # each package keeps its own registry of user operators
    jmsg, tmsg = (re.sub(r"\(known: [^)]*\)", "", m) for m in (jmsg, tmsg))
    assert jmsg.startswith("acg-tpu: ") and tmsg.startswith("acg-tpu-torch: ")
    assert (tmsg.split(": ", 1)[1].replace("acg_tpu_torch.", "acg_tpu.")
            == jmsg.split(": ", 1)[1])


def _run_cli(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().err


def _line(text, key):
    return next(line for line in text.splitlines()
                if line.strip().startswith(key + ":"))


@pytest.mark.parametrize("extra", [["--nparts", "4", "--comm", "dma"],
                                   ["--solver", "acg-pipelined",
                                    "--comm", "none", "--kernels",
                                    "pallas"],
                                   ["--aniso", "0.2", "--comm", "none"]])
def test_cli_operator_writes_the_assembled_bytes(tmp_path, capsys, extra):
    base = ["gen:poisson2d:20", "--device", "cpu", "--manufactured-solution",
            "--residual-rtol", "1e-10", "--max-iterations", "600",
            "--warmup", "0"] + extra
    a, m = tmp_path / "a.bin", tmp_path / "m.bin"
    ea = _run_cli(torch_main, base + ["-o", str(a)], capsys)
    em = _run_cli(torch_main, base + ["--operator", "stencil", "-o", str(m)],
                  capsys)
    assert a.read_bytes() == m.read_bytes()
    assert _line(ea, "iterations") == _line(em, "iterations")


def test_cli_aniso_matches_jax(tmp_path, capsys):
    argv = ["gen:poisson2d:16", "--aniso", "0.1", "--operator", "stencil",
            "--manufactured-solution", "--residual-rtol", "1e-9",
            "--max-iterations", "800", "--warmup", "0"]
    jx, tx = tmp_path / "j.bin", tmp_path / "t.bin"
    jerr = _run_cli(jax_main, argv + ["--comm", "none", "-o", str(jx)], capsys)
    terr = _run_cli(torch_main, argv + ["--device", "cpu", "-o", str(tx)],
                    capsys)
    ij = int(_line(jerr, "iterations").split(":")[1])
    it = int(_line(terr, "iterations").split(":")[1])
    assert abs(ij - it) <= 3
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    np.testing.assert_allclose(xt, xj, rtol=1e-7, atol=1e-9)
    r, c, v, N = jax_aniso_coo(16, 0.1)
    assert N == xt.size


def _stats_lines(text):
    """The stats block's lines without times and rates (which differ
    from run to run) and the residual's last digits."""
    out = []
    for line in text.splitlines():
        if (":" not in line or "seconds" in line or "rate" in line
                or line.strip().startswith("residual 2-norm")):
            continue
        out.append(line)
    return out


@pytest.mark.parametrize("extra", [[], ["--operator", "stencil"],
                                   ["--solver", "acg-pipelined"]])
def test_gen_direct_matches_jax_cli(monkeypatch, tmp_path, capsys, extra):
    """Above ACG_TPU_GEN_DIRECT_MIN rows a gen:poisson spec runs with no
    host matrix, b = ones: the same iterations and stats lines as
    acg_tpu.cli with the same flags, x within 1e-10."""
    monkeypatch.setenv("ACG_TPU_GEN_DIRECT_MIN", "100")
    argv = ["gen:poisson3d:8", "--warmup", "0", "--max-iterations", "60",
            "--residual-rtol", "1e-10"] + extra
    jx, tx = tmp_path / "j.bin", tmp_path / "t.bin"
    jerr = _run_cli(jax_main, argv + ["-o", str(jx)], capsys)
    terr = _run_cli(torch_main, argv + ["--device", "cpu", "-v", "-o",
                                        str(tx)], capsys)
    assert "gen-direct" in terr and "no host matrix" in terr
    assert "synthesizing" not in terr
    assert _stats_lines(terr)[-20:] == _stats_lines(jerr)[-20:]
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert xt.size == 512
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


def test_gen_direct_operator_and_planes_agree(monkeypatch, tmp_path,
                                              capsys):
    monkeypatch.setenv("ACG_TPU_GEN_DIRECT_MIN", "100")
    outs = []
    for extra in ([], ["--operator", "stencil"]):
        out = tmp_path / f"x{len(outs)}.bin"
        _run_cli(torch_main, ["gen:poisson2d:24", "--device", "cpu",
                              "--warmup", "0", "--max-iterations", "40",
                              "--residual-rtol", "0", "-o", str(out)]
                 + extra, capsys)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("extra,flag", [
    (["--nparts", "4"], "--nparts 4"),
    (["--manufactured-solution"], "--manufactured-solution")])
def test_gen_direct_sharded_branch_is_refused_by_name(monkeypatch, extra,
                                                      flag):
    """Each flag takes the sharded branch of the gen-direct tier, which
    runs stored planes: an armed operator is refused by name there."""
    monkeypatch.setenv("ACG_TPU_GEN_DIRECT_MIN", "100")
    with pytest.raises(SystemExit) as e:
        torch_main(["gen:poisson3d:8", "--device", "cpu", "--operator",
                    "stencil"] + extra)
    msg = str(e.value.code)
    assert ("--operator does not reach the sharded gen-direct tier"
            in msg), (flag, msg)


def test_gen_direct_device_planes_bitwise_to_host_build(monkeypatch):
    """The gen-direct planes are the host CSR's DIA planes, bitwise."""
    csr = SymCsrMatrix.from_mtx(poisson_mtx(9, dim=3)).to_csr()
    A = device_matrix_from_csr(csr, dtype=torch.float64, device=CPU)
    planes, offsets, N = poisson_dia_device(9, 3, dtype=torch.float64,
                                            device=CPU)
    assert offsets == A.offsets and N == A.nrows
    assert torch.equal(planes, A.data)


_NO_JAX_GEN_DIRECT = """
import os, sys
sys.modules["jax"] = None
sys.modules["acg_tpu"] = None
os.environ["ACG_TPU_GEN_DIRECT_MIN"] = "100"
from acg_tpu_torch.cli import main
for extra in ([], ["--operator", "stencil"]):
    assert main(["gen:poisson3d:6", "--device", "cpu", "-q", "--warmup",
                 "0", "--max-iterations", "50"] + extra) == 0
loaded = [m for m, v in sys.modules.items() if v is not None
          and (m.split(".")[0] in ("jax", "jaxlib", "acg_tpu"))]
assert not loaded, loaded
print("NO-JAX-GEN-DIRECT-OK")
"""


def test_gen_direct_imports_neither_jax_nor_acg_tpu():
    res = subprocess.run([sys.executable, "-c", _NO_JAX_GEN_DIRECT],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NO-JAX-GEN-DIRECT-OK" in res.stdout
