"""The port on the CUDA card: each kernel against its plain version, and
each solver tier on the card against the same solve on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no interpret mode).  The file imports neither JAX nor
acg_tpu, so it also runs on a machine that has only PyTorch; there,
without the repository's conftest (which provisions JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from acg_tpu_torch.io.generators import poisson_dia
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.ops.spmv import device_matrix_from_arrays
from acg_tpu_torch.solvers import StoppingCriteria, TorchCGSolver

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def test_kernels_match_plain_on_card(dev):
    """Vectors bitwise-equal (--fmad=false), dots within 1e-5 relative
    (another summation order)."""
    planes, offsets, N = poisson_dia(256, 2)
    P = torch.from_numpy(np.stack(planes)).to(dev)
    ot = torch.tensor(offsets, device=dev)
    g = torch.Generator().manual_seed(0)
    vecs = [torch.randn(N, generator=g, dtype=torch.float64).to(dev)
            for _ in range(7)]
    for pdt, xdt in sorted(K.DIA_SPMV_TYPES, key=str):
        x = vecs[0].to(xdt)
        y, d = K.dia_spmv(P.to(pdt), offsets, x, offsets_t=ot, with_dot=True)
        yr, dr = K.dia_spmv_plain(P.to(pdt), offsets, x, with_dot=True)
        assert torch.equal(y, yr)
        assert float(d) == pytest.approx(float(dr), rel=1e-5)
    for pdt, vdt in sorted(K.FUSED_TYPES, key=str):
        r, po, x = (v.to(vdt) for v in vecs[:3])
        gm, gp = (torch.tensor(v, device=dev) for v in (2.0, 4.0))
        a = K.cg_phase_a(P.to(pdt), offsets, r, po, gm, gp, offsets_t=ot)
        b = K.cg_phase_a_plain(P.to(pdt), offsets, r, po, gm, gp)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert float(a[2]) == pytest.approx(float(b[2]), rel=1e-5)
        pd = torch.tensor(1.5, device=dev)
        want = K.cg_phase_b_plain(x, a[0], r, a[1], gm, pd)
        got = K.cg_phase_b(x.clone(), a[0], r.clone(), a[1], gm, pd)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)
    for vdt in (torch.float64, torch.float32, torch.bfloat16):
        vs = [v.to(vdt) for v in vecs]
        al, be = (torch.tensor(v, dtype=K.acc_dtype(vdt), device=dev)
                  for v in (0.37, 0.81))
        want = K.pipelined_update_plain(*vs, al, be)
        got = K.pipelined_update(*[v.clone() for v in vs[:6]], vs[6], al, be)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(64, dtype=torch.float32, device=dev)
    P = torch.zeros((1, 64), dtype=torch.float32, device=dev)
    ot = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="no kernel"):
        K.dia_spmv(P, (0,), x.to(torch.bfloat16), offsets_t=ot)
    with pytest.raises(ValueError, match="contiguous"):
        K.dia_spmv(P, (0,), torch.zeros(128, device=dev)[::2], offsets_t=ot)
    with pytest.raises(ValueError, match="offsets_t"):
        K.dia_spmv(P, (0,), x)


@pytest.mark.parametrize("pipelined,kernels,dtype", [
    (False, "pallas", torch.float64), (True, "pallas", torch.float64),
    (False, "fused", torch.float32), (False, "pallas", torch.bfloat16)])
def test_solvers_on_card_match_cpu(dev, pipelined, kernels, dtype):
    """A tolerance-driven solve on the card takes the CPU's iteration
    count (frozen state at convergence, read once per chunk) and agrees
    with the CPU's iterate to the dot products' summation order."""
    planes, offsets, N = poisson_dia(128, 2)
    planes[offsets.index(0)] = planes[offsets.index(0)] + 0.5
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    b = np.random.default_rng(5).standard_normal(N)
    rtol = {torch.float64: 1e-10, torch.float32: 1e-5,
            torch.bfloat16: 1e-2}[dtype]
    crit = StoppingCriteria(maxits=3000, residual_rtol=rtol)
    out = {}
    for d in ("cpu", dev):
        A = device_matrix_from_arrays("dia", planes, meta, dtype=dtype,
                                      device=d)
        s = TorchCGSolver(A, pipelined=pipelined, kernels=kernels, device=d)
        out[str(d)] = (s.solve(b, criteria=crit), s.stats.niterations,
                       s.kernels)
    (xc, kc, nc), (xg, kg, ng) = out["cpu"], out[str(dev)]
    assert ng == kernels and nc == kernels + "-plain"
    assert abs(kg - kc) <= (0 if dtype == torch.float64 else 2)
    tol = {torch.float64: 1e-10, torch.float32: 1e-4,
           torch.bfloat16: 5e-2}[dtype]
    assert np.linalg.norm(xg - xc) <= tol * np.linalg.norm(xc)


def test_cli_runs_on_the_card_by_default(dev, tmp_path, capsys):
    from acg_tpu_torch.cli import main
    from acg_tpu_torch.io.mtxfile import read_mtx

    out = tmp_path / "x.bin"
    K.reset_launches()
    assert main(["gen:poisson2d:64", "--manufactured-solution", "--warmup",
                 "0", "--max-iterations", "1000", "-o", str(out)]) == 0
    err = capsys.readouterr().err
    assert K.launches["dia_spmv"] > 0
    assert float(err.split("error 2-norm:")[-1]) < 1e-7
    assert np.asarray(read_mtx(out, binary=True).vals).shape == (64 * 64,)
