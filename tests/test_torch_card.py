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


def _band_problem(n=128, nparts=4):
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.io.generators import poisson_mtx
    from acg_tpu_torch.parallel.dist import DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    csr = SymCsrMatrix.from_mtx(poisson_mtx(n, dim=2)).to_csr()
    part = partition_rows(csr, nparts, method="band")
    return csr, DistributedProblem.build(csr, part, nparts)


def test_batched_k1_and_k6_match_plain_on_card(dev):
    """K1 batched over parts and K6, gated and dense, bitwise against
    their plain versions in every dtype they take."""
    _, prob = _band_problem()
    offs = prob.local.offsets
    ot = torch.tensor(offs, device=dev)
    planes = torch.from_numpy(prob.local.arrays[0]).to(dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, prob.nmax_owned), generator=g,
                    dtype=torch.float64).to(dev)
    for pdt, xdt in sorted(K.DIA_SPMV_TYPES, key=str):
        P, xx = planes.to(pdt), x.to(xdt)
        assert torch.equal(K.dia_spmv(P, offs, xx, offsets_t=ot),
                           K.dia_spmv_plain(P, offs, xx))
    scnt_np, _ = prob.neighbor_counts()
    cases = [(torch.from_numpy(scnt_np), prob.halo.maxcnt)]
    dense = torch.full((8, 8), 5, dtype=torch.int32)
    cases.append((dense, 5))
    for scnt, maxcnt in cases:
        nparts = scnt.shape[0]
        scnt = scnt.to(dev)
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            send = torch.randn((nparts, nparts, maxcnt), generator=g,
                               dtype=torch.float64).to(dev, dt)
            for gate in (True, False):
                want = K.halo_put_plain(send, scnt, torch.zeros_like(send),
                                        gate)
                got = K.halo_put(send, scnt, torch.zeros_like(send),
                                 gate_by_counts=gate)
                assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int32"):
        K.halo_put(send, scnt.long(), torch.zeros_like(send))
    with pytest.raises(ValueError, match="stacked planes"):
        K.dia_spmv(planes[:, :2], offs, x, offsets_t=ot)


@pytest.mark.parametrize("pipelined", [False, True])
def test_dma_solve_on_card_goes_through_k6(dev, pipelined):
    """A --comm dma solve on the card launches K6 and batched K1 once per
    SpMV, and takes the CPU solve's iterations to the same x."""
    from acg_tpu_torch.parallel.dist import DistCGSolver

    csr, prob = _band_problem()
    b = csr @ np.random.default_rng(2).standard_normal(csr.shape[0])
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-10)
    out = {}
    for d in ("cpu", dev):
        K.reset_launches()
        s = DistCGSolver(prob, pipelined=pipelined, comm="dma", device=d)
        out[str(d)] = (s.solve(b, criteria=crit), s.stats.niterations,
                       dict(K.launches), s.kernels)
    (xc, kc, _, nc), (xg, kg, lg, ng) = out["cpu"], out[str(dev)]
    assert (nc, ng) == ("xla", "pallas") and kg == kc
    assert np.linalg.norm(xg - xc) <= 1e-10 * np.linalg.norm(xc)
    nspmv = kg + (2 if pipelined else 1)
    for name in ("halo_put", "dia_spmv_batched"):
        assert nspmv <= lg[name] < nspmv + 32
    assert lg["pipelined_update"] >= (kg if pipelined else 0)


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


def test_hub_rows_solve_on_card_is_reproducible(dev):
    """Binned-ELL local blocks with hub rows wider than the widest bin
    (512): two --comm dma solves on the card give the same bits, within
    1e-10 of the CPU solve."""
    import scipy.sparse as sp

    from acg_tpu_torch.io.generators import irregular_spd_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    r, c, v, n = irregular_spd_coo(3000, avg_degree=6.0, seed=0)
    csr = SymCsrMatrix.from_coo(n, r, c, v).to_csr()
    hub = np.repeat([10, 1600], 700)
    nb = np.concatenate([np.arange(11, 711), np.arange(1601, 2301)])
    H = sp.csr_matrix((np.full(2 * hub.size, -0.01),
                       (np.r_[hub, nb], np.r_[nb, hub])), shape=(n, n))
    csr = (csr + H + sp.diags(np.asarray(abs(H).sum(axis=1)).ravel())
           ).tocsr()
    prob = DistributedProblem.build(csr, partition_rows(csr, 4, method="band"),
                                    4)
    assert (prob.local.arrays[3] < prob.nmax_owned).any()   # hub tail
    b = csr @ np.random.default_rng(2).standard_normal(n)
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-10)
    xs = [DistCGSolver(prob, comm="dma", device=d).solve(b, criteria=crit)
          for d in ("cpu", dev, dev)]
    assert np.array_equal(xs[1], xs[2])
    assert np.linalg.norm(xs[1] - xs[0]) <= 1e-10 * np.linalg.norm(xs[0])


def _stencil_band_problem(n, dim, nparts=4):
    """A Poisson band problem on ``nparts`` parts with the stencil armed
    (f64), and the same problem with assembled local planes."""
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.io.generators import poisson_mtx
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.parallel.dist import DistributedProblem, arm_matfree
    from acg_tpu_torch.partition import partition_rows

    csr = SymCsrMatrix.from_mtx(poisson_mtx(n, dim=dim)).to_csr()
    part = partition_rows(csr, nparts, method="band")
    asm = DistributedProblem.build(csr, part, nparts)
    mf = DistributedProblem.build(csr, part, nparts)
    arm_matfree(mf, poisson_stencil(n, dim, dtype=torch.float64,
                                    device="cpu"))
    return csr, asm, mf


def test_stencil_kernel_matches_plain_and_k1_on_card(dev):
    """K7 bitwise against its plain version (the shifted-view apply) and
    against K1 on the same operator's assembled planes, in f32 and f64,
    on 1D, 2D and 3D grids with ragged N; stacked K7 bitwise against the
    generated planes through dia_mv on a 4-part band plan."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil

    g = torch.Generator().manual_seed(3)
    for n, dim in ((1000, 1), (64, 2), (37, 2), (37, 3), (16, 3)):
        for dt in K.STENCIL_TYPES:
            op = poisson_stencil(n, dim, dtype=dt, device=dev)
            x = torch.randn(op.nrows, generator=g,
                            dtype=torch.float64).to(dev, dt)
            y = K.stencil_spmv(op, x)
            assert torch.equal(y, K.stencil_spmv_plain(op, x))
            planes, offs, _ = poisson_dia_device(n, dim, dtype=dt,
                                                 device=dev)
            assert torch.equal(y, K.dia_spmv(planes, offs, x, offsets_t=
                                             torch.tensor(offs, device=dev)))
    for n, dim in ((64, 2), (16, 3)):
        _, _, mf = _stencil_band_problem(n, dim)
        row0, nowned = (torch.from_numpy(a).to(dev)
                        for a in mf.local.arrays[:2])
        for dt in K.STENCIL_TYPES:
            op = poisson_stencil(n, dim, dtype=dt, device=dev)
            x = torch.randn((4, mf.nmax_owned), generator=g,
                            dtype=torch.float64).to(dev, dt)
            got = K.stencil_spmv(op, x, row0=row0, nowned=nowned)
            want = K.stencil_spmv_plain(op, x, row0, nowned)
            assert torch.equal(got, want)


def test_stencil_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from acg_tpu_torch.ops.operator import aniso2d_stencil, poisson_stencil

    op = poisson_stencil(8, 2, dtype=torch.float32, device=dev)
    x = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="one of"):
        K.stencil_spmv(op, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="64-vectors"):
        K.stencil_spmv(op, torch.zeros(65, device=dev))
    with pytest.raises(ValueError, match="for a torch.float32 operator"):
        K.stencil_spmv(op, x.double())
    with pytest.raises(ValueError, match="Poisson"):
        K.stencil_spmv(aniso2d_stencil(8, 0.5, device=dev), x)
    r0 = torch.zeros(2, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="row0"):
        K.stencil_spmv(op, torch.zeros((2, 32), device=dev), row0=r0.int(),
                       nowned=r0)


@pytest.mark.parametrize("pipelined", [False, True])
def test_operator_solve_on_card_equals_assembled_k1_solve(dev, pipelined):
    """An operator solve on the card runs K7 (no K1) and gives the
    iterations and bits of the assembled K1 solve, on one part and on 4
    stacked parts with --comm dma."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil
    from acg_tpu_torch.ops.spmv import DiaMatrix
    from acg_tpu_torch.parallel.dist import DistCGSolver

    n = 96
    b = np.random.default_rng(7).standard_normal(n * n)
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-10)
    planes, offs, N = poisson_dia_device(n, 2, dtype=torch.float64,
                                         device=dev)
    out = []
    for A in (DiaMatrix(planes, offs, N, N),
              poisson_stencil(n, 2, dtype=torch.float64, device=dev)):
        K.reset_launches()
        s = TorchCGSolver(A, pipelined=pipelined, device=dev)
        out.append((s.solve(b, criteria=crit), s.stats.niterations,
                    dict(K.launches)))
    (xa, ka, la), (xm, km, lm) = out
    assert ka == km and np.array_equal(xa, xm)
    assert la["stencil_spmv"] == 0 and lm["dia_spmv"] == 0
    assert lm["stencil_spmv"] == la["dia_spmv"] >= km
    _, asm, mf = _stencil_band_problem(n, 2)
    out = []
    for prob in (asm, mf):
        K.reset_launches()
        s = DistCGSolver(prob, pipelined=pipelined, comm="dma", device=dev)
        out.append((s.solve(b, criteria=crit), s.stats.niterations,
                    dict(K.launches)))
    (xa, ka, la), (xm, km, lm) = out
    assert ka == km and np.array_equal(xa, xm)
    assert lm["dia_spmv_batched"] == 0
    assert lm["stencil_spmv_batched"] == la["dia_spmv_batched"] >= km
    assert lm["halo_put"] == la["halo_put"] > 0


@pytest.mark.parametrize("fmt", ["coo", "bell"])
def test_single_device_gather_formats_are_reproducible_on_card(dev, fmt):
    """COO and binned ELL (with hub rows past the widest bin) on one part:
    two solves on the card give the same bits, within 1e-10 of the CPU
    solve -- no row is summed through float atomics."""
    import scipy.sparse as sp

    from acg_tpu_torch.io.generators import irregular_spd_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr

    r, c, v, n = irregular_spd_coo(3000, avg_degree=6.0, seed=0)
    csr = SymCsrMatrix.from_coo(n, r, c, v).to_csr()
    hub = np.repeat([10, 1600], 700)
    nb = np.concatenate([np.arange(11, 711), np.arange(1601, 2301)])
    H = sp.csr_matrix((np.full(2 * hub.size, -0.01),
                       (np.r_[hub, nb], np.r_[nb, hub])), shape=(n, n))
    csr = (csr + H + sp.diags(np.asarray(abs(H).sum(axis=1)).ravel())
           ).tocsr()
    b = csr @ np.random.default_rng(2).standard_normal(n)
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-10)
    xs = []
    for d in ("cpu", dev, dev):
        A = device_matrix_from_csr(csr, dtype=torch.float64, format=fmt,
                                   device=d)
        if fmt == "bell":
            assert A.tail_rows.numel() > 0   # hub rows in the tail
        xs.append(TorchCGSolver(A, device=d).solve(b, criteria=crit))
    assert np.array_equal(xs[1], xs[2])
    assert np.linalg.norm(xs[1] - xs[0]) <= 1e-10 * np.linalg.norm(xs[0])
