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
        y, d = K.dia_spmv(P.to(pdt), offsets, x, with_dot=True)
        yr, dr = K.dia_spmv_plain(P.to(pdt), offsets, x, with_dot=True)
        assert torch.equal(y, yr)
        assert float(d) == pytest.approx(float(dr), rel=1e-5)
    # K1's edge shapes: odd n (planes and x off 16-byte boundaries),
    # one-sided offsets, a 64-diagonal band, n below one tile
    for offs, n in (((-33, -1, 0, 1, 33), 20001), ((0, 1, 7, 300), 9999),
                    ((-300, -7, -1, 0), 9999),
                    (tuple(200 * k for k in range(-32, 32)), 30001),
                    ((-3, 0, 3), 100)):
        Pe = torch.randn((len(offs), n), generator=g,
                         dtype=torch.float64).to(dev)
        xe = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
        _k1_matches_plain(Pe, offs, xe)
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


def test_k5_flagged_form_matches_plain(dev):
    """K5 with the breakdown flag of a detecting loop: clear, the plain
    update; set (with a NaN alpha too), x/r/w kept and p/t/z updated,
    bitwise the plain version's in f64, f32 and bf16."""
    g = torch.Generator(device=dev).manual_seed(5)
    n = 100_003
    for vdt in (torch.float64, torch.float32, torch.bfloat16):
        vs = [torch.randn(n, generator=g, dtype=torch.float64,
                          device=dev).to(vdt) for _ in range(7)]
        sdt = K.acc_dtype(vdt)
        be = torch.tensor(0.81, dtype=sdt, device=dev)
        for bad, a in ((False, 0.37), (True, 0.37), (True, float("nan"))):
            al = torch.tensor(a, dtype=sdt, device=dev)
            flag = torch.tensor(bad, device=dev)
            want = K.pipelined_update_plain(*vs, al, be, flag)
            got = K.pipelined_update(*[v.clone() for v in vs[:6]], vs[6],
                                     al, be, bad=flag)
            assert all(torch.equal(x, y) for x, y in zip(got, want))
            if bad:
                assert all(torch.equal(got[i], vs[i]) for i in range(3))


def _k1_matches_plain(P, offsets, x):
    """K1 bitwise against its plain version in every dtype it takes, with
    the dot for a single-part x."""
    for pdt, xdt in sorted(K.DIA_SPMV_TYPES, key=str):
        Pd, xd = P.to(pdt), x.to(xdt)
        yr = K.dia_spmv_plain(Pd, offsets, xd)
        assert torch.equal(K.dia_spmv(Pd, offsets, xd), yr)
        if x.dim() == 1:
            y, d = K.dia_spmv(Pd, offsets, xd, with_dot=True)
            _, dr = K.dia_spmv_plain(Pd, offsets, xd, with_dot=True)
            assert torch.equal(y, yr)
            # random planes: terms of both signs, scaled by their sum
            scale = float((yr.double() * xd.double()).abs().sum())
            assert abs(float(d) - float(dr)) <= 1e-5 * scale


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(64, dtype=torch.float32, device=dev)
    P = torch.zeros((1, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="no kernel"):
        K.dia_spmv(P, (0,), x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        K.dia_spmv(P, (0,), torch.zeros(128, device=dev)[::2])
    with pytest.raises(ValueError, match="1 to 64 diagonals"):
        K.dia_spmv(torch.zeros((65, 64), device=dev), tuple(range(65)), x)
    # K3 reads the offsets from the device tensor: it must be there
    gm = torch.tensor(1.0, device=dev)
    with pytest.raises(ValueError, match="offsets_t"):
        K.cg_phase_a(P, (0,), x, x, gm, gm)


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
    planes = torch.from_numpy(prob.local.arrays[0]).to(dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, prob.nmax_owned), generator=g,
                    dtype=torch.float64).to(dev)
    for pdt, xdt in sorted(K.DIA_SPMV_TYPES, key=str):
        P, xx = planes.to(pdt), x.to(xdt)
        assert torch.equal(K.dia_spmv(P, offs, xx),
                           K.dia_spmv_plain(P, offs, xx))
    # odd n: every part after the first starts off a 16-byte boundary
    for eoffs, n in (((-41, -1, 0, 1, 41), 4001), ((0, 2, 900), 3001),
                     ((-900, -2, 0), 3001)):
        Pe = torch.randn((len(eoffs), 3, n), generator=g,
                         dtype=torch.float64).to(dev)
        xe = torch.randn((3, n), generator=g, dtype=torch.float64).to(dev)
        _k1_matches_plain(Pe, eoffs, xe)
    scnt_np, _ = prob.neighbor_counts()
    cases = [(torch.from_numpy(scnt_np), prob.halo.maxcnt)]
    dense = torch.full((8, 8), 5, dtype=torch.int32)
    cases.append((dense, 5))
    # 16 parts, gated and ungated pairs mixed, 1,001-value windows (not a
    # whole number of 16-byte vectors in bf16 or f32)
    cases.append((torch.randint(-1, 3, (16, 16), generator=g,
                                dtype=torch.int32), 1001))
    for scnt, maxcnt in cases:
        nparts = scnt.shape[0]
        scnt = scnt.to(dev)
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            send = torch.randn((nparts, nparts, maxcnt), generator=g,
                               dtype=torch.float64).to(dev, dt)
            # ungated rows keep what the receive plane held
            recv0 = torch.randn((nparts, nparts, maxcnt), generator=g,
                                dtype=torch.float64).to(dev, dt)
            for gate in (True, False):
                want = K.halo_put_plain(send, scnt, recv0.clone(), gate)
                got = K.halo_put(send, scnt, recv0.clone(),
                                 gate_by_counts=gate)
                assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int32"):
        K.halo_put(send, scnt.long(), torch.zeros_like(send))
    with pytest.raises(ValueError, match="stacked planes"):
        K.dia_spmv(planes[:, :2], offs, x)


def test_part_dot_matches_plain_and_ignores_the_stack_on_card(dev):
    """The per-part dot kernel within summation-order rounding of its
    plain version (1e-13 of sum |a c| in f64, 1e-5 in f32), the same bits
    for a part in a stack of 4, of 2, alone, from a row off a 16-byte
    boundary, and twice; a launch per call."""
    g = torch.Generator().manual_seed(5)
    for vdt, sdt, rel in ((torch.float64, torch.float64, 1e-13),
                          (torch.float32, torch.float32, 1e-5),
                          (torch.bfloat16, torch.float32, 1e-5)):
        for n in (1, 1000, 300007):
            a = torch.randn((4, n), generator=g,
                            dtype=torch.float64).to(dev, vdt)
            c = torch.randn((4, n), generator=g,
                            dtype=torch.float64).to(dev, vdt)
            before = K.launches["part_dot"]
            whole = K.part_dot(a, c, sdt)
            assert K.launches["part_dot"] == before + 1
            want = K.part_dot_plain(a, c, sdt)
            scale = (a.double() * c.double()).abs().sum(-1)
            assert bool(((whole.double() - want.double()).abs()
                         <= rel * scale).all())
            assert torch.equal(K.part_dot(a, c, sdt), whole)
            assert torch.equal(K.part_dot(a[1:3], c[1:3], sdt), whole[1:3])
            assert torch.equal(K.part_dot(a[2:3], c[2:3], sdt), whole[2:3])
            buf = torch.empty(2 * n + 1, dtype=vdt, device=dev)
            off = buf[1:].view(2, n)
            off.copy_(torch.stack([a[3], c[3]]))
            assert torch.equal(K.part_dot(off[:1], off[1:], sdt),
                               whole[3:4])


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
    on 1D, 2D and 3D grids with ragged N, odd n (every +-n vector off
    the 16-byte phase), n = 2 mod 4 (off it in f32) and n below the rows
    a thread (2, 3); stacked K7 bitwise against the generated planes
    through dia_mv on a 4-part band plan and on an 8-part plan of ragged
    owned counts whose parts start off 16-byte boundaries."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.operator import poisson_stencil

    g = torch.Generator().manual_seed(3)
    for n, dim in ((1000, 1), (64, 2), (37, 2), (37, 3), (16, 3),
                   (100003, 1), (511, 2), (510, 2), (2, 2), (3, 2),
                   (3, 3), (2, 3), (67, 3), (66, 3)):
        for dt in K.STENCIL_TYPES:
            op = poisson_stencil(n, dim, dtype=dt, device=dev)
            x = torch.randn(op.nrows, generator=g,
                            dtype=torch.float64).to(dev, dt)
            y = K.stencil_spmv(op, x)
            assert torch.equal(y, K.stencil_spmv_plain(op, x))
            planes, offs, _ = poisson_dia_device(n, dim, dtype=dt,
                                                 device=dev)
            assert torch.equal(y, K.dia_spmv(planes, offs, x))
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
    row0, nowned, nrows = _ragged_plan(511 ** 2, 8)
    for dt in K.STENCIL_TYPES:
        op = poisson_stencil(511, 2, dtype=dt, device=dev)
        x = torch.randn((8, nrows), generator=g,
                        dtype=torch.float64).to(dev, dt)
        r0, no = row0.to(dev), nowned.to(dev)
        assert torch.equal(K.stencil_spmv(op, x, row0=r0, nowned=no),
                           K.stencil_spmv_plain(op, x, r0, no))


def _ragged_plan(N, nparts, seed=11):
    """A band plan of ``nparts`` contiguous parts of uneven sizes over N
    rows: (row0, nowned) int64 tensors and a padded row count that is
    odd, so every part but the first starts off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, N), nparts - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [N]])
    nowned = np.diff(bounds)
    nrows = int(nowned.max()) + 1 + int(nowned.max()) % 2
    return (torch.from_numpy(bounds[:-1].astype(np.int64)),
            torch.from_numpy(nowned.astype(np.int64)), nrows)


def test_cg_phase_a_edge_shapes_match_plain_on_card(dev):
    """K3 on its edge shapes in f32, mixed and bf16: odd n (plane rows
    and the +-1 vectors off the 16-byte phase), offsets all >= 0 or all
    <= 0, the 3D 7-point planes, the first iteration (gamma_prev = inf)
    and a frozen solve (live false): p and t bitwise-equal to the plain
    version, (p, t) within 1e-5 of sum |p_i t_i| (random planes give
    terms of both signs)."""
    from acg_tpu_torch.io.generators import poisson_dia_device

    g = torch.Generator().manual_seed(9)
    cases = []
    for n, dim in ((511, 2), (67, 3)):
        planes, offs, N = poisson_dia_device(n, dim, dtype=torch.float64,
                                             device=dev)
        cases.append((planes, offs, N))
    for offs, N in (((0, 1, 2, 1024, 4096), 50001),
                    ((-4096, -1024, -2, -1, 0), 50001),
                    ((-3, 0, 3), 100)):
        cases.append((torch.randn((len(offs), N), generator=g,
                                  dtype=torch.float64).to(dev), offs, N))
    ot_of = {}
    for P64, offs, N in cases:
        ot = ot_of.setdefault(offs, torch.tensor(offs, device=dev))
        for pdt, vdt in sorted(K.FUSED_TYPES, key=str):
            P = P64.to(pdt)
            r, po = (torch.randn(N, generator=g, dtype=torch.float64)
                     .to(dev, vdt) for _ in range(2))
            gm = torch.tensor(2.0, device=dev)
            for gp, live in ((4.0, None), (float("inf"), None),
                             (4.0, False), (4.0, True)):
                gpt = torch.tensor(gp, device=dev)
                lv = None if live is None else torch.tensor(live, device=dev)
                a = K.cg_phase_a(P, offs, r, po, gm, gpt, offsets_t=ot,
                                 live=lv)
                b = K.cg_phase_a_plain(P, offs, r, po, gm, gpt, lv)
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                scale = float((b[0].double() * b[1].double()).abs().sum())
                assert abs(float(a[2]) - float(b[2])) <= 1e-5 * scale
                if live is False:
                    assert torch.equal(a[0], po)
                if gp == float("inf"):
                    assert torch.equal(a[0], r)


def test_cg_phase_b_edge_shapes_match_plain_on_card(dev):
    """K4 on some of chip_smoke.py's edge shapes in f32 and bf16: odd n
    (a ragged last tile), n below and near the rows a thread, n past a
    whole tile count, every pointer one element off 16 bytes; the live
    flag absent, true and false: x and r bitwise-equal to the plain
    version (untouched when live is false), gamma' within 1e-5 of sum
    r_i^2, the same bits twice."""
    g = torch.Generator().manual_seed(21)
    gm, pd = (torch.tensor(v, device=dev) for v in (2.0, 6.0))
    for n, off in ((511 ** 2, 0), (1, 0), (7, 0), (9, 0), (2 ** 16 + 5, 0),
                   (2 ** 16, 1)):
        for vdt in (torch.float32, torch.bfloat16):
            bufs = [torch.randn(n + off, generator=g, dtype=torch.float64)
                    .to(dev, vdt) for _ in range(4)]
            x0, p, r0, t = (b[off:] for b in bufs)
            for live in (None, True, False):
                lv = None if live is None else torch.tensor(live, device=dev)
                xw, rw, _ = K.cg_phase_b_plain(x0, p, r0, t, gm, pd, lv)
                runs = []
                for _ in range(2):
                    xb, rb = bufs[0].clone(), bufs[2].clone()
                    _, _, gam = K.cg_phase_b(xb[off:], p, rb[off:], t, gm,
                                             pd, live=lv)
                    runs.append((xb[off:], rb[off:], gam))
                x, r, gam = runs[0]
                assert torch.equal(x, xw) and torch.equal(r, rw)
                if live is False:
                    assert torch.equal(x, x0) and torch.equal(r, r0)
                assert all(torch.equal(a, b) for a, b in zip(*runs))
                ref = float((rw.double() ** 2).sum())
                assert abs(float(gam) - ref) <= 1e-5 * ref


def test_cli_default_is_one_part_on_card(dev, capsys):
    """A plain run on the card solves as one part, however many cards
    the host has: the single-device solver (K1, no batched K1)."""
    from acg_tpu_torch.cli import main

    K.reset_launches()
    assert main(["gen:poisson2d:64", "-v", "--warmup", "0",
                 "--max-iterations", "1000"]) == 0
    assert "partition rows into 1 parts" in capsys.readouterr().err
    assert K.launches["dia_spmv"] > 0 and K.launches["dia_spmv_batched"] == 0


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


@pytest.mark.parametrize("kind", ["jacobi", "bjacobi:8", "cheby:3"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_pcg_on_card_matches_cpu(dev, kind, pipelined):
    """Preconditioned CG on the card (K1 for the solve's and the cheby
    apply's SpMVs) takes the CPU's iterations and agrees to 1e-10; the
    cheby interval is carried from the CPU solver, and K1 launches once
    per SpMV: (iterations run + 1) x (1 + degree) + the power iteration's
    25 on the CPU side only."""
    from acg_tpu_torch.io.generators import aniso_poisson2d_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.cg import CHUNK

    r, c, v, N = aniso_poisson2d_coo(96, 0.05)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    b = np.random.default_rng(3).standard_normal(N)
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-10)
    cpu = TorchCGSolver(device_matrix_from_csr(csr, device="cpu"),
                        pipelined=pipelined, precond=kind, device="cpu")
    xc = cpu.solve(b, criteria=crit)
    mstate = (tuple(a.to(dev) for a in cpu._mstate)
              if kind.startswith("cheby") else None)
    K.reset_launches()
    s = TorchCGSolver(device_matrix_from_csr(csr, device=dev),
                      pipelined=pipelined, precond=kind, mstate=mstate,
                      device=dev)
    xg = s.solve(b, criteria=crit)
    assert s.kernels == "pallas"
    its = s.stats.niterations
    assert its == cpu.stats.niterations
    assert np.linalg.norm(xg - xc) <= 1e-10 * np.linalg.norm(xc)
    per = 1 + (int(kind.split(":")[1]) if kind.startswith("cheby") else 0)
    run = -(-its // CHUNK) * CHUNK
    setup = 2 if pipelined else 1   # r0 = b - A x0 (and w = A u0)
    assert K.launches["dia_spmv"] == setup + per * run + (per - 1)


def test_replaced_and_precise_on_card_match_cpu(dev):
    """bf16 with f32 residual replacement (bf16 K1 in the segments, mixed
    K1 for each replacement) and f32 with compensated dots: the CPU's
    iterations, x within the storage precision."""
    planes, offsets, N = poisson_dia(128, 2)
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    b = np.random.default_rng(5).standard_normal(N)
    for dtype, kw, crit, tol in (
            (torch.bfloat16, dict(replace_every=50),
             StoppingCriteria(maxits=1000), 1e-2),
            (torch.float32, dict(precise_dots=True),
             StoppingCriteria(maxits=3000, residual_rtol=1e-6), 1e-4)):
        out = []
        for d in ("cpu", dev):
            K.reset_launches()
            A = device_matrix_from_arrays("dia", planes, meta, dtype=dtype,
                                          device=d)
            s = TorchCGSolver(A, device=d, **kw)
            out.append((s.solve(b, criteria=crit), s.stats.niterations,
                        dict(K.dia_spmv_types)))
        (xc, kc, _), (xg, kg, types) = out
        assert abs(kg - kc) <= (0 if "replace_every" in kw else 2)
        assert np.linalg.norm(xg - xc) <= tol * np.linalg.norm(xc)
        if "replace_every" in kw:
            assert types == {"bf16/bf16": 1000, "bf16/f32": 21}


@pytest.mark.parametrize("fmt", ["dia", "ell", "coo", "bell"])
def test_multi_column_spmv_is_deterministic_on_card(dev, fmt):
    """The multi-column SpMV of the batched tier writes every row once
    (padded rows, no scatter-add): the same bits twice on the card, the
    CPU's values to rounding, no kernel launched."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.io.generators import batched_rhs
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.solvers.batched import spmv_multi

    spec = "gen:poisson2d:128" if fmt == "dia" else "gen:irregular:20000"
    csr = synthesize_host_matrix(spec).to_csr()
    X = batched_rhs(csr.shape[0], 8, seed=1)
    A = device_matrix_from_csr(csr, dtype=torch.float64, format=fmt,
                               device=dev)
    K.reset_launches()
    Xd = torch.from_numpy(X).to(dev)
    y1, y2 = spmv_multi(A, Xd), spmv_multi(A, Xd)
    assert torch.equal(y1, y2)
    assert sum(K.launches.values()) == 0
    np.testing.assert_allclose(y1.cpu().numpy(), csr @ X, rtol=0,
                               atol=1e-12 * np.abs(csr @ X).max())


@pytest.mark.parametrize("mode", ["batched", "pipelined", "block"])
def test_batched_b8_on_card_matches_cpu(dev, mode):
    """B = 8 columns on the card against the same solve on the CPU: the
    per-column iterations within 1 (block CG: the trip count within 2),
    x within 1e-9; the same bits when run twice on the card."""
    from acg_tpu_torch.io.generators import batched_rhs
    from acg_tpu_torch.solvers.batched import BatchedCGSolver

    planes, offsets, N = poisson_dia(96, 2)
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    B = batched_rhs(N, 8, seed=3)
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-9)
    out = []
    for d in ("cpu", dev, dev):
        A = device_matrix_from_arrays("dia", planes, meta,
                                      dtype=torch.float64, device=d)
        s = BatchedCGSolver(A, mode=mode, device=d)
        out.append((s.solve(B, criteria=crit), s.stats.batch))
    (xc, bc), (xg, bg), (xg2, bg2) = out
    assert np.array_equal(xg, xg2) and bg == bg2
    if mode == "block":
        assert abs(bg["block_iterations"] - bc["block_iterations"]) <= 2
    else:
        assert all(abs(a - b) <= 1 for a, b in zip(bg["iterations"],
                                                   bc["iterations"]))
    assert np.linalg.norm(xg - xc) <= 1e-9 * np.linalg.norm(xc)


@pytest.mark.parametrize("algorithm", ["sstep:4", "sstep:8", "pipelined:2"])
def test_ca_recurrence_on_card_matches_cpu(dev, algorithm):
    """The communication-avoiding recurrences on the card (K1 in every
    basis and window SpMV) against the same solve on the CPU: s-step the
    same iterations and x within 1e-10, p(l) converged (its restarts
    depend on rounding) to a true residual below 10 rtol; the same bits
    twice on the card, and TF32 refused for the f32 Gram products."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.recurrence import _check_no_tf32

    planes, offsets, N = poisson_dia(128, 2)
    meta = {"offsets": offsets, "nrows": N, "ncols_padded": N}
    b = np.random.default_rng(5).standard_normal(N)
    crit = StoppingCriteria(maxits=5000, residual_rtol=1e-9)
    out = []
    for d in ("cpu", dev, dev):
        A = device_matrix_from_arrays("dia", planes, meta,
                                      dtype=torch.float64, device=d)
        s = TorchCGSolver(A, device=d, algorithm=algorithm)
        K.reset_launches()
        out.append((s.solve(b, criteria=crit), s.stats.niterations,
                    dict(K.launches)))
    (xc, kc, _), (xg, kg, lg), (xg2, kg2, _) = out
    assert np.array_equal(xg, xg2) and kg == kg2
    assert lg["dia_spmv"] > kg and lg["pipelined_update"] == 0
    if algorithm.startswith("sstep"):
        assert kg == kc
        assert np.linalg.norm(xg - xc) <= 1e-10 * np.linalg.norm(xc)
    else:
        csr = synthesize_host_matrix("gen:poisson2d:128").to_csr()
        assert np.linalg.norm(b - csr @ xg) <= 1e-8 * np.linalg.norm(b)
    v = torch.zeros((3, 4), dtype=torch.float32, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            _check_no_tf32(v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("comm", ["xla", "dma"])
def test_dist_sstep_on_card_matches_cpu(dev, comm):
    """sstep:4 on 3 stacked band parts on the card (batched K1, and K6
    under dma) against the CPU: the same iterations, x within 1e-10, the
    same bits twice."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    csr = synthesize_host_matrix("gen:poisson2d:96").to_csr()
    prob = DistributedProblem.build(csr, partition_rows(
        csr, 3, method="band"), 3)
    b = np.random.default_rng(6).standard_normal(csr.shape[0])
    crit = StoppingCriteria(maxits=5000, residual_rtol=1e-9)
    out = []
    for d in ("cpu", dev, dev):
        s = DistCGSolver(prob, comm=comm, device=d, algorithm="sstep:4")
        K.reset_launches()
        out.append((s.solve(b, criteria=crit), s.stats.niterations,
                    dict(K.launches)))
    (xc, kc, _), (xg, kg, lg), (xg2, kg2, _) = out
    assert np.array_equal(xg, xg2) and kg == kg2 == kc
    assert lg["dia_spmv_batched"] > kg
    assert (lg["halo_put"] == lg["dia_spmv_batched"]) == (comm == "dma")
    assert np.linalg.norm(xg - xc) <= 1e-10 * np.linalg.norm(xc)


@pytest.mark.parametrize("pipelined", [False, True])
def test_dist_batched_on_card_matches_cpu(dev, pipelined):
    """--nrhs 8 on 3 stacked parts on the card against the CPU: the same
    per-column iterations within 1, x within 1e-9, the same bits twice,
    no kernel launched."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.io.generators import batched_rhs
    from acg_tpu_torch.parallel.dist import DistributedProblem
    from acg_tpu_torch.parallel.dist_batched import BatchedDistCGSolver
    from acg_tpu_torch.partition import partition_rows

    csr = synthesize_host_matrix("gen:irregular:20000").to_csr()
    prob = DistributedProblem.build(csr, partition_rows(
        csr, 3, method="graph"), 3)
    B = batched_rhs(csr.shape[0], 8, seed=4)
    crit = StoppingCriteria(maxits=3000, residual_rtol=1e-9)
    out = []
    for d in ("cpu", dev, dev):
        s = BatchedDistCGSolver(prob, pipelined=pipelined, device=d)
        K.reset_launches()
        out.append((s.solve(B, criteria=crit), s.stats.batch,
                    sum(K.launches.values())))
    (xc, bc, _), (xg, bg, lg), (xg2, bg2, _) = out
    assert np.array_equal(xg, xg2) and bg == bg2 and lg == 0
    assert all(abs(a - b) <= 1 for a, b in zip(bg["iterations"],
                                               bc["iterations"]))
    assert np.linalg.norm(xg - xc) <= 1e-9 * np.linalg.norm(xc)


@pytest.mark.parametrize("comm", ["xla", "dma"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_dist_fused_on_card_matches_unsplit(dev, comm, pipelined):
    """--kernels fused on 3 stacked band parts on the card (the halo on
    a side stream under batched K1; K5 for the pipelined update): the
    unsplit card solve's iterations and bits, the same bits twice, x
    within 1e-10 of the CPU's per-row form."""
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    csr = synthesize_host_matrix("gen:poisson2d:96").to_csr()
    prob = DistributedProblem.build(csr, partition_rows(
        csr, 3, method="band"), 3)
    b = np.random.default_rng(8).standard_normal(csr.shape[0])
    crit = StoppingCriteria(maxits=5000, residual_rtol=1e-9)
    out = []
    for d, kern in (("cpu", "fused"), (dev, "auto"), (dev, "fused"),
                    (dev, "fused")):
        s = DistCGSolver(prob, comm=comm, device=d, kernels=kern,
                         pipelined=pipelined)
        K.reset_launches()
        out.append((s.solve(b, criteria=crit), s.stats.niterations,
                    dict(K.launches)))
    (xc, kc, _), (xu, ku, _), (xf, kf, lf), (xf2, kf2, _) = out
    assert kf == kf2 == ku == kc
    assert np.array_equal(xf, xu) and np.array_equal(xf, xf2)
    assert np.linalg.norm(xf - xc) <= 1e-10 * np.linalg.norm(xc)
    assert lf["dia_spmv_batched"] > kf
    assert (lf["halo_put"] == lf["dia_spmv_batched"]) == (comm == "dma")
    assert (lf["pipelined_update"] >= kf) == pipelined


def test_sharded_solve_on_card(dev):
    """The sharded tier on the card: auto takes K1 on the whole planes for
    any part count, those that do not divide N included, bitwise the
    single-device solve and within 1e-10 of the CPU's roll SpMV; the f32
    refine reaches df64-class error."""
    from acg_tpu_torch.io.generators import poisson_dia_device
    from acg_tpu_torch.ops.spmv import DiaMatrix
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver

    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-10)
    planes, offs, N = poisson_dia_device(40, 3, dtype=torch.float64,
                                         device=dev)
    ref = TorchCGSolver(DiaMatrix(planes, offs, N, N), device=dev)
    x1 = ref.solve(torch.ones(N, dtype=torch.float64, device=dev),
                   criteria=crit, host_result=False)
    for nparts in (7, 4):
        assert N % 7 and not N % 4
        s = build_sharded_poisson_solver(40, 3, nparts=nparts,
                                         dtype=torch.float64, device=dev)
        assert s.kernels == "pallas-roll"
        K.reset_launches()
        x = s.solve(s.ones_b(), criteria=crit, host_result=False)
        assert K.launches["dia_spmv"] > s.stats.niterations
        assert K.launches["dia_spmv_batched"] == 0
        assert torch.equal(x, x1)
    c = build_sharded_poisson_solver(40, 3, nparts=4, dtype=torch.float64,
                                     device="cpu")
    xc = c.solve(c.ones_b(), criteria=crit, host_result=False)
    assert c.stats.niterations == s.stats.niterations
    assert float(torch.linalg.norm(x.cpu() - xc)) <= 1e-10 * float(
        torch.linalg.norm(xc))
    f = build_sharded_poisson_solver(24, 3, nparts=4, device=dev)
    xsol, b = f.manufactured_df(seed=0)
    xh, xl = f.solve_refined(b, criteria=StoppingCriteria(
        maxits=20000, residual_rtol=1e-11))
    assert f.error_norms_df(xh, xl, xsol)[1] < 1e-8


_K6_PEER_CHILD = """
import sys
import torch
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel import mesh, multihost
from acg_tpu_torch.parallel.halo_dma import PeerPlanes
port, rank, kind = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda")
dev = multihost.world().device
dt = {"f64": torch.float64, "f32": torch.float32,
      "bf16": torch.bfloat16}[kind]
g = torch.Generator().manual_seed(5)
P, m = 5, 1003
full = torch.randn((P, P, m), generator=g, dtype=torch.float64).to(dt).to(dev)
# zero counts gate some pairs one way only: the acks must still order
# each plane's reuse
cnt = torch.randint(0, 3, (P, P), generator=g, dtype=torch.int32).to(dev)
ranges = mesh.part_ranges(P, 2)
lo, hi = ranges[rank]
send = full[lo:hi].contiguous()
stacked = K.halo_put(full, cnt, torch.zeros_like(full))[lo:hi]
plain = K.halo_put_peer_plain(send.cpu(), cnt.cpu(),
                              torch.zeros((hi - lo, P, m), dtype=dt),
                              ranges, rank)
peer = PeerPlanes(P, ranges, rank, m, dt, cnt.cpu().numpy(), dev)
K.reset_launches()
outs = [K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer).clone()
        for _ in range(4)]
torch.cuda.synchronize()
peer.check()
assert all(torch.equal(o, stacked) for o in outs)
assert torch.equal(outs[0].cpu(), plain)
assert K.launches["halo_put_peer"] == 4
peer.close()
multihost.shutdown()
print("K6-PEER-OK")
"""


def _two_processes(code_or_argv, timeout=120):
    """Two child processes (ranks 0 and 1) on this card, each given a
    fresh port and its rank; both killed on timeout."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable] + code_or_argv(r, port),
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        return [(p, *p.communicate(timeout=timeout)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.mark.parametrize("kind", ["f64", "f32", "bf16"])
def test_k6_peer_two_processes_match_plain_and_stacked(dev, kind):
    """K6's cross-process form on two processes sharing the card: each
    rank's receive plane bitwise the plain version (gloo all_to_all) and
    the stacked halo_put, four exchanges in a row (both planes reused
    under gating that is one-way for some pairs)."""
    outs = _two_processes(lambda r, port: ["-c", _K6_PEER_CHILD, str(port),
                                           str(r), kind])
    for p, out, err in outs:
        assert p.returncode == 0, err
        assert "K6-PEER-OK" in out


_K6_PEER_STOPPED_CHILD = """
import sys
import time
import torch
import torch.distributed as dist
from acg_tpu_torch.ops import kernels as K
from acg_tpu_torch.parallel import mesh, multihost
from acg_tpu_torch.parallel.halo_dma import PeerPlanes
port, rank = int(sys.argv[1]), int(sys.argv[2])
multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda")
dev = multihost.world().device
P, m = 4, 257
cnt = torch.ones((P, P), dtype=torch.int32)
ranges = mesh.part_ranges(P, 2)
lo, hi = ranges[rank]
send = torch.randn((hi - lo, P, m), dtype=torch.float64).to(dev)
peer = PeerPlanes(P, ranges, rank, m, torch.float64, cnt.numpy(), dev,
                  timeout=2.0)
K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer)
torch.cuda.synchronize()
if rank == 0:
    t0 = time.monotonic()
    K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer)
    torch.cuda.synchronize()      # returns once the watchdog releases
    try:
        K.halo_put_peer(send, cnt, None, ranges, rank, peer=peer)
        raise SystemExit("no error after the peer stopped")
    except RuntimeError as e:
        msg = str(e)
    took = time.monotonic() - t0
    assert "a sender's flag" in msg and "within 2 s" in msg, msg
    assert 2.0 <= took < 6.0, took
    print(f"STOPPED-PEER-RAISED {took:.3f} s: {msg}")
# rank 1 stopped after its first exchange: it only meets rank 0 here
dist.barrier()
peer.close()
multihost.shutdown()
print("K6-PEER-STOPPED-OK")
"""


def test_k6_peer_stopped_peer_raises_within_timeout(dev):
    """Two processes on the card; rank 1 stops after its first
    exchange.  Rank 0's second exchange waits for a flag that never
    comes: the watchdog releases the stream wait after the PeerPlanes
    timeout (2 s here), the next exchange raises the flag error, and both
    ranks close and exit -- nothing hangs, nothing falls back."""
    outs = _two_processes(lambda r, port: ["-c", _K6_PEER_STOPPED_CHILD,
                                           str(port), str(r)], timeout=90)
    for p, out, err in outs:
        assert p.returncode == 0, err
        assert "K6-PEER-STOPPED-OK" in out
    assert "STOPPED-PEER-RAISED" in outs[0][1]


def test_ipc_lifecycle_refuses_own_handle(dev):
    """One process: the planes map, the rank refuses to open its own
    IPC handle (CUDA refuses it too), and close frees the memory."""
    import ctypes

    from acg_tpu_torch.ops import _build
    from acg_tpu_torch.parallel.halo_dma import PeerPlanes

    cnt = np.ones((3, 3), dtype=np.int32)
    peer = PeerPlanes(3, [(0, 3)], 0, 17, torch.float64, cnt, dev)
    assert peer.plane(0).shape == (3, 3, 17)
    assert not bool(peer.plane(1).any())
    with pytest.raises(ValueError, match="never opens its own"):
        peer.open(peer._handle)
    ptr = ctypes.c_void_p()
    assert _build.lib().acg_ipc_open(dev.index or 0, peer._handle,
                                     ctypes.byref(ptr)) != 0
    peer.close()
    assert peer._own is None
    # the refused open left no error behind for the next launch's check
    planes, offsets, N = poisson_dia(8, 2)
    P = torch.from_numpy(np.stack(planes)).to(dev)
    x = torch.ones(N, dtype=torch.float64, device=dev)
    assert torch.equal(K.dia_spmv(P, offsets, x),
                       K.dia_spmv_plain(P, offsets, x))


def test_multihost_cli_on_card_matches_stacked(dev, tmp_path):
    """Two processes sharing the card: --nparts 4 --comm dma classic f64
    writes the one-process stacked solve's bytes; rank 1 prints no stats;
    the peer K6 ran on each rank."""
    import subprocess
    import sys

    common = ["-m", "acg_tpu_torch", "gen:poisson2d:64", "--nparts", "4",
              "--comm", "dma", "--manufactured-solution", "--warmup", "0",
              "--max-iterations", "2000", "-q", "-vv"]
    one = tmp_path / "one.bin"
    res = subprocess.run([sys.executable] + common + ["-o", str(one)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    two = tmp_path / "two.bin"
    outs = _two_processes(lambda r, port: common + [
        "-o", str(two), "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(r)])
    for p, _, err in outs:
        assert p.returncode == 0, err
        assert "kernel launches:" in err
        assert '"halo_put_peer": 0' not in err
    assert "total solver time" in outs[0][2]
    assert "total solver time" not in outs[1][2]
    assert two.read_bytes() == one.read_bytes()


# -- the observability tier on the card ------------------------------------

def _poisson_dia_on(dev, n=64, dtype=torch.float64):
    planes, offsets, N = poisson_dia(n, 2)
    return device_matrix_from_arrays(
        "dia", planes, {"offsets": offsets, "nrows": N, "ncols_padded": N},
        dtype=dtype, device=dev)


@pytest.mark.parametrize("pipelined", [False, True])
def test_masked_ring_on_card_matches_cpu(dev, pipelined):
    """A solve converging mid-chunk: the ring on the card (K1, and K5 for
    the pipelined loop) holds the CPU ring's iterations, and the frozen
    steps past convergence left it as it was.  Values: within 1e-10 of
    each column's largest (the dots sum in another order).  The
    pipelined recurrence carries that rounding into its late scalars:
    its first 20 iterations are held pointwise to 1e-10, its residual
    column to 1e-10 of the initial residual, and its alpha, beta and
    denominator to 1e-4 relative (2.2e-6 measured on an H100)."""
    from acg_tpu_torch.solvers.cg import CHUNK

    b = np.ones(64 * 64)
    crit = StoppingCriteria(maxits=2000, residual_rtol=1e-8)
    traces = []
    for d in (dev, torch.device("cpu")):
        s = TorchCGSolver(_poisson_dia_on(d), device=d, kernels="pallas",
                          pipelined=pipelined, trace=512)
        s.solve(b, criteria=crit)
        traces.append(s.last_trace)
    gpu, cpu = traces
    assert gpu.niterations == cpu.niterations
    assert gpu.niterations % CHUNK and not gpu.wrapped
    assert np.array_equal(gpu.iterations, cpu.iterations)
    err = np.abs(gpu.records - cpu.records)
    scale = np.max(np.abs(cpu.records), axis=0)
    if not pipelined:
        assert np.all(err <= 1e-10 * scale)
        return
    early = cpu.iterations < 20
    assert np.all(err[early] <= 1e-10 * np.abs(cpu.records[early]))
    assert np.all(err[:, 0] <= 1e-10 * scale[0])
    assert np.all(err[:, 1:] <= 1e-4 * np.abs(cpu.records[:, 1:]))
    assert K.launches["pipelined_update"] > 0


@pytest.mark.parametrize("tier", ["single", "dist"])
def test_breakdown_on_card_raises_where_the_cpu_falls_back(dev, tier):
    """A fault the restarts do not cure ends a card solve in a
    BreakdownError: the host rung (which the same solve takes on the
    CPU) and the transport rung (not named by the policy) stay off, so
    no answer comes from anything but the card's kernels."""
    from acg_tpu_torch import faults
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.errors import BreakdownError
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
    from acg_tpu_torch.partition import partition_rows
    from acg_tpu_torch.solvers.resilience import RecoveryPolicy

    csr = synthesize_host_matrix("gen:poisson2d:64").to_csr()
    b = np.random.default_rng(5).standard_normal(csr.shape[0])
    pol = RecoveryPolicy(max_restarts=1)
    if tier == "single":
        s = TorchCGSolver(device_matrix_from_csr(
            csr, dtype=torch.float64, device=dev), device=dev,
            recovery=pol, host_matrix=csr)
        spec = "spmv:nan@3"
    else:
        s = DistCGSolver(DistributedProblem.build(csr, partition_rows(
            csr, 4, method="band"), 4), comm="dma", device=dev,
            recovery=pol)
        spec = "halo:nan@3"
    orig = faults.FaultSpec.shift
    faults.FaultSpec.shift = lambda f, k: f     # the fault keeps firing
    try:
        with faults.injected(spec), pytest.raises(BreakdownError):
            s.solve(b, criteria=StoppingCriteria(maxits=2000,
                                                 residual_rtol=1e-8))
    finally:
        faults.FaultSpec.shift = orig
    st = s.stats
    assert (st.nbreakdowns, st.nrestarts, st.nfallbacks) == (2, 1, 0)
    assert getattr(s, "comm", "dma") == "dma"


def test_heartbeat_on_card_prints_once_per_sample(dev, capfd):
    s = TorchCGSolver(_poisson_dia_on(dev), device=dev, progress=50)
    s.solve(np.ones(64 * 64), warmup=1,
            criteria=StoppingCriteria(maxits=2000, residual_rtol=1e-9))
    its = [int(ln.split(": iteration ")[1].split(":")[0])
           for ln in capfd.readouterr().err.splitlines()
           if ": iteration " in ln]
    assert its == list(range(50, 50 * len(its) + 1, 50)) and its


def test_resource_gauges_report_device_memory(dev):
    from acg_tpu_torch import metrics

    x = torch.ones(1 << 20, device=dev)
    metrics.update_resource_gauges()
    text = metrics.expose()
    vals = {ln.split("{")[1].split("}")[0]: float(ln.split()[-1])
            for ln in text.splitlines()
            if ln.startswith("acg_device_memory_bytes{")}
    idx = str(dev.index or 0)
    assert vals[f'device="{idx}",kind="bytes_in_use"'] >= x.numel() * 4
    assert vals[f'device="{idx}",kind="peak_bytes_in_use"'] > 0
    assert vals[f'device="{idx}",kind="bytes_limit"'] > 1e9


def test_capture_classifies_the_ports_kernels(dev, tmp_path):
    """One K1, one part_dot and one K6 launch under a --trace capture:
    the analysis files them as gemv, dot and halo of kind dma."""
    from acg_tpu_torch import telemetry, tracing

    planes, offsets, N = poisson_dia(256, 2)
    P = torch.from_numpy(np.stack(planes)).to(dev)
    x = torch.ones(N, dtype=torch.float64, device=dev)
    a = torch.ones((4, 1024), dtype=torch.float64, device=dev)
    send = torch.ones((4, 4, 64), dtype=torch.float64, device=dev)
    cnt = torch.full((4, 4), 64, dtype=torch.int32, device=dev)
    recv = torch.zeros_like(send)
    K.dia_spmv(P, offsets, x)
    K.part_dot(a, a, torch.float64)
    K.halo_put(send, cnt, recv)
    torch.cuda.synchronize()
    with tracing.profiler_trace(tmp_path / "tr"):
        with telemetry.annotate("solve"):
            K.dia_spmv(P, offsets, x)
            K.part_dot(a, a, torch.float64)
            K.halo_put(send, cnt, recv)
            torch.cuda.synchronize()
    an = tracing.analyze_trace(tmp_path / "tr")
    assert an["available"] and an["solve_windows"] == 1
    ops = an["op_seconds_in_solve"]
    assert ops["gemv"] > 0 and ops["dot"] > 0 and ops["halo"] > 0
    assert an["collective_kind_seconds_in_solve"]["dma"] > 0


def test_serve_daemon_on_card(dev):
    """The solver service on the card: the worker runs on the daemon's
    device, a repeat request hits both caches, the 4-part daemon's
    request launches the hand kernels, and a batch of three coalesced
    requests answers each bitwise its single answer (the single-RHS
    program's dots per column on the card too)."""
    import threading
    import time

    from acg_tpu_torch.ops import kernels as K
    from acg_tpu_torch.serve import ServeConfig, ServeDaemon

    def solve_doc(**kw):
        return dict({"matrix": "gen:poisson2d:64", "rtol": 1e-10,
                     "maxits": 2000}, **kw)

    d = ServeDaemon(ServeConfig(port=0, allow_faults=True, coalesce=4))
    assert d.device.type == "cuda"
    d.start()
    try:
        singles = {s: d.submit(solve_doc(b_seed=s, coalesce=False))[1]
                   for s in (1, 2, 3)}
        assert singles[2]["cache"] == {"operator": "hit", "program": "hit"}
        gate, held = threading.Event(), threading.Event()
        d._serve_fault = lambda req: (held.set(), gate.wait(60.0))
        got = {}
        lead = threading.Thread(target=lambda: d.submit(
            solve_doc(b_seed=9, fault="slow:0")))
        lead.start()
        assert held.wait(60.0)
        members = [threading.Thread(
            target=lambda s=s: got.__setitem__(s, d.submit(
                solve_doc(b_seed=s))[1])) for s in (1, 2, 3)]
        for t in members:
            t.start()
        t0 = time.monotonic()
        while len(d.queue) < 3 and time.monotonic() - t0 < 60.0:
            time.sleep(0.01)
        gate.set()
        for t in [lead] + members:
            t.join(timeout=120.0)
        for s in (1, 2, 3):
            assert got[s]["coalesced"] == 3
            assert got[s]["x"] == singles[s]["x"]
            assert got[s]["iterations"] == singles[s]["iterations"]
    finally:
        d.stop()
    K.reset_launches()
    d4 = ServeDaemon(ServeConfig(port=0, nparts=4, comm="dma"))
    d4.start()
    try:
        s, body = d4.submit(solve_doc(b_seed=5))
        assert s == 200 and body["converged"]
    finally:
        d4.stop()
    for name in ("dia_spmv_batched", "halo_put", "part_dot"):
        assert K.launches[name] > body["iterations"], name
