"""The port's multi-process ingest and output (range reads, local
subdomains, --distributed-read, the rootless --output) against the JAX
package's functions on the same files, and as 2 gloo processes on the
CPU against the port's one-process run and the reference's
single-controller run."""

import contextlib
import io
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.graph import subdomain_from_row_slice as j_slice
from acg_tpu.io import mtxfile as jmtx
from acg_tpu.io.generators import poisson2d_coo, poisson_mtx
from acg_tpu.matrix import SymCsrMatrix
from acg_tpu_torch.errors import AcgError
from acg_tpu_torch.graph import (partition_matrix, reorder_owned_natural,
                                 subdomain_from_row_slice)
from acg_tpu_torch.io import mtxfile as tmtx
from acg_tpu_torch.parallel.dist import DistCGSolver, DistributedProblem
from acg_tpu_torch.solvers import StoppingCriteria

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["acg_tpu"] = None
from acg_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


@pytest.fixture(scope="module")
def binfile(tmp_path_factory):
    """24x24 2D Poisson as an expanded row-sorted binary file (written
    by the reference's writer)."""
    path = tmp_path_factory.mktemp("lr") / "p24.bin.mtx"
    jmtx.write_mtx(path, jmtx.expand_to_rowsorted_full(poisson_mtx(24, 2)),
                   binary=True)
    return path


@pytest.fixture(scope="module")
def csr():
    r, c, v, N = poisson2d_coo(24)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def _same_subdomain(s, ref):
    assert (s.nowned, s.nghost, s.nborder) == (ref.nowned, ref.nghost,
                                               ref.nborder)
    np.testing.assert_array_equal(s.global_ids, ref.global_ids)
    np.testing.assert_array_equal(s.ghost_owner, ref.ghost_owner)
    for name in ("send_parts", "send_counts", "send_ptr", "send_idx",
                 "recv_parts", "recv_counts", "recv_ptr", "recv_idx"):
        np.testing.assert_array_equal(getattr(s.halo, name),
                                      getattr(ref.halo, name))
    assert (s.A_local != ref.A_local).nnz == 0
    assert (s.A_ghost != ref.A_ghost).nnz == 0


def test_read_sizes_and_row_ranges_match_jax(binfile):
    assert tmtx.read_mtx_sizes(binfile) == jmtx.read_mtx_sizes(binfile) \
        == (576, 576, 5 * 576 - 4 * 24)
    full = tmtx.read_mtx(binfile, binary=True)
    for lo, hi in ((0, 100), (100, 400), (400, 576), (0, 576), (50, 50)):
        t, j = (m.read_mtx_row_range(binfile, lo, hi) for m in (tmtx, jmtx))
        keep = (full.rowidx >= lo) & (full.rowidx < hi)
        for a in ("rowidx", "colidx", "vals"):
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
            np.testing.assert_array_equal(getattr(t, a),
                                          getattr(full, a)[keep])
        assert (t.nrows, t.nnz) == (j.nrows, j.nnz)


def test_row_range_refusals(tmp_path):
    """Unsorted rows, a text file and a one-triangle file are refused,
    as by the reference."""
    mtx = poisson_mtx(8, dim=2)
    perm = np.random.default_rng(0).permutation(mtx.nnz)
    mtx.rowidx, mtx.colidx, mtx.vals = (np.asarray(a)[perm] for a in (
        mtx.rowidx, mtx.colidx, mtx.vals))
    p = tmp_path / "scrambled.bin.mtx"
    jmtx.write_mtx(p, mtx, binary=True)
    with pytest.raises(AcgError, match="row-sorted|bisection"):
        tmtx.read_mtx_row_range(p, 10, 40)
    txt = tmp_path / "text.mtx"
    jmtx.write_mtx(txt, jmtx.expand_to_rowsorted_full(poisson_mtx(8, 2)))
    with pytest.raises(AcgError, match="binary"):
        tmtx.read_mtx_row_range(txt, 0, 10)
    tri = tmp_path / "tri.bin.mtx"
    jmtx.write_mtx(tri, poisson_mtx(8, dim=2), binary=True)
    with pytest.raises(AcgError, match="expand"):
        DistributedProblem.build_local_read(tri, 2)


def test_subdomain_from_row_slice_matches_jax_and_partitioner(binfile,
                                                              csr):
    N = csr.shape[0]
    bounds = np.array([0, 200, 390, N])
    part = np.repeat(np.arange(3, dtype=np.int32), np.diff(bounds))
    full = reorder_owned_natural(partition_matrix(csr, part, 3))
    for p in range(3):
        r, c, v = tmtx.read_mtx_row_range(binfile, int(bounds[p]),
                                          int(bounds[p + 1])).to_coo()
        s = subdomain_from_row_slice(r, c, v, bounds, p)
        _same_subdomain(s, j_slice(r, c, v, bounds, p))
        _same_subdomain(s, full[p])


def test_read_local_subdomains_with_owned_parts(binfile):
    """Explicit owned parts: their subdomains are the reference's, the
    other parts stubs of the right size, and no read of their rows."""
    from acg_tpu.parallel.dist import DistributedProblem as JProb

    subs, bounds, n, owned = DistributedProblem.read_local_subdomains(
        binfile, 4, owned=(1, 3))
    jsubs, jb, jn, _ = JProb.read_local_subdomains(binfile, 4)
    np.testing.assert_array_equal(bounds, jb)
    assert n == jn == 576 and owned == (1, 3)
    for p in range(4):
        if p in owned:
            _same_subdomain(subs[p], jsubs[p])
        else:
            assert subs[p].A_local is None and subs[p].halo is None
            assert subs[p].nowned == bounds[p + 1] - bounds[p]


def test_assemble_local_matches_jax(binfile):
    """One process owning every part: the agreed shapes and the stacked
    host arrays of the local-read flow are the reference's."""
    from acg_tpu.parallel.dist import DistributedProblem as JProb

    tp = DistributedProblem.build_local_read(binfile, 4)
    jp = JProb.build_local_read(binfile, 4, dtype=jnp.float64)
    assert tp.local.format == jp.local.format == "dia"
    assert tp.local.offsets == jp.local.offsets
    for d in range(len(tp.local.offsets)):
        np.testing.assert_array_equal(tp.local.arrays[0][d],
                                      np.asarray(jp.local.arrays[d]))
    for name in ("rows", "data", "cols"):
        np.testing.assert_array_equal(getattr(tp.ghost, name),
                                      np.asarray(getattr(jp.ghost, name)))
    for name in ("send_idx", "ghost_src", "ghost_valid"):
        np.testing.assert_array_equal(getattr(tp.halo, name),
                                      np.asarray(getattr(jp.halo, name)))
    assert tp.band_bounds == jp.band_bounds and tp.n == jp.n
    assert tp.nnz_total == jp.nnz_total
    assert tp.halo_send_total == jp.halo_send_total
    np.testing.assert_array_equal(tp.row_permutation(),
                                  jp.row_permutation())
    assert tp.part_rows() == jp.part_rows()
    x = np.arange(576.0)
    np.testing.assert_array_equal(tp.gather(tp.scatter(x)), x)


def test_build_local_read_solves(binfile, csr):
    prob = DistributedProblem.build_local_read(binfile, 4)
    b = np.ones(csr.shape[0])
    x = DistCGSolver(prob, device="cpu").solve(
        b, criteria=StoppingCriteria(maxits=2000, residual_rtol=1e-10))
    assert np.linalg.norm(b - csr @ x) <= 1e-8 * np.linalg.norm(b)


def test_vector_windows_and_rows_match_jax(tmp_path):
    n = 500
    x = np.linspace(0, 1, n)
    p = tmp_path / "v.bin.mtx"
    jmtx.write_mtx(p, jmtx.vector_mtx(x), binary=True)
    rows = np.random.default_rng(0).integers(0, n, size=137)
    rows[10] = rows[20]
    np.testing.assert_array_equal(
        tmtx.read_vector_rows(p, rows, expect_nrows=n),
        jmtx.read_vector_rows(p, rows, expect_nrows=n))
    assert tmtx.read_vector_rows(p, np.zeros(0, np.int64)).size == 0
    with pytest.raises(AcgError):
        tmtx.read_vector_rows(p, np.asarray([n]), expect_nrows=n)
    np.testing.assert_array_equal(tmtx.read_vector_window(p, 7, 93),
                                  jmtx.read_vector_window(p, 7, 93))
    with pytest.raises(AcgError, match="outside"):
        tmtx.read_vector_window(p, 2, n + 9)
    with pytest.raises(AcgError, match="need"):
        tmtx.read_vector_window(p, 0, 3, expect_nrows=n + 1)
    txt = tmp_path / "v.mtx"
    jmtx.write_mtx(txt, jmtx.vector_mtx(np.arange(5.0)))
    with pytest.raises(AcgError, match="binary"):
        tmtx.read_vector_window(txt, 0, 3)


def test_write_vector_window_is_byte_identical(tmp_path):
    n = 37
    x = np.linspace(-1, 1, n)
    p = tmp_path / "x.bin.mtx"
    for lo, hi in ((20, n), (0, 9), (9, 20)):
        tmtx.write_vector_window(p, n, lo, x[lo:hi])
    tmtx.finalize_vector_file(p, n)
    ref = tmp_path / "ref.bin.mtx"
    jmtx.write_mtx(ref, jmtx.vector_mtx(x), binary=True)
    assert p.read_bytes() == ref.read_bytes()
    assert tmtx.vector_binary_header(n) == jmtx.vector_binary_header(n)
    with pytest.raises(AcgError, match="outside"):
        tmtx.write_vector_window(p, n, 30, x[:9])


# -- partition-permuted inputs --------------------------------------------

@pytest.fixture(scope="module")
def irregular():
    from acg_tpu.io.generators import irregular_spd_coo
    r, c, v, N = irregular_spd_coo(400, avg_degree=6.0, seed=3)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


@pytest.fixture(scope="module")
def part_binfile(tmp_path_factory, irregular):
    """graph partition -> mtx2bin --expand --partition (the port's tool)
    -> the permuted binary with its .perm.mtx and .bounds.mtx."""
    from acg_tpu_torch.partition import partition_rows
    from acg_tpu_torch.tools.mtx2bin import main as mtx2bin_main

    d = tmp_path_factory.mktemp("mp")
    src = d / "irr.mtx"
    coo = irregular.tocoo()
    up = coo.row <= coo.col
    jmtx.write_mtx(src, jmtx.MtxFile(
        object="matrix", format="coordinate", field="real",
        symmetry="symmetric", nrows=irregular.shape[0],
        ncols=irregular.shape[0], nnz=int(up.sum()), rowidx=coo.row[up],
        colidx=coo.col[up], vals=coo.data[up]))
    part = partition_rows(irregular, 3, seed=0, method="graph")
    pf = d / "part.mtx"
    jmtx.write_mtx(pf, jmtx.vector_mtx(part.astype(np.int64),
                                       field="integer"), numfmt="%d")
    out = d / "irr.bin.mtx"
    assert mtx2bin_main([str(src), str(out), "--expand", "--partition",
                         str(pf)]) == 0
    return out, part


def test_partitioned_subdomains_match_full_partitioner(part_binfile,
                                                       irregular):
    out, part = part_binfile
    bounds = np.asarray(tmtx.read_mtx(str(out) + ".bounds.mtx").vals
                        ).reshape(-1).astype(np.int64)
    perm = np.asarray(tmtx.read_mtx(str(out) + ".perm.mtx",
                                    binary=True).vals
                      ).reshape(-1).astype(np.int64) - 1
    np.testing.assert_array_equal(part[perm], np.sort(part, kind="stable"))
    pcsr = irregular[perm][:, perm].tocsr()
    gpart = (np.searchsorted(bounds, np.arange(irregular.shape[0]),
                             side="right") - 1).astype(np.int32)
    full = reorder_owned_natural(partition_matrix(pcsr, gpart, 3))
    subs, _, _, _ = DistributedProblem.read_local_subdomains(out, 3,
                                                             bounds=bounds)
    for p in range(3):
        _same_subdomain(subs[p], full[p])


# -- the CLI: one process and two ------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(argv_of, timeout=120):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, *argv_of(r), "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(r)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _one(argv):
    """The port's CLI in this process: (rc, stdout, stderr); stdout goes
    through a real file (the solution is written to its buffer)."""
    import tempfile

    from acg_tpu_torch.cli import main
    err = io.StringIO()
    with tempfile.TemporaryFile("w+") as out:
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(out):
            rc = main(argv + ["--device", "cpu"])
        out.seek(0)
        return rc, out.read(), err.getvalue()


def _value(text, key):
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith(key + ":"))
    return line.split(":", 1)[1].strip()


def _ok(res):
    for rc, _, se in res:
        assert rc == 0, se
    assert "total solver time" in res[0][2]
    assert "total solver time" not in res[1][2]


def test_cli_two_process_distributed_read(binfile, tmp_path):
    """Both processes range-read their rows and solve; rank 0 alone
    reports.  The x is the port's one-process distributed-read solve's
    bits; the iterations are the reference's single-controller run's and
    x within 1e-10 of it."""
    from acg_tpu.cli import main as jax_main

    base = [str(binfile), "--binary", "--distributed-read", "--nparts",
            "4", "--manufactured-solution", "--max-iterations", "2000",
            "--residual-rtol", "1e-8", "--warmup", "0"]
    two = tmp_path / "two.bin"
    res = _pair(lambda r: base + ["-o", str(two)])
    _ok(res)
    one = tmp_path / "one.bin"
    rc, _, err1 = _one(base + ["-o", str(one)])
    assert rc == 0, err1
    assert two.read_bytes() == one.read_bytes()
    assert _value(res[0][2], "error 2-norm") == _value(err1, "error 2-norm")
    ref = tmp_path / "ref.bin"
    jerr = io.StringIO()
    with contextlib.redirect_stderr(jerr):
        assert jax_main(base + ["-o", str(ref)]) == 0
    assert _value(res[0][2], "total iterations") == \
        _value(jerr.getvalue(), "total iterations")
    x, xr = (np.asarray(tmtx.read_mtx(f, binary=True).vals)
             for f in (two, ref))
    assert np.linalg.norm(x - xr) <= 1e-10 * np.linalg.norm(xr)


def test_cli_two_process_partitioned_and_permuted_files(part_binfile,
                                                        irregular,
                                                        tmp_path):
    """A METIS-style permuted file (3 parts from its .bounds.mtx on 2
    processes) with b and x0 FILES in the original order: the printed
    solution, in the original order, solves the original system and is
    the one-process run's bits; the rootless --output keeps the
    permuted order and ships the .perm.mtx beside it."""
    out, _ = part_binfile
    n = irregular.shape[0]
    rng = np.random.default_rng(5)
    b, x0 = rng.standard_normal(n), 0.1 * rng.standard_normal(n)
    bf, xf = tmp_path / "b.bin.mtx", tmp_path / "x0.bin.mtx"
    jmtx.write_mtx(bf, jmtx.vector_mtx(b), binary=True)
    jmtx.write_mtx(xf, jmtx.vector_mtx(x0), binary=True)
    base = [str(out), str(bf), str(xf), "--binary", "--distributed-read",
            "--max-iterations", "3000", "--residual-rtol", "1e-10",
            "--warmup", "0"]
    res = _pair(lambda r: base)
    _ok(res)
    x = np.asarray(tmtx.read_mtx(io.BytesIO(res[0][1].encode())).vals
                   ).reshape(-1)
    assert np.linalg.norm(b - irregular @ x) <= 1e-8 * np.linalg.norm(b)
    rc, so1, err1 = _one(base)
    assert rc == 0, err1
    assert so1 == res[0][1]
    w = tmp_path / "w.bin"
    res = _pair(lambda r: base + ["-o", str(w)])
    _ok(res)
    assert "permuted row ordering" in res[0][2]
    perm = np.asarray(tmtx.read_mtx(str(w) + ".perm.mtx", binary=True).vals
                      ).reshape(-1).astype(np.int64) - 1
    xw = np.asarray(tmtx.read_mtx(w, binary=True).vals)
    xo = np.empty_like(xw)
    xo[perm] = xw
    np.testing.assert_array_equal(xo, x)


def test_cli_two_process_refine(binfile, csr, tmp_path):
    """--refine under --distributed-read: f64 outer residuals from each
    process's host blocks, the same b on every process; the refined x
    written rootless carries f64-class accuracy."""
    out = tmp_path / "x.bin"
    res = _pair(lambda r: [str(binfile), "--binary", "--distributed-read",
                           "--nparts", "4", "--dtype", "f32", "--refine",
                           "--manufactured-solution", "--max-iterations",
                           "20000", "--residual-rtol", "1e-11", "--warmup",
                           "0", "-o", str(out)])
    _ok(res)
    assert float(_value(res[0][2], "error 2-norm")) < 1e-9
    x = np.asarray(tmtx.read_mtx(out, binary=True).vals).reshape(-1)
    xsol = np.random.default_rng(42).standard_normal(csr.shape[0])
    xsol /= np.linalg.norm(xsol)
    b = csr @ xsol
    assert np.linalg.norm(b - csr @ x) <= 1e-9 * np.linalg.norm(b)


def test_cli_two_process_one_sided_read_failure(binfile, tmp_path):
    """One process's matrix is missing: the ingest agreement (before the
    shape agreement) brings both down with exit 1 -- the reference test's
    agreed nonzero codes -- and rank 0 names the peer's failure."""
    import time
    t0 = time.monotonic()
    res = _pair(lambda r: [str(binfile if r == 0 else
                               tmp_path / "nope.bin.mtx"), "--binary",
                           "--distributed-read", "--nparts", "4",
                           "--max-iterations", "100", "--warmup", "0",
                           "-q", "--err-timeout", "20"])
    assert time.monotonic() - t0 < 60
    assert [r[0] for r in res] == [1, 1]
    assert "peer controller failed during ingest" in res[0][2]
    assert "nope.bin.mtx" in res[1][2]


def test_cli_distributed_read_refusals(binfile):
    for extra, what in ((["--comm", "dma"], "--comm dma"),
                        (["--kernels", "fused"], "--kernels fused")):
        with pytest.raises(SystemExit, match=what):
            _one([str(binfile), "--binary", "--distributed-read"] + extra)
    with pytest.raises(SystemExit, match="text input"):
        _one([str(binfile), "--distributed-read"])
