"""The port's multi-process tier (acg_tpu_torch.parallel.multihost/mesh,
restricted builds, the --multihost CLI) against the JAX package.

The reference's own two-process tests need multi-process XLA
collectives, which the CPU backend here lacks; so the port's processes
(gloo over localhost, ``--device cpu``) are held against the
reference's single-controller solve of the same parts on the 8-device
CPU mesh, and bitwise against the port's one-process stacked tier.
Every child runs with ``jax`` and ``acg_tpu`` blocked from import."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu.io.generators import poisson_mtx
from acg_tpu.io.mtxfile import write_mtx
from acg_tpu_torch.io.mtxfile import read_mtx

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the CLI in a child with jax and acg_tpu blocked: a --multihost process
# of the port imports neither
_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["acg_tpu"] = None
from acg_tpu_torch.cli import main
rc = main(sys.argv[1:])
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "acg_tpu")]
assert not loaded, loaded
sys.exit(rc)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(argv, env_extra=None, timeout=120):
    """The port's CLI as 2 gloo processes on the CPU (``--device cpu``);
    both killed on timeout.  Returns [(rc, stdout, stderr), ...]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, *argv, "--device", "cpu",
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


def _value(text, key):
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith(key + ":"))
    return line.split(":", 1)[1].strip()


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("mh") / "poisson2d_n12.mtx"
    write_mtx(path, poisson_mtx(12, dim=2))
    return path


# -- restricted builds ---------------------------------------------------

def _both(side, nparts, method, owned):
    from acg_tpu.io.generators import poisson2d_coo as jcoo
    from acg_tpu.matrix import SymCsrMatrix as JSym
    from acg_tpu.parallel.dist import DistributedProblem as JProb
    from acg_tpu.partition import partition_rows as jpart
    from acg_tpu_torch.io.generators import poisson2d_coo
    from acg_tpu_torch.matrix import SymCsrMatrix
    from acg_tpu_torch.parallel.dist import DistributedProblem
    from acg_tpu_torch.partition import partition_rows

    r, c, v, N = jcoo(side)
    jcsr = JSym.from_coo(N, r, c, v).to_csr()
    jp = JProb.build(jcsr, jpart(jcsr, nparts, seed=0, method=method),
                     nparts, dtype=jnp.float64, owned_parts=owned)
    r, c, v, N = poisson2d_coo(side)
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    part = partition_rows(csr, nparts, seed=0, method=method)
    tp = DistributedProblem.build(csr, part, nparts, owned_parts=owned)
    return jp, tp, csr


def _local_arrays(prob, port: bool):
    a = prob.local.arrays
    if prob.local.format == "dia":
        return [a[0][d] for d in range(a[0].shape[0])] if port else \
            [np.asarray(p) for p in a]
    return [np.asarray(x) for x in a]


@pytest.mark.parametrize("owned", [(0, 1), None])
def test_restricted_band_build_is_the_references(owned):
    """tests/test_multihost.py:52's case: owning parts 0 and 1 of a
    4-part band partition, the stacked host arrays (DIA planes, ghost
    block, halo plan, scattered b) are the reference's, bitwise; the
    other parts stay zero."""
    jp, tp, _ = _both(32, 4, "band", owned)
    assert tp.local.format == jp.local.format == "dia"
    assert tp.local.offsets == jp.local.offsets
    for ta, ja in zip(_local_arrays(tp, True), _local_arrays(jp, False)):
        np.testing.assert_array_equal(ta, ja)
        if owned is not None:
            assert not ta[2:].any()
    for name in ("rows", "data", "cols"):
        np.testing.assert_array_equal(getattr(tp.ghost, name),
                                      np.asarray(getattr(jp.ghost, name)))
    for name in ("send_idx", "ghost_src", "ghost_valid"):
        np.testing.assert_array_equal(getattr(tp.halo, name),
                                      np.asarray(getattr(jp.halo, name)))
    b = np.arange(tp.n, dtype=np.float64)
    np.testing.assert_array_equal(tp.scatter(b), jp.scatter(b))
    for t_cnt, j_cnt in zip(tp.neighbor_counts(), jp.neighbor_counts()):
        np.testing.assert_array_equal(t_cnt, j_cnt)
    assert tp.owned_parts == jp.owned_parts


def test_restricted_graph_build_takes_ell_and_solves():
    """tests/test_multihost.py:87's case: a restricted build of a graph
    partition cannot prove uniform DIA offsets, so it stacks ELL -- as
    the reference -- and the port's solve of it converges."""
    from acg_tpu_torch.parallel.dist import DistCGSolver
    from acg_tpu_torch.solvers import StoppingCriteria

    jp, tp, csr = _both(24, 4, "graph", (0, 1, 2, 3))
    assert tp.local.format == jp.local.format == "ell"
    for ta, ja in zip(_local_arrays(tp, True), _local_arrays(jp, False)):
        np.testing.assert_array_equal(ta, ja)
    b = np.ones(tp.n)
    x = DistCGSolver(tp, device="cpu").solve(
        b, criteria=StoppingCriteria(maxits=2000, residual_rtol=1e-8))
    assert np.linalg.norm(b - csr @ x) <= 1e-6 * np.linalg.norm(b)


def test_part_ranges_are_process_major_and_refuse_too_few_parts():
    from acg_tpu_torch.parallel import mesh

    assert mesh.part_ranges(4, 2) == [(0, 2), (2, 4)]
    assert mesh.part_ranges(5, 2) == [(0, 2), (2, 5)]
    assert mesh.owned_parts(8, 1, 4) == (2, 3)
    with pytest.raises(ValueError, match="1 parts cannot span all 2 "
                                         "controller processes"):
        mesh.part_ranges(1, 2)


def test_single_process_helpers():
    """Outside a multi-process run every helper answers for one rank."""
    from acg_tpu_torch.parallel import erragree, multihost

    assert multihost.process_count() == 1 and multihost.is_primary()
    t = torch.arange(6.0).reshape(3, 2)
    assert multihost.gather_parts(t, [3]) is t
    np.testing.assert_array_equal(multihost.get_global(t, 3), t.numpy())
    np.testing.assert_array_equal(
        multihost.put_global(np.ones((3, 2)), 3, "cpu").numpy(),
        np.ones((3, 2)))
    assert erragree.agree_status(3) == 3
    assert erragree.allgather_blobs("x") == ["x"]
    assert "single process" in multihost.describe()


# -- two-process CLI solves ----------------------------------------------

@pytest.fixture(scope="module")
def reference_x(matrix_file, tmp_path_factory):
    """The reference's single-controller solves of the same parts on the
    8-device CPU mesh: (iterations, x) by (nparts, solver)."""
    from acg_tpu.cli import main as jax_main

    out = {}
    d = tmp_path_factory.mktemp("ref")
    for nparts in (2, 4):
        for solver in ("acg", "acg-pipelined"):
            path = d / f"{nparts}-{solver}.bin"
            import contextlib
            import io
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                assert jax_main([str(matrix_file), "--nparts", str(nparts),
                                 "--solver", solver, "--comm", "xla",
                                 "--manufactured-solution",
                                 "--max-iterations", "300",
                                 "--residual-rtol", "1e-8", "--dtype",
                                 "f64", "--warmup", "0", "-o",
                                 str(path)]) == 0
            out[(nparts, solver)] = (
                int(_value(err.getvalue(), "total iterations")),
                np.asarray(read_mtx(path, binary=True).vals))
    return out


COMMON = ["--manufactured-solution", "--max-iterations", "300",
          "--residual-rtol", "1e-8", "--dtype", "f64", "--warmup", "0"]


@pytest.mark.parametrize("nparts", [2, 4])
@pytest.mark.parametrize("comm", ["xla", "dma"])
@pytest.mark.parametrize("solver", ["acg", "acg-pipelined"])
def test_cli_two_process_solve(matrix_file, reference_x, tmp_path, nparts,
                               comm, solver):
    """test_multihost.py:167's shape on the port: both processes solve,
    only process 0 prints stats and the solution; the iterations are the
    reference's single-controller solve's, x within 1e-10 of it, and x
    the port's one-process stacked solve's bits."""
    from acg_tpu_torch.cli import main as torch_main

    argv = [str(matrix_file), "--nparts", str(nparts), "--comm", comm,
            "--solver", solver] + COMMON
    res = run_pair(argv)
    for rc, _, se in res:
        assert rc == 0, se
    (so0, se0), (so1, se1) = (r[1:] for r in res)
    assert "total solver time" in se0
    assert "%%MatrixMarket matrix array" in so0
    assert "%%MatrixMarket" not in so1 and "total solver time" not in se1
    assert "error 2-norm" not in se1
    assert "multihost: process 1 of 2" in se1 and "backend gloo" in se1
    its = int(_value(se0, "total iterations"))
    jits, jx = reference_x[(nparts, solver)]
    assert its == jits
    x2 = np.asarray([float(v) for v in so0.split("\n")[2:] if v.strip()])
    assert np.linalg.norm(x2 - jx) <= 1e-10 * np.linalg.norm(jx)
    one = tmp_path / "one.txt"
    import contextlib
    with open(one, "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(open(os.devnull, "w")):
        assert torch_main(argv + ["--device", "cpu"]) == 0
    assert so0 == one.read_text()


def test_cli_two_process_default_parts_and_rank_errors(matrix_file):
    """Under --multihost the default part count is the process count;
    a single-part tier still runs on every process, rank 0 printing."""
    res = run_pair([str(matrix_file), "-v", "-q"] + COMMON)
    for rc, _, se in res:
        assert rc == 0, se
        assert "partition rows into 2 parts" in se
    res = run_pair([str(matrix_file), "--comm", "none", "-q"] + COMMON)
    assert [r[0] for r in res] == [0, 0]
    assert "total solver time" in res[0][2]
    assert "total solver time" not in res[1][2]


def test_cli_two_process_refusals_agree(matrix_file):
    """Refusals the multi-process tier makes, on both processes: the
    fused kernels and --nrhs (single-controller tiers)."""
    res = run_pair([str(matrix_file), "--nparts", "2", "--kernels",
                    "fused"] + COMMON)
    for rc, _, se in res:
        assert rc != 0
        assert "full-information build" in se
    res = run_pair([str(matrix_file), "--nrhs", "3"] + COMMON)
    for rc, _, se in res:
        assert rc != 0 and "--multihost/--coordinator" in se


def test_cli_two_process_sharded_gen_direct(tmp_path):
    """ACG_TPU_GEN_DIRECT_MIN=100 gen:poisson3d:12 --multihost --nparts 2:
    each process builds its own rows' planes and runs K1's plain version
    on its halo'd window.  The same iterations as the one-process
    sharded run and x within 1e-12 of it: the dots are the two ranks'
    partials folded in rank order, not one reduction over N, so the bits
    may differ."""
    from acg_tpu_torch.cli import main as torch_main

    env = {"ACG_TPU_GEN_DIRECT_MIN": "100"}
    out = tmp_path / "two.bin"
    argv = ["gen:poisson3d:12", "--nparts", "2", "--warmup", "0",
            "--max-iterations", "500", "--manufactured-solution",
            "--kernels", "pallas"]
    res = run_pair(argv + ["-o", str(out)], env_extra=env)
    for rc, _, se in res:
        assert rc == 0, se
    assert "spot check" in res[0][2] and "total solver time" in res[0][2]
    assert "total solver time" not in res[1][2]
    one = tmp_path / "one.bin"
    os.environ["ACG_TPU_GEN_DIRECT_MIN"] = "100"
    try:
        import contextlib
        import io
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert torch_main(argv + ["--device", "cpu", "-o",
                                      str(one)]) == 0
    finally:
        del os.environ["ACG_TPU_GEN_DIRECT_MIN"]
    assert _value(res[0][2], "total iterations") == \
        _value(err.getvalue(), "total iterations")
    x2 = np.asarray(read_mtx(out, binary=True).vals)
    x1 = np.asarray(read_mtx(one, binary=True).vals)
    assert np.linalg.norm(x2 - x1) <= 1e-12 * np.linalg.norm(x1)
    assert _value(res[0][2], "error 2-norm") is not None


def test_cli_multihost_without_a_card_refuses_before_joining(capsys):
    """Without a card and without --device cpu a process of a
    multi-process run exits with the device error before it contacts the
    coordinator (here nothing listens: joining would wait)."""
    from acg_tpu_torch.cli import main as torch_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert torch_main(["gen:poisson2d:8", "--coordinator",
                       f"127.0.0.1:{_free_port()}", "--num-processes", "2",
                       "--process-id", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
