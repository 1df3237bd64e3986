"""The port's CLI (python -m acg_tpu_torch) against the JAX package's
(acg_tpu.cli) on the same generated problem, plus the port's isolation
rules: no JAX and no acg_tpu import, and no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_tpu.cli import main as jax_main
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.io.mtxfile import read_mtx

# the suite runs several test processes side by side: keep PyTorch's
# small CPU ops from claiming every core in each of them
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["gen:poisson2d:16", "--manufactured-solution",
          "--max-iterations", "500", "--residual-rtol", "1e-10",
          "--warmup", "1"]


def _stats_keys(text):
    """The key of every line of a stats block (the text before ':')."""
    return {line.split(":")[0].strip() for line in text.splitlines()
            if ":" in line}


def _line(text, key):
    return next(line for line in text.splitlines()
                if line.strip().startswith(key + ":"))


def test_cli_matches_jax_cli(tmp_path, capsys):
    jx, tx = tmp_path / "jax.bin", tmp_path / "torch.bin"
    assert jax_main(COMMON + ["--comm", "none", "-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(COMMON + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    assert _line(terr, "iterations") == _line(jerr, "iterations")
    assert _line(terr, "total iterations") == _line(jerr, "total iterations")
    assert _stats_keys(terr) == _stats_keys(jerr)
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert xt.shape == xj.shape == (256,)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    err = float(_line(terr, "error 2-norm").split(":")[1])
    assert err < 1e-8


@pytest.mark.parametrize("form", ["text", "gzip", "binary"])
def test_cli_reads_matrix_and_vector_files(tmp_path, capsys, form):
    """A Matrix Market matrix (text, gzipped text, binary) with b and x0
    files, written by the JAX package's writer: the port's reader takes
    all three and its solve matches acg_tpu.cli on the same files."""
    import gzip

    from acg_tpu.io.generators import poisson_mtx
    from acg_tpu.io.mtxfile import vector_mtx, write_mtx

    binary = form == "binary"
    A = tmp_path / "A.mtx"
    write_mtx(A, poisson_mtx(12), binary=binary)
    if form == "gzip":
        A = tmp_path / "A.mtx.gz"
        with gzip.open(A, "wb") as f:
            write_mtx(f, poisson_mtx(12))
    rng = np.random.default_rng(4)
    b, x0 = tmp_path / "b.mtx", tmp_path / "x0.mtx"
    write_mtx(b, vector_mtx(rng.standard_normal(144)), binary=binary)
    write_mtx(x0, vector_mtx(rng.standard_normal(144)), binary=binary)
    files = [str(A), str(b), str(x0)] + (["--binary"] if binary else [])
    flags = ["--warmup", "0", "--max-iterations", "300"]
    jx, tx = tmp_path / "jx.bin", tmp_path / "tx.bin"
    assert jax_main(files + flags + ["--comm", "none", "-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(files + flags + ["--device", "cpu", "-o",
                                       str(tx)]) == 0
    terr = capsys.readouterr().err
    for key in ("iterations", "initial guess 2-norm",
                "right-hand side 2-norm"):
        assert _line(terr, key) == _line(jerr, key)
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


def test_cli_refuses_partition_permuted_inputs(tmp_path):
    """A partition-permuted input is solved through its ``.perm.mtx``
    sidecar (tests/test_torch_tools.py); one whose sidecar is not a
    permutation of the matrix's rows (stale, from an earlier mtx2bin
    run) is refused with the JAX CLI's message."""
    from acg_tpu_torch.io.generators import poisson_mtx
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx

    A = tmp_path / "A.mtx"
    write_mtx(A, poisson_mtx(4))
    write_mtx(str(A) + ".perm.mtx", vector_mtx(np.arange(1.0, 10.0)),
              binary=True)
    with pytest.raises(SystemExit, match="is not a permutation of 16 rows "
                                         "-- stale sidecar"):
        torch_main([str(A), "--device", "cpu"])


@pytest.mark.parametrize("extra", [["--solver", "acg-pipelined"],
                                   ["--dtype", "f32", "--kernels", "fused",
                                    "--epsilon", "2", "--residual-rtol",
                                    "1e-6"]])
def test_cli_tiers_write_readable_solutions(tmp_path, capsys, extra):
    """-o writes a binary vector that read_mtx(binary=True) reads back;
    the pipelined and fused tiers run through the CLI."""
    out = tmp_path / "x.bin"
    argv = ["gen:poisson2d:128", "--manufactured-solution", "--device",
            "cpu", "--warmup", "0", "--max-iterations", "2000",
            "--residual-rtol", "1e-8", "-o", str(out)] + extra
    assert torch_main(argv) == 0
    err = capsys.readouterr().err
    x = np.asarray(read_mtx(out, binary=True).vals)
    assert x.shape == (128 * 128,) and np.all(np.isfinite(x))
    assert float(_line(err, "error 2-norm").split(":")[1]) < 1e-4


DIST = ["gen:poisson2d:20", "--nparts", "4", "--comm", "dma",
        "--manufactured-solution", "--max-iterations", "500",
        "--residual-rtol", "1e-10", "--warmup", "0"]


def test_cli_multipart_matches_jax_cli(tmp_path, capsys):
    """--nparts 4 --comm dma through both CLIs: the same iteration count,
    the same MPI_HaloExchange/MPI_Allreduce rows, solutions within
    1e-10."""
    jx, tx = tmp_path / "jax.bin", tmp_path / "torch.bin"
    assert jax_main(DIST + ["-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(DIST + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    assert _line(terr, "iterations") == _line(jerr, "iterations")
    for key in ("MPI_HaloExchange", "MPI_Allreduce", "gemv", "dot"):
        # "<seconds> seconds <n> times <bytes> B ...": the counts and bytes
        assert (_line(terr, key).split(" seconds ")[1].split(" B ")[0]
                == _line(jerr, key).split(" seconds ")[1].split(" B ")[0])
    assert "71 times" in _line(terr, "MPI_HaloExchange")
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)


@pytest.mark.parametrize("source", ["graph", "file"])
def test_cli_output_comm_matrix_matches_jax(tmp_path, capsys, source):
    """--output-comm-matrix writes the JAX CLI's matrix, for a built-in
    graph partition and for a 1-based --partition file."""
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx

    argv = ["gen:irregular:600", "--nparts", "4", "--output-comm-matrix",
            "-q", "--warmup", "0", "--max-iterations", "20",
            "--residual-rtol", "0"]
    if source == "graph":
        argv += ["--partition-method", "graph"]
    else:
        part = tmp_path / "part.mtx"
        rng = np.random.default_rng(0)
        write_mtx(part, vector_mtx(rng.integers(1, 5, 600), field="integer"),
                  numfmt="%d")
        argv += ["--partition", str(part)]
    assert jax_main(argv) == 0
    jout = capsys.readouterr().out
    assert torch_main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert tout.startswith("%%MatrixMarket matrix coordinate integer")
    assert tout == jout


def test_cli_text_output_uses_numfmt(capsys):
    assert torch_main(["gen:poisson2d:4", "--device", "cpu", "--warmup",
                       "0", "--numfmt", "%.3e"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("%%MatrixMarket matrix array real general")
    assert out[1] == "16 1" and len(out) == 18
    assert all("e" in v and len(v.split("e")[0].split(".")[1]) == 3
               for v in out[2:])


ALGO = ["gen:poisson2d:32", "--aniso", "0.1", "--max-iterations", "2000",
        "--residual-rtol", "1e-8", "--warmup", "1", "--comm", "none",
        "--manufactured-solution"]


def _counts(text, key):
    """The '<n> times <bytes> B' part of an op row."""
    return _line(text, key).split(" seconds ")[1].split(" GB/s")[0] \
        .rsplit(" ", 1)[0]


@pytest.mark.parametrize("algorithm", ["sstep:4", "pipelined:2"])
def test_cli_algorithm_matches_jax_cli(tmp_path, capsys, algorithm):
    """--algorithm through both CLIs on the aniso family.  s-step: the
    same iterations and op rows, x within 1e-10.  p(l): its restart
    points depend on rounding, so both blocks carry a resilience: line
    with its event lines (restarts, not raises), the same stats keys,
    and the iterations stay within 3x classic CG's."""
    jx, tx = tmp_path / "jax.bin", tmp_path / "torch.bin"
    argv = ALGO + ["--algorithm", algorithm]
    assert jax_main(argv + ["-o", str(jx)]) == 0
    jerr = capsys.readouterr().err
    assert torch_main(argv + ["--device", "cpu", "-o", str(tx)]) == 0
    terr = capsys.readouterr().err
    # the restart events also go to stderr, each under its program name
    assert _stats_keys(terr) - {"acg-tpu-torch"} \
        == _stats_keys(jerr) - {"acg-tpu"}
    xj = np.asarray(read_mtx(jx, binary=True).vals)
    xt = np.asarray(read_mtx(tx, binary=True).vals)
    assert float(_line(terr, "error 2-norm").split(":")[1]) < 1e-5
    if algorithm.startswith("sstep"):
        assert _line(terr, "iterations") == _line(jerr, "iterations")
        for key in ("gemv", "dot", "nrm2", "axpy", "copy", "total flops"):
            assert _line(terr, key).split(" seconds")[-1] == \
                _line(jerr, key).split(" seconds")[-1]
        assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
        assert "resilience:" not in terr
        return
    assert torch_main(ALGO + ["--device", "cpu", "-q"]) == 0
    classic = int(_line(capsys.readouterr().err, "iterations").split(":")[1]
                  .replace(",", ""))
    its = int(_line(terr, "iterations").split(":")[1].replace(",", ""))
    assert its <= 3 * classic
    for err in (jerr, terr):
        res = _line(err, "resilience")
        n = int(res.split(":")[1].split()[0])
        assert n >= 1 and res.strip().endswith(
            f"{n} restarts, 0 fallbacks")
        assert err.count("from the recomputed true residual\n") == 2 * n


@pytest.mark.parametrize("flag", [["--supervise"], ["--explain"],
                                  ["--serve"], ["--shrink"]])
def test_cli_refuses_flags_of_other_tiers(flag, capsys):
    """The flags of tiers not ported yet (the supervisor, the decision
    layer, the service) stay unregistered; --max-restarts, --soak and
    --ckpt, which this test named before the robustness tier was
    ported, are held against the reference in test_torch_faults.py,
    test_torch_soak.py and test_torch_checkpoint.py."""
    with pytest.raises(SystemExit) as e:
        torch_main(["gen:poisson2d:8", "--device", "cpu"] + flag)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--nparts", "4"],
                                  ["--manufactured-solution"]])
def test_cli_refuses_gen_direct_sizes(flag):
    """Above 2^24 rows a gen: spec takes the gen-direct tier; its sharded
    branch (parts, manufactured solutions) refuses what it cannot serve,
    here --kernels fused, with the reference's message before any device
    work."""
    with pytest.raises(SystemExit, match="the sharded direct-assembly "
                                         "path supports --kernels "
                                         "auto/xla"):
        torch_main(["gen:poisson3d:300", "--device", "cpu", "--kernels",
                    "fused"] + flag)


_NO_JAX = """
import os
import sys
sys.modules["jax"] = None
sys.modules["acg_tpu"] = None
import acg_tpu_torch
import acg_tpu_torch.graph
import acg_tpu_torch.parallel.dist
import acg_tpu_torch.parallel.halo
import acg_tpu_torch.parallel.halo_dma
import acg_tpu_torch.parallel.reductions
import acg_tpu_torch.partition
import acg_tpu_torch.precond
import acg_tpu_torch.ops.precision
import acg_tpu_torch.solvers.refine
import acg_tpu_torch.solvers.batched
import acg_tpu_torch.solvers.resilience
import acg_tpu_torch.recurrence
import acg_tpu_torch.parallel.dist_batched
import acg_tpu_torch.parallel.sharded_dia
import acg_tpu_torch.solvers.host_cg
import acg_tpu_torch.solvers.petsc_cg
import acg_tpu_torch.vector
import acg_tpu_torch._native
import acg_tpu_torch.prng
import acg_tpu_torch.parallel.erragree
import acg_tpu_torch.parallel.mesh
import acg_tpu_torch.parallel.multihost
import acg_tpu_torch.telemetry
import acg_tpu_torch.metrics
import acg_tpu_torch.tracing
import acg_tpu_torch.observatory
import acg_tpu_torch.solvers.profile
import acg_tpu_torch.faults
import acg_tpu_torch.health
import acg_tpu_torch.checkpoint
import acg_tpu_torch.soak
from acg_tpu_torch.cli import main
import tempfile
from acg_tpu_torch.tools import genmatrix, mtx2bin, mtxpartition
d = tempfile.mkdtemp()
A = os.path.join(d, "A.mtx")
assert genmatrix.main(["-n", "12", "-o", A]) == 0
with open(os.path.join(d, "part.mtx"), "wb") as f:
    sys.stdout = f
    sys.stdout.buffer = f
    try:
        assert mtxpartition.main([A, "--parts", "3"]) == 0
    finally:
        sys.stdout = sys.__stdout__
assert mtx2bin.main(["--expand", "--partition",
                     os.path.join(d, "part.mtx"), A, A + ".p"]) == 0
for extra in (["--solver", "host"], ["--solver", "host-native"],
              ["--solver", "petsc"], ["--solver", "host", "--nparts", "3"]):
    assert main([A + ".p", "--binary", "--device", "cpu", "-q",
                 "--max-iterations", "300"] + extra) == 0
for extra in (["--nrhs", "3"], ["--nrhs", "3", "--block-cg"],
              ["--nrhs", "3", "--solver", "acg-pipelined",
               "--precond", "jacobi"]):
    assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup",
                 "0", "--max-iterations", "300"] + extra) == 0
assert main(["--buildinfo"]) == 0
assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup", "0",
             "--manufactured-solution", "--solver", "acg-pipelined",
             "--kernels", "pallas", "--max-iterations", "300"]) == 0
assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup", "0",
             "--manufactured-solution", "--solver", "acg-pipelined",
             "--nparts", "3", "--comm", "dma", "--kernels", "pallas",
             "--max-iterations", "300"]) == 0
for extra in (["--nparts", "3", "--comm", "dma"], ["--comm", "none"]):
    assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup",
                 "0", "--operator", "stencil", "--kernels", "pallas",
                 "--max-iterations", "300"] + extra) == 0
for extra in (["--precond", "cheby:2", "--solver", "acg-pipelined"],
              ["--precond", "bjacobi:8", "--nparts", "3", "--comm", "dma"],
              ["--dtype", "f32", "--precise-dots", "--residual-rtol", "1e-6"],
              ["--dtype", "bf16", "--replace-every", "20",
               "--residual-rtol", "1e-3"],
              ["--dtype", "f32", "--refine", "--residual-rtol", "1e-11"]):
    assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup",
                 "0", "--kernels", "pallas", "--max-iterations", "600"]
                + extra) == 0
for extra in (["--algorithm", "sstep:4"], ["--algorithm", "pipelined:2"],
              ["--algorithm", "sstep:2", "--nparts", "3", "--comm", "dma"],
              ["--algorithm", "pipelined:1", "--nparts", "3"],
              ["--nrhs", "3", "--nparts", "3"],
              ["--nrhs", "3", "--nparts", "3", "--solver", "acg-pipelined",
               "--precise-dots"]):
    assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup",
                 "0", "--kernels", "pallas" if "--nrhs" not in extra
                 else "auto", "--max-iterations", "600"] + extra) == 0
os.environ["ACG_TPU_GEN_DIRECT_MIN"] = "100"
assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup", "0",
             "--operator", "stencil", "--algorithm", "sstep:4",
             "--max-iterations", "300"]) == 0
assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup", "0",
             "--operator", "stencil", "--max-iterations", "300"]) == 0
for extra in (["--nparts", "3", "--kernels", "pallas"],
              ["--refine", "--dtype", "f32", "--manufactured-solution",
               "--residual-rtol", "1e-11"]):
    assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup",
                 "0", "--max-iterations", "600"] + extra) == 0
assert main(["gen:poisson3d:6", "--device", "cpu", "-q", "--warmup", "0",
             "--nparts", "2", "--manufactured-solution",
             "--max-iterations", "600"]) == 0
os.environ["ACG_TPU_GEN_DIRECT_MIN"] = str(2 ** 24)
assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup", "0",
             "--nparts", "3", "--kernels", "fused", "--comm", "dma",
             "--solver", "acg-pipelined", "--max-iterations", "600"]) == 0
assert mtx2bin.main(["--expand", A, A + ".e"]) == 0
assert main([A + ".e", "--binary", "--distributed-read", "--nparts", "3",
             "--device", "cpu", "-q", "--warmup", "0",
             "--manufactured-solution", "--max-iterations", "300",
             "-o", os.path.join(d, "x.bin")]) == 0
o = os.path.join(d, "obs")
assert main(["gen:poisson2d:12", "--device", "cpu", "-q", "--warmup", "1",
             "--max-iterations", "300", "--residual-rtol", "1e-8",
             "--convergence-log", o + ".jsonl", "--progress", "5",
             "--stats-json", o + ".json", "--metrics-file", o + ".prom",
             "--status-file", o + ".status", "--history", o + "-hist",
             "--slo", "iters=1000", "--profile-ops", "2",
             "--trace", o + "-trace", "--timeline", o + "-tl.json"]) == 0
loaded = [m for m, v in sys.modules.items() if v is not None
          and (m.split(".")[0] in ("jax", "jaxlib", "acg_tpu"))]
assert not loaded, loaded
print("NO-JAX-OK")
"""


def _run(code_or_args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str)
            else [sys.executable] + code_or_args)
    return subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_neither_jax_nor_acg_tpu():
    res = _run(_NO_JAX)
    assert res.returncode == 0, res.stderr
    assert "NO-JAX-OK" in res.stdout


def test_cli_without_device_flag_refuses_to_solve_on_cpu():
    """No card and no --device cpu: exit non-zero with the device error,
    before any solve (no stats block)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run(["-m", "acg_tpu_torch", "gen:poisson2d:8", "-q"])
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "total solver time" not in res.stderr


def test_default_nparts_is_one_on_a_many_card_host(monkeypatch):
    """On CUDA the default part count is 1 however many cards the host
    has: the port stacks every part on one card, where acg_tpu places
    one part on each device."""
    from acg_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cli._default_nparts(torch.device("cuda")) == 1


@pytest.mark.parametrize("extra,nparts", [([], 1), (["--nparts", "4"], 4),
                                          (["--comm", "none"], 1)])
def test_cli_part_count_with_four_cards(monkeypatch, capsys, extra, nparts):
    """Through the CLI with a patched count of 4 cards: no --nparts
    gives one part, an explicit --nparts 4 still stacks 4, and --comm
    none keeps 1 (the -v log names the count)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert torch_main(["gen:poisson2d:12", "--device", "cpu", "-v",
                       "--warmup", "0", "--max-iterations", "300"]
                      + extra) == 0
    assert f"partition rows into {nparts} parts" in capsys.readouterr().err


def test_cli_compat_flags(tmp_path, capsys):
    """tests/test_cli.py::test_cli_compat_flags's cases on the port: the
    gzip flags, the --binary-partition alias and the --no-* negations,
    registered before their partners so the default stays False."""
    import gzip

    from acg_tpu.io.generators import poisson_mtx
    from acg_tpu.io.mtxfile import write_mtx

    mtx = tmp_path / "p.mtx"
    write_mtx(mtx, poisson_mtx(12, dim=2))
    gz = tmp_path / "p.mtx.gz"
    gz.write_bytes(gzip.compress(mtx.read_bytes()))
    assert torch_main([str(gz), "--gzip", "--comm", "none", "--device",
                       "cpu", "--max-iterations", "300", "--residual-rtol",
                       "1e-8", "--manufactured-solution",
                       "--no-manufactured-solution", "--warmup", "0",
                       "--quiet"]) == 0
    assert "error 2-norm" not in capsys.readouterr().err
    assert torch_main([str(mtx), "--binary-partition", "--ungzip",
                       "--comm", "none", "--device", "cpu",
                       "--max-iterations", "10", "--residual-rtol", "0",
                       "--warmup", "0", "--quiet"]) == 0
    assert torch_main([str(mtx), "--nparts", "2", "--device", "cpu",
                       "--output-comm-matrix", "--no-output-comm-matrix",
                       "--max-iterations", "300", "--warmup", "0",
                       "--quiet"]) == 0
    assert "%%MatrixMarket" not in capsys.readouterr().out


def test_parser_flags_match_jax_parser():
    """Every flag the port's parser takes has the reference parser's
    dest, default, choices, nargs and type -- the multi-process flags and
    the hidden --no-* negations included."""
    from acg_tpu.cli import make_parser as jax_parser
    from acg_tpu_torch.cli import make_parser

    ref = {s: a for a in jax_parser()._actions for s in a.option_strings}
    port_only = {"--device", "--buildinfo"}
    for action in make_parser()._actions:
        for s in action.option_strings:
            if s in port_only or s in ("-h", "--help", "--version"):
                continue
            assert s in ref, s
            r = ref[s]
            for attr in ("dest", "default", "choices", "nargs", "type"):
                assert getattr(action, attr) == getattr(r, attr), (s, attr)
    for s in ("--multihost", "--coordinator", "--num-processes",
              "--process-id", "--distributed-read", "--err-timeout",
              "--heartbeat", "--no-manufactured-solution",
              "--no-output-comm-matrix"):
        assert s in {o for a in make_parser()._actions
                     for o in a.option_strings}, s


@pytest.mark.parametrize("spec", ["gen:poisson2d:1", "gen:poisson2d:7",
                                  "gen:poisson2d:16", "gen:poisson3d:2",
                                  "gen:poisson3d:9"])
def test_synthesized_poisson_is_the_references(spec):
    """gen:poisson specs are built straight in packed upper CSR: the
    arrays the reference assembles from its COO triplets, bitwise."""
    from acg_tpu.cli import synthesize_host_matrix as jax_synth
    from acg_tpu_torch.cli import synthesize_host_matrix

    t, j = synthesize_host_matrix(spec), jax_synth(spec)
    assert t.nrows == j.nrows
    for name in ("prowptr", "pcolidx", "pa"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
