"""The port's offline tools, nested dissection and permuted inputs against
the JAX package's.

``python -m acg_tpu_torch.tools.{genmatrix,mtxpartition,mtx2bin}`` must
write byte-identical files (sidecars included) for the same input and
flags; the orderings must be the same permutations; and a CLI solve of a
partition-permuted file (``mtx2bin --expand --partition``) must give the
unpermuted solve's answer in the original row order, as the JAX CLI
does on the same files.
"""

import numpy as np
import pytest

from acg_tpu.tools import genmatrix as jgen
from acg_tpu.tools import mtx2bin as jm2b
from acg_tpu.tools import mtxpartition as jpart
from acg_tpu_torch.tools import genmatrix as tgen
from acg_tpu_torch.tools import mtx2bin as tm2b
from acg_tpu_torch.tools import mtxpartition as tpart

TOOLS = {"jax": (jgen, jpart, jm2b), "torch": (tgen, tpart, tm2b)}


def _pipeline(pkg, d, capsysbinary, gen_flags, part_flags, m2b_flags):
    """genmatrix -> mtxpartition (stdout) -> mtx2bin in directory d."""
    gen, part, m2b = TOOLS[pkg]
    d.mkdir()
    A = str(d / "A.mtx")
    assert gen.main(gen_flags + ["-o", A]) == 0
    capsysbinary.readouterr()
    binary = ["--binary"] if "--binary" in gen_flags else []
    assert part.main([A] + binary + part_flags) == 0
    (d / "part.mtx").write_bytes(capsysbinary.readouterr().out)
    if not binary:
        assert m2b.main(m2b_flags + ["--partition", str(d / "part.mtx"),
                                     A, str(d / "P.bin.mtx")]) == 0
        assert m2b.main([A, str(d / "A.bin.mtx")]) == 0
    return sorted(p.name for p in d.iterdir())


@pytest.mark.parametrize("gen_flags,part_flags", [
    (["-n", "20"], ["--parts", "4"]),
    (["-n", "6", "--dim", "3"], ["--parts", "3", "--method", "band"]),
    (["-n", "20", "--binary"], ["--parts", "2", "--output-binary"]),
    (["--kind", "irregular", "-n", "300", "--seed", "5"],
     ["--parts", "5", "--seed", "2"]),
    (["--kind", "irregular", "-n", "200", "--avg-degree", "6"],
     ["--parts", "3", "--variant", "recursive", "--numfmt", "%3d"]),
])
def test_tools_write_byte_identical_files(tmp_path, capsysbinary,
                                          gen_flags, part_flags):
    names = {}
    for pkg in TOOLS:
        names[pkg] = _pipeline(pkg, tmp_path / pkg, capsysbinary, gen_flags,
                               part_flags, ["--expand"])
    assert names["jax"] == names["torch"]
    for name in names["jax"]:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "torch" / name).read_bytes(), name


@pytest.mark.parametrize("flags", [["--integer"], ["--double", "-v"],
                                   ["--expand", "--one-based"]])
def test_mtx2bin_options_byte_identical(tmp_path, flags):
    from acg_tpu_torch.io.generators import poisson_mtx
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx
    src = tmp_path / "A.mtx"
    write_mtx(src, poisson_mtx(7))
    part = tmp_path / "p1.mtx"
    write_mtx(part, vector_mtx(np.arange(49) % 3 + 1, field="integer"),
              numfmt="%d")
    extra = ["--partition", str(part)] if "--one-based" in flags else []
    for pkg, m2b in (("jax", jm2b), ("torch", tm2b)):
        assert m2b.main(flags + extra + [str(src),
                                         str(tmp_path / f"{pkg}.bin")]) == 0
    for ext in ("", ".perm.mtx", ".bounds.mtx"):
        j, t = tmp_path / f"jax.bin{ext}", tmp_path / f"torch.bin{ext}"
        assert j.exists() == t.exists()
        if j.exists():
            assert j.read_bytes() == t.read_bytes()


def test_mtx2bin_refuses_ambiguous_partition(tmp_path, capsys):
    from acg_tpu_torch.io.generators import poisson_mtx
    from acg_tpu_torch.io.mtxfile import vector_mtx, write_mtx
    src = tmp_path / "A.mtx"
    write_mtx(src, poisson_mtx(4))
    part = tmp_path / "p.mtx"
    write_mtx(part, vector_mtx(np.arange(16) % 2 + 1, field="integer"),
              numfmt="%d")
    errs = []
    for m2b in (jm2b, tm2b):
        with pytest.raises(SystemExit) as e:
            m2b.main(["--expand", "--partition", str(part), str(src),
                      str(tmp_path / "o.bin")])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.split("error: ")[1])
    assert errs[0] == errs[1] and "ambiguous" in errs[0]


@pytest.mark.parametrize("kind", ["poisson", "irregular"])
def test_nested_dissection_same_permutation(kind):
    """Built-in recursion where libmetis is absent, METIS_NodeND where
    it is present (``use_metis="auto"`` in both packages)."""
    from acg_tpu.io.generators import irregular_spd_coo, poisson2d_coo
    from acg_tpu.matrix import SymCsrMatrix
    from acg_tpu.partition import nested_dissection as jnd
    from acg_tpu_torch.partition import is_permutation
    from acg_tpu_torch.partition import nested_dissection as tnd
    r, c, v, N = (poisson2d_coo(24) if kind == "poisson"
                  else irregular_spd_coo(600, avg_degree=8.0, seed=1))
    csr = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    for seed in (0, 3):
        jp, ji = jnd(csr, seed=seed)
        tp, ti = tnd(csr, seed=seed)
        assert np.array_equal(jp, tp) and np.array_equal(ji, ti)
        assert is_permutation(tp, N) and np.array_equal(tp[ti],
                                                        np.arange(N))


def test_metis_entry_points_match_reference():
    """``metis_nd`` and ``metis_available`` agree with the JAX package's
    (both probe the same libmetis through ctypes); without libmetis both
    refuse with the same error."""
    from acg_tpu.io.generators import poisson2d_coo
    from acg_tpu.matrix import SymCsrMatrix
    from acg_tpu.partition import metis_available as jav
    from acg_tpu.partition import metis_nd as jnd
    from acg_tpu_torch.partition import metis_available as tav
    from acg_tpu_torch.partition import metis_nd as tnd
    assert jav() == tav()
    r, c, v, N = poisson2d_coo(10)
    g = SymCsrMatrix.from_coo(N, r, c, v).to_csr()
    g.setdiag(0)
    g.eliminate_zeros()
    outs = []
    for f in (jnd, tnd):
        try:
            outs.append(f(g.indptr.astype(np.int64),
                          g.indices.astype(np.int64)))
        except Exception as e:  # noqa: BLE001 -- compared below
            outs.append(str(e))
    if tav():
        assert all(np.array_equal(a, b) for a, b in zip(*outs))
    else:
        assert outs[0] == outs[1] and "libmetis not found" in outs[1]


def test_is_permutation_matches_reference():
    from acg_tpu.partition import is_permutation as jip
    from acg_tpu_torch.partition import is_permutation as tip
    cases = [(np.array([2, 0, 1]), 3), (np.array([0, 0, 1]), 3),
             (np.array([0, 1]), 3), (np.array([], np.int64), 0),
             (np.array([0.0, 1.0]), 2), (np.array([0, 3, 1]), 3)]
    for p, n in cases:
        assert jip(p, n) == tip(p, n)


def test_cli_solves_permuted_input_in_original_order(tmp_path,
                                                     capsysbinary):
    """Partition-permuted binary file vs the unpermuted text file, a b
    file given in the original order: the port's two solves agree (the
    same iterations, x within 1e-12), and the port matches the JAX CLI
    on the permuted file (the same iterations, x within 1e-10)."""
    from acg_tpu.cli import main as jax_main
    from acg_tpu_torch.cli import main as torch_main
    from acg_tpu_torch.io.mtxfile import read_mtx, vector_mtx, write_mtx
    _pipeline("torch", tmp_path / "t", capsysbinary,
              ["--kind", "irregular", "-n", "400", "--seed", "2"],
              ["--parts", "4"], ["--expand"])
    d = tmp_path / "t"
    n = 400
    b = np.random.default_rng(0).standard_normal(n)
    write_mtx(d / "b.mtx", vector_mtx(b))
    write_mtx(d / "bb.mtx", vector_mtx(b), binary=True)
    common = ["--max-iterations", "2000", "--residual-rtol", "1e-11",
              "--warmup", "0", "-q"]
    runs = {
        "plain": (torch_main, [str(d / "A.mtx"), str(d / "b.mtx"),
                               "--device", "cpu"]),
        "perm": (torch_main, [str(d / "P.bin.mtx"), str(d / "bb.mtx"),
                              "--binary", "--device", "cpu"]),
        "jax": (jax_main, [str(d / "P.bin.mtx"), str(d / "bb.mtx"),
                           "--binary", "--comm", "none"]),
    }
    xs, its = {}, {}
    for name, (main, argv) in runs.items():
        out = d / f"x_{name}.mtx"
        assert main(argv + common + ["-o", str(out)]) == 0
        err = capsysbinary.readouterr().err.decode()
        its[name] = [ln for ln in err.splitlines()
                     if ln.startswith("  iterations:")][0]
        xs[name] = np.asarray(read_mtx(out, binary=True).vals)
    assert its["plain"] == its["perm"] == its["jax"]
    nrm = np.linalg.norm(xs["plain"])
    assert np.linalg.norm(xs["perm"] - xs["plain"]) <= 1e-12 * nrm
    assert np.linalg.norm(xs["perm"] - xs["jax"]) <= 1e-10 * nrm


def test_tools_version_strings(capsys):
    for mod, prog in ((tpart, "acg-tpu-torch-mtxpartition"),
                      (tm2b, "acg-tpu-torch-mtx2bin")):
        with pytest.raises(SystemExit):
            mod.main(["--version"])
        assert capsys.readouterr().out.strip() == f"{prog} (acg_tpu_torch)"
