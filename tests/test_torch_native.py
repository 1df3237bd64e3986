"""The port's native host core (acg_tpu_torch._native) against the JAX
package's library and against the port's own numpy paths.

Both libraries are built from ``native/src``: the port's by its own
build into ``acg_tpu_torch/_build/native-*``, the reference's by
``native/Makefile`` run on a copy of ``native/`` in a temporary
directory (the checkout's ``native/`` is never written), so every
binding is held bitwise to the reference library's through the JAX
package's own wrappers; each native
fast path of ``matrix``, ``graph`` and ``io.mtxfile`` is held bitwise to
the numpy path it replaces; the native CG against the numpy host CG.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from acg_tpu import _native as jnat
from acg_tpu.io.generators import irregular_spd_coo, poisson2d_coo
from acg_tpu_torch import _native as tnat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csr(kind="poisson"):
    from acg_tpu_torch.matrix import SymCsrMatrix
    if kind == "poisson":
        r, c, v, N = poisson2d_coo(16)
    else:
        r, c, v, N = irregular_spd_coo(500, avg_degree=10.0, seed=2)
    return SymCsrMatrix.from_coo(N, r, c, v).to_csr()


def test_port_library_builds_outside_native():
    assert tnat.available(), tnat.build_error
    path = tnat._path
    openmp = tnat.openmp_error is None
    assert path == tnat.library_path(openmp) and path.exists()
    assert path.parent.parent == tnat._BUILD_ROOT
    assert path.parent.name == f"native-{tnat.source_hash(openmp)}"
    assert os.path.commonpath([str(path), os.path.join(ROOT, "native")]) \
        != os.path.join(ROOT, "native")


def test_serial_build_gives_the_same_arrays(tmp_path, monkeypatch):
    """A host whose compiler cannot link OpenMP builds the core without
    -fopenmp; that library gives the OpenMP build's arrays."""
    monkeypatch.setattr(tnat, "_BUILD_ROOT", tmp_path)
    serial = tnat._open_and_bind(tnat._compile(False))
    assert serial is not None
    assert tnat.source_hash(False) != tnat.source_hash(True)
    cases = _binding_cases()
    for name in ("parse_coord", "format_coord", "sym_csr_from_coo",
                 "graph_partition"):
        ref = cases[name](tnat)
        monkeypatch.setattr(tnat, "_lib", serial)
        got = cases[name](tnat)
        monkeypatch.undo()
        monkeypatch.setattr(tnat, "_BUILD_ROOT", tmp_path)
        for a, c in zip(_flat(ref), _flat(got)):
            assert np.array_equal(np.asarray(a), np.asarray(c)), name


def _flat(o) -> list:
    """A binding's outputs as a list (dicts in key order)."""
    if isinstance(o, dict):
        return [o[k] for k in sorted(o)]
    if isinstance(o, (tuple, list)):
        return list(o)
    return [o]


def _binding_cases():
    rng = np.random.default_rng(0)
    keys = rng.integers(-2**62, 2**62, 5001)
    small = rng.integers(0, 9, 3000)
    csr = _csr("irregular")
    coo = csr.tocoo()
    upper = coo.row <= coo.col
    vals = rng.standard_normal(400)
    text = b"".join(b"%d %d %.17g\n" % (i % 30 + 1, i % 17 + 1, v)
                    for i, v in enumerate(vals))
    n = csr.shape[0]
    b = csr @ rng.standard_normal(n)
    part = (np.arange(n) * 5 // n).astype(np.int32)
    return {
        "radixsort": lambda m: m.radixsort(keys),
        "argsort": lambda m: m.argsort(small),
        "prefixsum": lambda m: m.prefixsum_exclusive(small),
        "parse_coord": lambda m: m.parse_coord(text, 400, 30, 17, True),
        "parse_array": lambda m: m.parse_array(
            " ".join(f"{v:.17g}" for v in vals).encode(), 400),
        "format_coord": lambda m: m.format_coord(coo.row, coo.col,
                                                 coo.data),
        "format_array": lambda m: m.format_array(vals, "%.6e"),
        "sym_csr_from_coo": lambda m: m.sym_csr_from_coo(
            n, coo.row, coo.col, coo.data),
        "sym_csr_expand": lambda m: m.sym_csr_expand(
            n, *m.sym_csr_from_coo(n, coo.row[upper], coo.col[upper],
                                   coo.data[upper]), epsilon=0.5),
        "graph_partition": lambda m: m.graph_partition(
            n, csr.indptr, csr.indices, part, 5),
        "cg_solve": lambda m: m.cg_solve(csr.indptr, csr.indices, csr.data,
                                         b, maxits=500, res_rtol=1e-10),
    }


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    """The reference's library, built by its Makefile from a copy of
    ``native/``."""
    import shutil
    d = tmp_path_factory.mktemp("refnative") / "native"
    shutil.copytree(os.path.join(ROOT, "native"), d,
                    ignore=shutil.ignore_patterns(".build_failed", "*.o",
                                                  "*.so"))
    subprocess.run(["make", "-j5", "-C", str(d)], check=True,
                   capture_output=True, timeout=300)
    lib = jnat._open_and_bind(str(d / "libacg_core.so"))
    assert lib is not None
    return lib


@pytest.mark.parametrize("name", sorted(_binding_cases()))
def test_binding_bitwise_against_reference_library(name, ref_lib,
                                                   monkeypatch):
    assert tnat.available(), tnat.build_error
    monkeypatch.setattr(jnat, "_lib", ref_lib)
    case = _binding_cases()[name]
    ref, port = case(jnat), case(tnat)
    if name == "cg_solve":
        # the C loop's dots are OpenMP reductions, which combine the
        # thread partials in arrival order: one library differs from
        # itself run to run, so x is held to 1e-12 and the counts exactly
        assert ref[2] == port[2] and ref[6:] == port[6:]
        np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=1e-12)
        return
    for a, c in zip(_flat(ref), _flat(port)):
        if isinstance(a, np.ndarray):
            assert a.dtype == c.dtype and np.array_equal(a, c)
        else:
            assert a == c


@pytest.fixture
def numpy_path(monkeypatch):
    """Run the port's numpy fallbacks (the library switched off)."""
    def off():
        monkeypatch.setattr(tnat, "_lib", None)
    return off


@pytest.mark.parametrize("kind", ["poisson", "irregular"])
def test_matrix_assembly_native_vs_numpy(kind, numpy_path):
    from acg_tpu_torch.matrix import SymCsrMatrix
    if kind == "poisson":
        r, c, v, N = poisson2d_coo(16)
    else:
        r, c, v, N = irregular_spd_coo(500, avg_degree=10.0, seed=2)
    nat = SymCsrMatrix.from_coo(N, r, c, v)
    nat_csr = nat.to_csr(epsilon=0.25)
    numpy_path()
    npy = SymCsrMatrix.from_coo(N, r, c, v)
    npy_csr = npy.to_csr(epsilon=0.25)
    for f in ("prowptr", "pcolidx", "pa"):
        assert np.array_equal(getattr(nat, f), getattr(npy, f))
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(nat_csr, f), getattr(npy_csr, f))


def test_graph_partition_native_vs_numpy(numpy_path):
    from acg_tpu_torch.graph import partition_graph_nodes
    csr = _csr("irregular")
    part = (np.arange(csr.shape[0]) % 4).astype(np.int32)
    nat = partition_graph_nodes(csr, part, 4)
    numpy_path()
    npy = partition_graph_nodes(csr, part, 4)
    for a, b in zip(nat, npy):
        assert (a.ninterior, a.nborder, a.nghost) == \
            (b.ninterior, b.nborder, b.nghost)
        assert np.array_equal(a.global_ids, b.global_ids)
        for f in ("send_parts", "send_counts", "send_idx", "recv_parts",
                  "recv_counts", "recv_idx"):
            assert np.array_equal(getattr(a.halo, f), getattr(b.halo, f))


def test_mtxfile_native_vs_numpy_read_and_write(tmp_path, numpy_path):
    from acg_tpu_torch.io.generators import irregular_mtx
    from acg_tpu_torch.io.mtxfile import (_rowcol_argsort, read_mtx,
                                          vector_mtx, write_mtx)
    mtx = irregular_mtx(300, seed=4)
    vec = vector_mtx(np.random.default_rng(3).standard_normal(50))
    write_mtx(tmp_path / "a.mtx", mtx)
    write_mtx(tmp_path / "v.mtx", vec, numfmt="%.9e")
    nat_m, nat_v = read_mtx(tmp_path / "a.mtx"), read_mtx(tmp_path / "v.mtx")
    key = _rowcol_argsort(mtx.colidx, mtx.rowidx, mtx.ncols)
    numpy_path()
    write_mtx(tmp_path / "a2.mtx", mtx)
    write_mtx(tmp_path / "v2.mtx", vec, numfmt="%.9e")
    assert (tmp_path / "a.mtx").read_bytes() == \
        (tmp_path / "a2.mtx").read_bytes()
    assert (tmp_path / "v.mtx").read_bytes() == \
        (tmp_path / "v2.mtx").read_bytes()
    npy_m, npy_v = read_mtx(tmp_path / "a.mtx"), read_mtx(tmp_path / "v.mtx")
    for f in ("rowidx", "colidx", "vals"):
        assert np.array_equal(getattr(nat_m, f), getattr(npy_m, f))
    assert np.array_equal(nat_v.vals, npy_v.vals)
    assert np.array_equal(key, _rowcol_argsort(mtx.colidx, mtx.rowidx,
                                               mtx.ncols))


@pytest.mark.parametrize("crit_kw", [dict(residual_rtol=1e-11),
                                     dict(diff_atol=1e-10)])
def test_native_cg_matches_numpy_host_cg(crit_kw):
    from acg_tpu_torch.solvers.host_cg import (HostCGSolver,
                                               NativeHostCGSolver)
    from acg_tpu_torch.solvers.stats import StoppingCriteria
    csr = _csr()
    n = csr.shape[0]
    rng = np.random.default_rng(5)
    xsol = rng.standard_normal(n)
    b = csr @ xsol
    x0 = np.full(n, 0.1)
    crit = StoppingCriteria(maxits=5000, **crit_kw)
    py = HostCGSolver(csr)
    nt = NativeHostCGSolver(csr)
    xp = py.solve(b, x0=x0, criteria=crit)
    xn = nt.solve(b, x0=x0, criteria=crit)
    # the same f64 recurrence; the C loop sums its dots in its own order
    assert nt.stats.niterations == py.stats.niterations
    np.testing.assert_allclose(xn, xp, rtol=0, atol=1e-10)


def test_disabled_native_core_is_visible():
    """With ACG_TPU_DISABLE_NATIVE=1 the numpy paths run, --buildinfo
    says so, and --solver host-native refuses instead of falling back."""
    env = dict(os.environ, PYTHONPATH=ROOT, ACG_TPU_DISABLE_NATIVE="1")
    code = ("from acg_tpu_torch import _native as n; "
            "print(n.available(), n.build_error)")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == \
        "False disabled (ACG_TPU_DISABLE_NATIVE)", res.stderr
    res = subprocess.run(
        [sys.executable, "-m", "acg_tpu_torch", "gen:poisson2d:8",
         "--device", "cpu", "--solver", "host-native", "-q"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert "native core unavailable (disabled" in res.stderr
    res = subprocess.run(
        [sys.executable, "-m", "acg_tpu_torch", "--buildinfo"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert ("native core (libacg_core): no (numpy fallbacks: disabled"
            in res.stdout)
