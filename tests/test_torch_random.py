"""The port's threefry draw (acg_tpu_torch.prng) against jax.random, and
the sharded tier's manufactured solution against the JAX package's.

The bits are exact.  The normals are evaluated as XLA's CPU backend
evaluates them (FMA-contracted Horner steps, Cephes' log1p below
sqrt(2) - 1); XLA's own ``log`` above that threshold is an ulp off the
C library's for a few arguments, so a few draws differ by up to 3 ulp
(and the rest to the bit)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acg_tpu_torch import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 42, 7, 2 ** 33 + 5])
@pytest.mark.parametrize("n", [1, 7, 1000, 70001])
def test_bits_match_jax(seed, n):
    for width, jdt in ((32, jnp.uint32), (64, jnp.uint64)):
        want = np.asarray(jax.random.bits(jax.random.key(seed), (n,), jdt))
        got = prng.random_bits(seed, n, width).numpy()
        assert np.array_equal(got.astype(want.dtype) if width == 32
                              else got.view(np.uint64), want), (seed, n,
                                                                width)


def _ulps(got, want):
    return np.abs(got - want) / np.spacing(np.abs(want).astype(want.dtype))


@pytest.mark.parametrize("seed", [0, 42, 2 ** 33 + 5])
@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_normals_match_jax(seed, kind):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "f64": (jnp.float64, torch.float64)}[kind]
    n = 100_003
    want = np.asarray(jax.random.normal(jax.random.key(seed), (n,),
                                        dtype=jdt))
    got = prng.normal(seed, n, tdt).numpy()
    d = _ulps(got, want)
    # bit for bit but where XLA's log leaves the C library's by an ulp
    assert d.max() <= 3, d.max()
    assert (d > 0).mean() <= (0.03 if kind == "f32" else 1e-3)


def test_erfinv_and_log1p_follow_xla():
    """The two pieces on their own: within one ulp of XLA's log1p and
    two of its erfinv, on the arguments the normal's u takes."""
    rng = np.random.default_rng(3)
    for dt in (np.float32, np.float64):
        u = rng.uniform(-1, 1, 50_000).astype(dt)
        lj = np.asarray(jnp.log1p(jnp.asarray(-u * u)))
        lm = prng.log1p_xla(torch.from_numpy(-u * u)).numpy()
        assert _ulps(lm, lj).max() <= 1
        ej = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
        em = prng.erfinv_xla(torch.from_numpy(u.copy())).numpy()
        assert _ulps(em, ej).max() <= 2


def test_chunks_do_not_change_the_draw(monkeypatch):
    a = prng.normal(11, 5000, torch.float64)
    monkeypatch.setattr(prng, "_CHUNK", 777)
    assert torch.equal(prng.normal(11, 5000, torch.float64), a)


@pytest.mark.parametrize("rows", [(0, 5000), (0, 1), (776, 1555),
                                  (1234, 4321), (4999, 5000), (300, 300)])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_row_slice_is_the_whole_draws_slice(monkeypatch, rows, dt):
    """``rows=(lo, hi)`` draws exactly elements [lo, hi) of the whole
    draw, across chunk boundaries: a rank draws only its own window."""
    whole = prng.normal(11, 5000, dt)
    monkeypatch.setattr(prng, "_CHUNK", 777)
    part = prng.normal(11, 5000, dt, rows=rows)
    assert torch.equal(part, whole[rows[0]:rows[1]])


def test_row_slice_outside_the_draw_raises():
    with pytest.raises(ValueError, match="outside"):
        prng.normal(1, 10, torch.float64, rows=(5, 11))


def test_sharded_manufactured_solution_is_the_reference_draw():
    """The sharded tier's x is jax.random.normal(key(seed)) over N rows,
    divided by its norm (the JAX package's sharded_dia.manufactured)."""
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver

    s = build_sharded_poisson_solver(8, 3, nparts=2, dtype=torch.float64,
                                     device="cpu")
    x, b = s.manufactured(seed=5)
    ref = np.asarray(jax.random.normal(jax.random.key(5), (512,),
                                       dtype=jnp.float64))
    ref = ref / np.linalg.norm(ref)
    assert np.max(np.abs(x.numpy() - ref)) <= 1e-15


def _cli(module):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               ACG_TPU_GEN_DIRECT_MIN="100",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    argv = [sys.executable, "-m", module, "gen:poisson3d:12", "--nparts",
            "4", "--manufactured-solution", "--dtype", "f32", "--refine",
            "--residual-rtol", "1e-9", "--warmup", "0", "-q"]
    if module == "acg_tpu_torch":
        argv += ["--device", "cpu"]
    res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stderr


def _value(text, key):
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith(key + ":"))
    return line.split(":", 1)[1].strip()


def test_cli_sharded_refine_takes_the_reference_iterations():
    """The sharded manufactured f32 refine on 4 parts: the same
    iterations as acg_tpu, the right-hand side 2-norm within 1e-6
    relative."""
    jerr, terr = _cli("acg_tpu.cli"), _cli("acg_tpu_torch")
    assert _value(terr, "iterations") == _value(jerr, "iterations")
    bj = float(_value(jerr, "right-hand side 2-norm"))
    bt = float(_value(terr, "right-hand side 2-norm"))
    assert abs(bt - bj) <= 1e-6 * bj
