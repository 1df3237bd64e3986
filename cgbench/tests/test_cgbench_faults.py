"""The comparison catches a broken timed path.  Each test drives a whole
run of a benchmark cell, cut to a test size, on the CPU (skipping the
look for a chip) with the timed path broken underneath, and sees
``correct`` come out false; the same run unbroken comes out true.  The
control -- the plain reference in float32 in the program's place -- is
one of the faults."""

import dataclasses
import json
import multiprocessing as mp
import socket

import pytest
import torch

from cgbench import harness, program, reference, spec

SEED = 2 ** 32 + 3


def small(name: str, **traffic) -> spec.Cell:
    c = spec.load_cell(name)
    cfg = dict(c.config, n=24 if c.config["dim"] == 2 else 8)
    return dataclasses.replace(c, config=cfg,
                               traffic=dict(c.traffic, **traffic))


CELLS = {
    "fixed": lambda: small("p2d2048-cg-f64-1000it", iterations=40),
    "rtol": lambda: small("p3d512-cg-f64-rtol1e-6"),
    "3d": lambda: small("p3d512-cg-f64-100it", iterations=20),
}


def run_line(cell) -> dict:
    out = harness.run(cell, SEED, 0.3, False, device="cpu")
    return harness.result_line(out, False)


def _unchanged(solve):
    def f(solver, b, maxits, rtol):
        x, k, c = solve(solver, b, maxits, rtol)
        return torch.zeros_like(x), k, c
    return f


def _altered(solve):
    def f(solver, b, maxits, rtol):
        x, k, c = solve(solver, b, maxits, rtol)
        x = x.clone()
        x[x.numel() // 3] += 1.0
        return x, k, c
    return f


def _early(solve):
    def f(solver, b, maxits, rtol):
        if rtol:
            return solve(solver, b, maxits, rtol * 30)
        return solve(solver, b, maxits // 2, rtol)
    return f


def _control(solve):
    """The control: the plain reference in float32 in the program's
    place, with the program's stopping rule."""
    def f(solver, b, maxits, rtol):
        n, dim = solver.stencil
        x, k = reference.cg(b, n, dim, maxits, rtol, dtype=torch.float32)
        return x, k, k < maxits or not rtol
    return f


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_sound_run_is_correct(kind):
    line = run_line(CELLS[kind]())
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", [_unchanged, _altered, _early, _control])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_fault_is_not_correct(monkeypatch, kind, fault):
    monkeypatch.setattr(program, "solve", fault(program.solve))
    line = run_line(CELLS[kind]())
    assert line["correct"] is False
    assert line["failed"] > 0 or any(c["value"] > c["limit"]
                                     for c in line["checks"].values())


# -- two ranks on the CPU (gloo): the exchange between them left out ------

def _no_halo():
    from acg_tpu_torch.parallel import sharded_dia

    def window(self, *vecs):
        return [torch.cat([v.new_zeros(self.L), v, v.new_zeros(self.R)])
                for v in vecs]
    sharded_dia.RankShardedDiaCGSolver._window = window


def _no_fold():
    from acg_tpu_torch.parallel import sharded_dia
    sharded_dia.make_rank_psum = lambda counts: (lambda v: v.sum(0))


def _rank(cell, rank, port, fault, queue):
    if fault is not None:
        globals()[fault]()
    out = harness.run(cell, SEED, 0.3, False, rank=rank, port=port,
                      device="cpu")
    if out is not None:
        queue.put(harness.result_line(out, False))


def _two_ranks(fault):
    mix = json.loads((spec.HERE / "workloads" / "cg-f64-np4-100it.json")
                     .read_text())
    c = small("p3d512-cg-f64-100it")
    cell = dataclasses.replace(c, chips=2, checks=json.loads(
        (spec.HERE / "checks" / "p3d512-cg-f64-np4-100it.json").read_text()),
        traffic=dict(spec.check_traffic(mix), iterations=20, ranks=2))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(cell, r, port, fault, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    line = queue.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    return line


@pytest.mark.parametrize("fault, correct", [(None, True),
                                            ("_no_halo", False),
                                            ("_no_fold", False)])
def test_two_ranks(fault, correct):
    line = _two_ranks(fault)
    assert line["correct"] is correct
    assert line["device"]["count"] == 2
