"""Readings for the limits of ``checks/<cell>.json``.

    python3 -m cgbench.control --workload NAME --seeds 1,2,3 [--program]

For each seed, on the card, at the cell's own size: the control -- the
plain reference put in the program's place, computed in float32, the
precision below the configuration's float64, under the mix's own
stopping rule -- and, with ``--program``, the program's own answers to
the same right-hand sides (one process a seed list; a cell on several
ranks reads its program numbers from its benchmark runs instead).  Each
answer is judged by :func:`cgbench.checks.numbers`, as a run judges the
program's; one JSON line a seed and side.  The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cgbench import checks, program, reference, spec


def sampled_rhs(seed: int, traffic: dict) -> list[int]:
    """The pool entries a run's samples can land on: two of them,
    drawn from the seed."""
    pool = int(traffic["rhs_pool"])
    rng = np.random.default_rng(seed)
    k = min(checks.SAMPLES, pool)
    return sorted(int(j) for j in rng.choice(pool, size=k, replace=False))


def readings(cell: spec.Cell, seeds: list[int], with_program: bool,
             device: str = "cuda"):
    """Yield one dict a seed and side: ``{"seed", "side", "numbers"}``."""
    cfg, tr = cell.config, cell.traffic
    n, dim = int(cfg["n"]), int(cfg["dim"])
    dev = torch.device(device)
    solver = None
    if with_program:
        if int(tr["ranks"]) > 1:
            raise ValueError("the program's readings on several ranks come "
                             "from the cell's benchmark runs")
        solver = program.build(cfg, 1, dev)
    for seed in seeds:
        rhs = reference.manufactured_rhs(int(tr.get("rhs_seed", seed)),
                                         int(tr["rhs_pool"]), n, dim, dev)
        which = sampled_rhs(seed, tr)
        t = time.perf_counter()
        ctrl = checks.control_answers(rhs, tr, n, dim, which)
        yield {"seed": seed, "side": "control",
               "iterations": [a.iterations for a in ctrl],
               "numbers": checks.numbers(ctrl, rhs, tr, n, dim),
               "seconds": time.perf_counter() - t}
        del ctrl
        if solver is not None:
            t = time.perf_counter()
            answers = []
            for j in which:
                x, k, _ = program.solve(solver, rhs[j], int(tr["iterations"]),
                                        float(tr["rtol"]))
                answers.append(checks.Answer(x=x, rhs=j, iterations=k))
            yield {"seed": seed, "side": "program",
                   "iterations": [a.iterations for a in answers],
                   "numbers": checks.numbers(answers, rhs, tr, n, dim),
                   "seconds": time.perf_counter() - t}
        del rhs


def main() -> int:
    p = argparse.ArgumentParser(prog="python3 -m cgbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--program", action="store_true",
                   help="also the program's answers (one-rank cells)")
    a = p.parse_args()
    cell = spec.load_cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    for rec in readings(cell, seeds, a.program):
        print(json.dumps(dict(rec, workload=cell.name)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
