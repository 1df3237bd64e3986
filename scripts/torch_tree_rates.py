#!/usr/bin/env python3
"""Solve rates of two checkouts of the port on one CUDA card, in turns.

    python3 scripts/torch_tree_rates.py OLD_TREE [NEW_TREE]

OLD_TREE and NEW_TREE (default: this checkout) are unpacked checkouts
(``git archive``).  Each turn is a fresh process whose ``acg_tpu_torch``
comes from one tree (its kernels built there), in the order old, new,
new, old.  A turn times, on the flagship 2D Poisson n = 2048, the
unpreconditioned rates that touch the solver loops both trees share:
classic f64 on one part, ``--kernels fused`` f32, and classic f64 on 4
stacked band parts under ``--comm dma`` and ``--comm xla``, each with
``chip_smoke.rate_runs``' protocol (1000 iterations after a 50-iteration
warm-up, three solves).  Prints one line a measurement and, last, one
JSON object of them all.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure() -> dict:
    """The rates of the checkout on ``sys.path[0]``, one card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from acg_tpu_torch.cli import synthesize_host_matrix
    from acg_tpu_torch.parallel.dist import DistCGSolver

    dev = torch.device("cuda", 0)
    out = {}
    for name in ("classic f64", "fused f32"):
        out[name] = cs.rate_runs(cs.rate_solver(torch, dev, name),
                                 cs.FLAGSHIP ** 2)
    prob = cs.flagship_parts(synthesize_host_matrix(cs.MAIN_SPEC).to_csr())
    for comm in ("dma", "xla"):
        out[f"4 parts --comm {comm}"] = cs.rate_runs(
            DistCGSolver(prob, comm=comm, device=dev), prob.n)
    return {k: [float(v) for v in r] + [float(np.median(r))]
            for k, r in out.items()}


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure()))
        return 0
    if len(sys.argv) not in (2, 3):
        sys.stderr.write(__doc__)
        return 2
    old = Path(sys.argv[1]).resolve()
    new = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else ROOT
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    turns = []
    for label, tree in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure"],
            cwd=tree, env=env, capture_output=True, text=True, check=True)
        rates = json.loads(res.stdout.strip().splitlines()[-1])
        for name, r in rates.items():
            print(f"{label} {name}: "
                  f"{', '.join(f'{v:.1f}' for v in r[:-1])} iters/s "
                  f"(median {r[-1]:.1f}); {card}", flush=True)
        turns.append({"tree": label, "rates": rates})
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
