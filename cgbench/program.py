"""The system under test: the port's sharded Poisson solver.

The only module of the benchmark that imports the program.  Every cell
builds its solver with
``acg_tpu_torch.parallel.sharded_dia.build_sharded_poisson_solver``
(K1 on the device-built DIA planes, the assembled operator; on several
ranks ``RankShardedDiaCGSolver`` over NCCL, one card a rank) and times
``ChunkedCGSolver.solve`` on device vectors.
"""

from __future__ import annotations

import torch


def join(port: int, ranks: int, rank: int, device: str):
    """Join the multi-process run; returns this rank's device."""
    from acg_tpu_torch.parallel import multihost
    world = multihost.initialize(coordinator=f"127.0.0.1:{port}",
                                 num_processes=ranks, process_id=rank,
                                 device=device, timeout=300.0)
    return world.device


def leave() -> None:
    from acg_tpu_torch.parallel import multihost
    multihost.shutdown()


def build(config: dict, nparts: int, device):
    """The solver of ``config``'s operator on ``nparts`` parts."""
    from acg_tpu_torch.parallel.sharded_dia import \
        build_sharded_poisson_solver
    if config["dtype"] != "float64":
        raise ValueError(f"unsupported dtype {config['dtype']!r}")
    return build_sharded_poisson_solver(int(config["n"]), int(config["dim"]),
                                        nparts, dtype=torch.float64,
                                        kernels="auto", device=device)


def rows(solver) -> tuple[int, int]:
    """``(first row, row count)`` this rank owns."""
    return int(solver.row0), int(solver.nloc)


def solve(solver, b: torch.Tensor, maxits: int, rtol: float):
    """One solve from x0 = 0: ``(x on the device, iterations,
    converged)``."""
    from acg_tpu_torch.solvers.stats import StoppingCriteria
    crit = StoppingCriteria(maxits=int(maxits), residual_rtol=float(rtol))
    x = solver.solve(b, x0=None, criteria=crit, host_result=False,
                     raise_on_divergence=False)
    st = solver.stats
    return x, int(st.niterations), bool(st.converged)
