"""Parts to ranks: the port's counterpart of ``acg_tpu/parallel/mesh.py``.

The JAX package's mesh places part p on mesh device p, and each
controller holds the parts of its devices.  The port stacks every part
a rank owns on the rank's card, so a rank holds a ``(nlocal, ...)``
slice of every stacked array.  Parts are contiguous and process-major:
rank r owns ``[r * per, (r + 1) * per)`` with ``per = nparts //
nprocs`` and the last rank the remainder (the layout of
``acg_tpu/cli.py:1467-1475``), so rank order is part order and a gather
of the ranks' rows is the stacked order.  Fewer parts than processes is
refused with the JAX package's message (``mesh.py:56-61``).
"""

from __future__ import annotations

# the parts axis's name (``acg_tpu/parallel/mesh.py:23``): the comm
# ledgers key their mesh shape by it
PARTS_AXIS = "parts"


def part_ranges(nparts: int, nprocs: int) -> list[tuple[int, int]]:
    """``[(lo, hi), ...]``: the parts of each rank, in rank order."""
    nparts, nprocs = int(nparts), int(nprocs)
    if nparts < nprocs:
        raise ValueError(
            f"{nparts} parts cannot span all {nprocs} controller "
            f"processes; launch at most {nparts} controllers (the MPI "
            f"analog: fewer ranks than hosts)")
    per = nparts // nprocs
    return [(r * per, nparts if r == nprocs - 1 else (r + 1) * per)
            for r in range(nprocs)]


def part_range(nparts: int, rank: int, nprocs: int) -> tuple[int, int]:
    """``(lo, hi)``: the parts rank ``rank`` owns."""
    return part_ranges(nparts, nprocs)[int(rank)]


def owned_parts(nparts: int, rank: int, nprocs: int) -> tuple:
    """The part ids rank ``rank`` owns, ascending."""
    lo, hi = part_range(nparts, rank, nprocs)
    return tuple(range(lo, hi))
