"""The multi-process runtime: one process (rank) per card.

The counterpart of ``acg_tpu/parallel/multihost.py``.  The reference
boots one MPI rank per GPU (``cuda/acg-cuda.c:1036``); the JAX package
starts one controller per host with ``jax.distributed.initialize``.  The
port starts one process per card with ``torch.distributed``:

* :func:`initialize` -- idempotent: a ``torch.distributed.TCPStore`` on
  the coordinator's ``host:port`` (process 0 serves it), then
  ``init_process_group`` over that store.  The backend is NCCL where
  every rank of a host has a card of its own, and gloo on the CPU or
  where ranks share a card (NCCL refuses two ranks on one GPU); the
  choice and its reason are on :func:`describe`'s line.  The rank's
  device is ``cuda:(local_rank % device_count)``.
* :func:`is_primary` -- the rank that prints statistics and writes the
  solution (the reference's ``mtxfile_fwrite_mpi_double`` root).
* :func:`all_gather` / :func:`gather_parts` -- tensors from every rank,
  in rank order.  Gloo moves CPU tensors only, so a CUDA tensor under
  gloo is staged through a pinned host copy (one device sync each);
  NCCL moves it on the card.
* :func:`put_global` / :func:`get_global` -- a host array stacked over
  parts to this rank's parts on its device, and a rank's stacked parts
  gathered back to every rank (``multihost_utils.process_allgather``'s
  role).

The store also carries the error agreement and the heartbeat of
:mod:`acg_tpu_torch.parallel.erragree`.  Single-process (never
initialised) every function answers for one rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class World:
    """This process's place in the multi-process run."""

    rank: int
    size: int
    local_rank: int       # index among the ranks on this host
    local_size: int       # ranks on this host
    same_host: bool       # every rank on one host (peer memory mappable)
    backend: str          # "nccl" | "gloo"
    why: str              # the reason for the backend
    device: torch.device
    store: object         # the torch.distributed.TCPStore


_world: World | None = None
_pinned: dict = {}


def _parse_coordinator(coordinator: str) -> tuple[str, int]:
    addr = str(coordinator)
    if addr.startswith("tcp://"):
        addr = addr[len("tcp://"):]
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r}: expected HOST:PORT")
    return host or "127.0.0.1", int(port)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda",
               timeout: float = 300.0) -> World:
    """Join the multi-process run (the ``MPI_Init`` analog).  Idempotent:
    a second call returns the running world.  ``device`` is "cuda" (the
    rank's card) or "cpu" (the CPU, only because it was asked for).

    Every rank publishes its host name in the store, so each learns its
    local rank and whether all ranks share one host before it picks the
    backend."""
    global _world
    if _world is not None:
        return _world
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("multi-process runs need --coordinator HOST:PORT, "
                         "--num-processes N and --process-id I (nothing "
                         "here detects a cluster's layout)")
    nproc, rank = int(num_processes), int(process_id)
    if nproc < 1 or not 0 <= rank < nproc:
        raise ValueError(f"process id {rank} outside [0, {nproc})")
    host, port = _parse_coordinator(coordinator)
    on_cpu = str(device) == "cpu"
    if not on_cpu:
        from acg_tpu_torch._device import resolve_device
        resolve_device("cuda")   # raises when no card is visible
    td = datetime.timedelta(seconds=float(timeout))
    store = dist.TCPStore(host, port, world_size=nproc,
                          is_master=(rank == 0), timeout=td,
                          wait_for_workers=False)
    me = socket.gethostname()
    store.set(f"acg_tpu/host/{rank}", me)
    hosts = [store.get(f"acg_tpu/host/{q}").decode() for q in range(nproc)]
    local = [q for q in range(nproc) if hosts[q] == me]
    local_rank, local_size = local.index(rank), len(local)
    if on_cpu:
        dev = torch.device("cpu")
        backend, why = "gloo", "CPU tensors (--device cpu)"
    else:
        ncards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % ncards)
        torch.cuda.set_device(dev)
        if local_size <= ncards and dist.is_nccl_available():
            backend, why = "nccl", "one card per rank"
        else:
            backend = "gloo"
            why = (f"{local_size} ranks share {ncards} card(s) on this "
                   f"host and NCCL refuses two ranks on one GPU: host-side "
                   f"collectives over gloo through pinned host copies, "
                   f"K6's peer puts over CUDA IPC")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=nproc, timeout=td)
    _world = World(rank=rank, size=nproc, local_rank=local_rank,
                   local_size=local_size, same_host=len(set(hosts)) == 1,
                   backend=backend, why=why, device=dev, store=store)
    return _world


def world() -> World | None:
    """The running world, or None in a single-process run."""
    return _world


def process_count() -> int:
    return 1 if _world is None else _world.size


def process_index() -> int:
    return 0 if _world is None else _world.rank


def is_primary() -> bool:
    """True on the process that writes user-facing output."""
    return process_index() == 0


def describe() -> str:
    """The ``multihost:`` log line: rank, backend and why, device."""
    w = _world
    if w is None:
        return "multihost: single process"
    return (f"multihost: process {w.rank} of {w.size} (local {w.local_rank} "
            f"of {w.local_size}), backend {w.backend} ({w.why}), device "
            f"{w.device}")


def shutdown(timeout: float = 120.0) -> None:
    """Leave the run: destroy the process group after a barrier, so the
    store's server, on process 0, outlives every peer's last use.  A
    barrier that fails (a peer died) does not stop the teardown."""
    global _world
    if _world is None:
        return
    from acg_tpu_torch.parallel.erragree import barrier
    try:
        barrier("shutdown", timeout=timeout)
    except Exception:  # noqa: BLE001 -- a dead peer: leave regardless
        pass
    finally:
        dist.destroy_process_group()
        _world = None


def host_collectives() -> bool:
    """The collectives run on the host (gloo): they leave no device
    event in a profiler capture."""
    return _world is not None and _world.backend == "gloo"


def _staged(t: torch.Tensor) -> bool:
    return _world.backend == "gloo" and t.device.type == "cuda"


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A cached pinned host buffer of ``t``'s shape and dtype."""
    key = (tuple(t.shape), t.dtype)
    buf = _pinned.get(key)
    if buf is None:
        buf = _pinned[key] = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
    return buf


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host for a gloo collective: a pinned staging copy of
    a CUDA tensor (waits for the device), ``t`` itself otherwise."""
    if not _staged(t):
        return t
    buf = _pinned_like(t)
    buf.copy_(t)
    return buf


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """``t`` from every rank (equal shapes), in rank order, on ``t``'s
    device.  The payload moves as raw bytes, so every dtype (bf16
    included) crosses bit for bit."""
    if _world is None:
        return [t]
    src = to_host(t.contiguous())
    flat = src.reshape(-1).view(torch.uint8)
    outs = [torch.empty_like(flat) for _ in range(_world.size)]
    dist.all_gather(outs, flat)
    res = [o.view(t.dtype).reshape(t.shape) for o in outs]
    if _staged(t):
        res = [r.to(t.device) for r in res]
    return res


def gather_parts(t: torch.Tensor, counts) -> torch.Tensor:
    """The (nparts, ...) stack of every rank's (counts[rank], ...) rows,
    in rank order: the ranks' parts are contiguous and process-major
    (:mod:`acg_tpu_torch.parallel.mesh`), so rank order is part order.
    Rows are padded to the largest count for the gather."""
    if _world is None:
        return t
    counts = [int(c) for c in counts]
    cmax = max(counts)
    if t.shape[0] != cmax:
        pad = torch.zeros((cmax - t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        t = torch.cat([t, pad])
    rows = all_gather(t)
    return torch.cat([r[:c] for r, c in zip(rows, counts)])


def put_global(arr, nparts: int, device, dtype=None) -> torch.Tensor:
    """This rank's rows of the (nparts, ...) host array ``arr``, on
    ``device`` (``jax.make_array_from_callback``'s role: every rank holds
    the host array and keeps its own parts)."""
    from acg_tpu_torch.parallel.mesh import part_range
    lo, hi = part_range(nparts, process_index(), process_count())
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)[lo:hi]))
    return out.to(device=device, dtype=dtype or out.dtype)


def get_global(t: torch.Tensor, nparts: int) -> np.ndarray:
    """Every rank's stacked parts gathered to a host (nparts, ...) array
    on every rank (``process_allgather(tiled=True)``'s role)."""
    from acg_tpu_torch.parallel.mesh import part_ranges
    counts = [hi - lo for lo, hi in part_ranges(nparts, process_count())]
    g = gather_parts(t, counts)
    if g.dtype == torch.bfloat16:
        g = g.float()
    return g.cpu().numpy()


def all_to_all_bytes(inp: torch.Tensor, in_splits, out_splits) -> torch.Tensor:
    """``torch.distributed.all_to_all_single`` of a flat uint8 payload:
    ``in_splits[r]`` bytes of ``inp`` go to rank r, ``out_splits[r]``
    bytes come from it, in rank order; the result is on ``inp``'s
    device (staged through the host under gloo)."""
    if _world is None:
        return inp
    src = to_host(inp)
    out = torch.empty(int(sum(out_splits)), dtype=torch.uint8,
                      device=src.device)
    dist.all_to_all_single(out, src, [int(s) for s in out_splits],
                           [int(s) for s in in_splits])
    return out.to(inp.device) if _staged(inp) else out


def allgather_array(arr) -> np.ndarray:
    """A small host array from every rank, stacked in rank order
    ``(nprocs, ...)``, over the process group (on the card under NCCL,
    on the host under gloo)."""
    a = np.ascontiguousarray(arr)
    if _world is None:
        return a[None]
    dev = _world.device if _world.backend == "nccl" else torch.device("cpu")
    outs = all_gather(torch.from_numpy(a).to(dev))
    return np.stack([o.cpu().numpy() for o in outs])
