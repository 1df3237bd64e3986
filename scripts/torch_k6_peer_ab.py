#!/usr/bin/env python3
"""A/B of K6's cross-process form (``acg_tpu_torch/csrc/halo_put.cu``,
``halo_put_peer``) on one CUDA card shared by two processes: an older
tree's design, whose put kernel stores each pair's flag and whose wait
is a kernel of its own spinning on the flags and acks, beside this
checkout's, whose put only copies between stream memory operations.

    python3 scripts/torch_k6_peer_ab.py OLD_TREE

OLD_TREE is an unpacked checkout of the earlier commit (``git
archive``); its ``halo_put.cu`` is built alone into a library of its own
under the gitignored ``acg_tpu_torch/_build/``.  Both designs run on the
memory of this checkout's ``PeerPlanes`` (the layout is the same), in
the turns old, new, new, old, on two plans in f64: the flagship's band
plan (4 parts, 6 gated pairs of 2,048) and an all-pairs plane of path
(h)'s width (4 parts, 63,927).  Each turn times, on rank 0 by CUDA
events (medians of 40 after 5):

* ``ms``: a lockstep exchange, both ranks exchanging in a loop;
* ``put_ms`` / ``wait_ms``: its put launch and its wait apart (the new
  design: from after the acks to after the put, and from after the
  flags to after their waits; ``ack_ms`` is the acks before the put);
* ``presignalled_ms``: one exchange of rank 0 after rank 1 has put
  (and released its acks) and finished, with its context idle;
* ``memop_us``: one stream memory operation on rank 0 alone, lone and
  batched, writes and waits already satisfied;
* ``floor_ms``: a one-flag ping-pong, each rank writing a word into
  the other's memory and waiting for the other's, by stream memory
  operations: the least a lockstep exchange on this card can take;

and, once a plan, one staged ``all_to_all_single`` of the send plane
(the library call).  Before timing, each design's first two exchanges
are held bitwise against the stacked ``halo_put``.  Prints the card,
one line a measurement and, last, one JSON object of them all.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NREP, NWARM = 40, 5
PLANS = {"band": (4, 2048, "band"), "wide": (4, 63927, "all")}


def _old_lib(old_tree: Path):
    """OLD_TREE's halo_put.cu built alone; returns the loaded library."""
    from acg_tpu_torch.ops import _build

    src = old_tree / "acg_tpu_torch" / "csrc" / "halo_put.cu"
    out = _build.BUILD_ROOT / "k6ab-old" / "libk6old.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(out), str(src)], check=True,
                       stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(str(out))
    P, I, L, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_uint)
    lib.acg_halo_put_peer.argtypes = (I, P, P, I, I, I, L, I, P, I, U, P, P)
    lib.acg_halo_wait_peer.argtypes = (P, I, I, I, I, P, P, P, U, L, P, P)
    lib.acg_ipc_host_word.argtypes = (ctypes.POINTER(P), ctypes.POINTER(P))
    return lib


def _counts(P, m, kind):
    c = np.zeros((P, P), np.int32)
    for q in range(P):
        for p in range(P):
            if p != q and (kind == "all" or abs(p - q) == 1):
                c[q, p] = m
    return c


class _Old:
    """The earlier design driven on a PeerPlanes' memory: its per-pair
    block counters, its table of plane, flag and ack rows, its error
    word."""

    def __init__(self, torch, lib, peer):
        self.lib, self.peer = lib, peer
        P = peer.nparts
        tab = np.zeros(4 * P, dtype=np.int64)
        tab[:2 * P] = peer.tab.cpu().numpy()
        for p in range(P):
            tab[2 * P + p] = peer._addr(("flag", p, 0))
            tab[3 * P + p] = peer._addr(("ack", p, 0))
        self.tab = torch.from_numpy(tab).to(peer.device)
        self.done = torch.zeros(peer.nlocal * P, dtype=torch.int64,
                                device=peer.device)
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        assert lib.acg_ipc_host_word(ctypes.byref(host),
                                     ctypes.byref(dev)) == 0
        self.err = dev.value

    def put(self, torch, send, seq):
        pe, (lo, hi) = self.peer, self.peer.ranges[self.peer.rank]
        assert self.lib.acg_halo_put_peer(
            send.element_size(), send.data_ptr(), pe.counts.data_ptr(),
            pe.nparts, lo, hi - lo, pe.maxcnt, int(pe.gate),
            self.tab.data_ptr(), seq % 2, seq, self.done.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0

    def wait(self, torch, seq):
        pe, (lo, hi) = self.peer, self.peer.ranges[self.peer.rank]
        assert self.lib.acg_halo_wait_peer(
            pe.counts.data_ptr(), pe.nparts, lo, hi - lo, int(pe.gate),
            self.tab.data_ptr(), pe.flags_ptr, pe.acks_ptr, seq,
            int(60e9), self.err, torch.cuda.current_stream().cuda_stream) == 0


def _memop_costs(torch, peer, n=100):
    """Device µs a stream memory operation on this rank's own diagonal
    flag word (unused by exchanges), with nothing to wait for, the best
    of 5 runs of n: writes and satisfied waits as lone libcuda calls
    (``cuStreamWriteValue32`` / ``cuStreamWaitValue32`` from libcuda),
    as batches of one and as one batch of n (the port's ``acg_memops``,
    ``cuStreamBatchMemOp``)."""
    lo = peer.ranges[peer.rank][0]
    word = ("flag", lo, lo)
    addr = peer._addr(word)
    cu = ctypes.CDLL("libcuda.so.1")
    lone = {}
    for op in ("Write", "Wait"):
        fn = getattr(cu, f"cuStream{op}Value32_v2")
        fn.argtypes = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                       ctypes.c_uint)
        lone[op.lower()] = fn
    stream = torch.cuda.current_stream().cuda_stream

    def lone_call(op):
        assert lone[op](stream, addr, 0, 0) == 0

    def batch(kind, k):
        arrays = peer.arrays([(kind, word, 0)] * k, 0)
        return lambda: peer.enqueue(arrays, 0)

    cases = {"write_lone": (lambda: lone_call("write"), n),
             "wait_lone": (lambda: lone_call("wait"), n),
             "write_batch_of_1": (batch("write", 1), n),
             "wait_batch_of_1": (batch("wait", 1), n),
             "write_batched": (batch("write", n), 1),
             "wait_batched": (batch("wait", n), 1)}
    out = {}
    for name, (call, reps) in cases.items():
        best = None
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            for _ in range(reps):
                call()
            b.record()
            b.synchronize()
            t = a.elapsed_time(b) * 1e3 / n
            best = t if best is None else min(best, t)
        out[name] = best
    return out


def _med(ms):
    return float(np.median(ms[NWARM:]))


def child(rank: int, port: int, old_tree: Path) -> int:
    import torch
    import torch.distributed as dist

    from acg_tpu_torch.ops import kernels as K
    from acg_tpu_torch.parallel import mesh, multihost
    from acg_tpu_torch.parallel.halo_dma import PeerPlanes

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda")
    dev = multihost.world().device
    if rank == 0:
        _old_lib(old_tree)
    dist.barrier()
    old_lib = _old_lib(old_tree)
    Ev = torch.cuda.Event
    out = {}
    g = torch.Generator().manual_seed(0)
    for plan, (P, m, kind) in PLANS.items():
        cnt_np = _counts(P, m, kind)
        cnt = torch.from_numpy(cnt_np).to(dev)
        full = torch.randn((P, P, m), generator=g,
                           dtype=torch.float64).to(dev)
        ranges = mesh.part_ranges(P, 2)
        lo, hi = ranges[rank]
        send = full[lo:hi].contiguous()
        stacked = K.halo_put(full, cnt, torch.zeros_like(full))[lo:hi]
        res = {}
        for turn, design in enumerate(("old", "new", "new", "old")):
            peer = PeerPlanes(P, ranges, rank, m, torch.float64, cnt_np, dev)
            old = _Old(torch, old_lib, peer) if design == "old" else None
            seq = 0

            def exchange(marks=None, wait=True):
                nonlocal seq
                seq += 1
                if old is None:
                    return K.halo_put_peer(send, cnt, None, ranges, rank,
                                           peer=peer, wait=wait, marks=marks)
                old.put(torch, send, seq)
                if marks is not None:
                    marks.append(Ev(enable_timing=True))
                    marks[-1].record()
                if wait:
                    old.wait(torch, seq)
                    if marks is not None:
                        marks.append(Ev(enable_timing=True))
                        marks[-1].record()
                return peer.plane(seq % 2)

            ok = all(torch.equal(exchange().clone(), stacked)
                     for _ in range(2))
            torch.cuda.synchronize()
            # lockstep, with the stages apart
            tot, put, wait, ack = [], [], [], []
            for _ in range(NREP + NWARM):
                a = Ev(enable_timing=True)
                a.record()
                marks = [a]
                exchange(marks)
                marks[-1].synchronize()
                tot.append(a.elapsed_time(marks[-1]))
                if old is None:   # a | acks | put | flags | waits
                    ack.append(a.elapsed_time(marks[1]))
                    put.append(marks[1].elapsed_time(marks[2]))
                    wait.append(marks[3].elapsed_time(marks[4]))
                else:             # a | put | wait
                    put.append(a.elapsed_time(marks[1]))
                    wait.append(marks[1].elapsed_time(marks[2]))
            # pre-signalled: rank 1 puts (and releases its acks) first
            pres = []
            for _ in range(NREP + NWARM):
                if rank == 1:
                    if old is None:
                        exchange(wait=False)
                    else:
                        peer.enqueue(peer.ops(seq + 1)[0], seq + 1)
                        exchange(wait=False)
                    torch.cuda.synchronize()
                dist.barrier()
                if rank == 0:
                    marks = [Ev(enable_timing=True)]
                    marks[0].record()
                    exchange(marks)
                    marks[-1].synchronize()
                    pres.append([marks[0].elapsed_time(m)
                                 for m in marks[1:]])
                else:
                    if old is None:
                        peer.wait()
                    else:
                        old.wait(torch, seq)
                    torch.cuda.synchronize()
                dist.barrier()
            ok = ok and torch.equal(peer.plane(seq % 2), stacked)
            torch.cuda.synchronize()
            peer.check()
            peer.close()
            rec = {"ok": bool(ok), "ms": _med(tot), "put_ms": _med(put),
                   "wait_ms": _med(wait),
                   "presignalled_ms": float(np.median(
                       [t[-1] for t in pres[NWARM:]])) if pres else None,
                   # the end of each stage from the exchange's start
                   "presignalled_marks_ms": np.median(
                       pres[NWARM:], axis=0).tolist() if pres else None,
                   "can_flush": peer.can_flush}
            if ack:
                rec["ack_ms"] = _med(ack)
            res[f"{design}{turn}"] = rec
        # the one-flag ping-pong floor, by stream memory operations
        peer = PeerPlanes(P, ranges, rank, m, torch.float64, cnt_np, dev)
        costs = _memop_costs(torch, peer) if rank == 0 else None
        dist.barrier()   # both probes done: the diagonal words are free
        other = ranges[1 - rank][0]
        mine = peer.arrays([("write", ("flag", other, other), 0)], 0)
        theirs = peer.arrays([("wait", ("flag", lo, lo), 0)], 0)
        floor = []
        for k in range(1, NREP + NWARM + 1):
            a, b = Ev(enable_timing=True), Ev(enable_timing=True)
            a.record()
            peer.enqueue(mine, k)
            peer.enqueue(theirs, k)
            b.record()
            b.synchronize()
            floor.append(a.elapsed_time(b))
        torch.cuda.synchronize()
        peer.close()
        # the library call: one staged all_to_all_single of the plane
        flat = send.reshape(-1).view(torch.uint8)
        splits = [(b_ - a_) * (hi - lo) * m * 8 for a_, b_ in ranges]
        lib_ms = []
        for _ in range(13):
            t0 = time.perf_counter()
            multihost.all_to_all_bytes(flat, splits, splits)
            torch.cuda.synchronize()
            lib_ms.append((time.perf_counter() - t0) * 1e3)
        out[plan] = {"turns": res, "floor_ms": _med(floor),
                     "memop_us": costs,
                     "library_ms": float(np.median(lib_ms[3:])),
                     "gated": int(((cnt_np > 0)
                                   & ~np.eye(P, dtype=bool)).sum()),
                     "maxcnt": m}
    dist.barrier()
    if rank == 0:
        print(json.dumps({"k6_peer_ab": out}))
    multihost.shutdown()
    return 0


def main() -> int:
    import socket

    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        return child(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    if len(sys.argv) != 2:
        sys.stderr.write(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("torch_k6_peer_ab: no CUDA device\n")
        return 1
    from acg_tpu_torch.ops import _build
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--child", str(r),
                               str(port), sys.argv[1]], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(f"rank {r} exit {p.returncode}:\n{e[-3000:]}\n")
            return 1
    got = json.loads(outs[0][0].strip().splitlines()[-1])["k6_peer_ab"]
    for plan, v in got.items():
        for turn, t in v["turns"].items():
            print(f"{plan} {turn}: bitwise={t['ok']} lockstep "
                  f"{t['ms']:.4f} ms, put {t['put_ms']:.4f}, wait "
                  f"{t['wait_ms']:.4f}, ack {t.get('ack_ms', 0):.4f}, "
                  f"pre-signalled {t['presignalled_ms']:.4f} ms (stage "
                  f"ends {t['presignalled_marks_ms']}), remote-write "
                  f"flush {t['can_flush']}")
        print(f"{plan}: one stream memory operation (µs, rank 0 alone): "
              f"{v['memop_us']}")
        print(f"{plan}: ping-pong floor {v['floor_ms']:.4f} ms, staged "
              f"all_to_all_single {v['library_ms']:.4f} ms; {v['gated']} "
              f"gated pairs of {v['maxcnt']} f64; {card}")
    print(json.dumps({"card": card, "k6_peer_ab": got}))
    return 0 if all(t["ok"] for v in got.values()
                    for t in v["turns"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
