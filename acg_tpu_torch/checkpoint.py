"""Solver-state checkpoint/restore -- the survivability substrate.

The port's copy of ``acg_tpu/checkpoint.py``.  A snapshot is the
reference's file, byte for byte in everything but the ``env`` stamp
(torch, CUDA and the device here, jax/jaxlib/backend there): the same
MAGIC, header line, CRCs, raw little-endian payload and atomic rename,
so a snapshot written by either package resumes in the other.  The
text below is the reference's; "compiled solve loops" are the port's
eager loops, and the chunk drivers live on
:class:`acg_tpu_torch.solvers.cg.ChunkedCGSolver`.

The reference paper's target regime (long CG runs over large meshes on
big clusters) is exactly where the two failure classes the resilience
tier (solvers/resilience) cannot survive dominate: process/host death
(pod preemption, a controller OOM mid-solve) and silent data corruption
that never trips a non-finite guard.  This module supplies the first
half of the fix -- periodic **solver-state snapshots** to disk -- and
the plumbing the second half (the ABFT checksum SpMV in
:mod:`acg_tpu.health` and the rollback rung in
:mod:`acg_tpu.solvers.resilience`) restores from.

Design:

* The compiled solve loops cannot be interrupted mid-dispatch, so an
  armed checkpoint (``--ckpt FILE --ckpt-every K``) turns the solve
  into a host-driven CHUNK loop: each dispatch runs at most K
  iterations of the UNCHANGED recurrence with the full loop carry
  (x, r, p, pipelined extras, the preconditioned ``rr``) threaded in
  and out of the program (``state_io``/``carry`` -- static/pytree
  arguments the disarmed programs never name, so a build without
  ``--ckpt`` lowers byte-identical code; pinned in
  tests/test_checkpoint.py).  Because the carry continues the Krylov
  recurrence exactly, a chunked solve follows the identical iteration
  trajectory as an uninterrupted one -- no restart penalty per
  snapshot.
* Snapshots are written with ATOMIC RENAME (a crash mid-write leaves
  the previous snapshot intact, never a torn file) and carry a
  CHECKSUMMED header + payload (CRC32): a corrupted file refuses to
  load instead of resuming a solve from garbage.
* ``--resume FILE`` reconstructs the carry and continues to the
  ORIGINAL tolerance: the snapshot stores the absolute residual target
  derived from the first attempt's ``r0`` (the recovery-restart
  convention), so resumed chunks never re-baseline ``rtol`` against an
  already-small residual.  Total iterations (pre-crash + post-resume)
  match an uninterrupted run exactly, well inside the acceptance
  criterion's 10% slack.
* On the distributed tier every per-part carry leaf is gathered
  host-side and the snapshot commits under ONE agreed sequence number
  (:func:`agree_seq` over the erragree plumbing), so all ranks hold
  the same iteration; the primary writes the file.

The snapshot also records the fault-injection residue (so a
deterministic ``crash:exit@K`` does not re-fire after resume -- see
:func:`acg_tpu.faults.maybe_crash`'s crossing semantics) and the
trailing telemetry-ring window (small, JSON) for post-mortem evidence.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib

import numpy as np

from acg_tpu_torch.errors import AcgError, ErrorCode, ExitCode

MAGIC = b"ACGCKPT1\n"
# snapshot container version (bump on layout changes; readers refuse
# versions they do not know rather than misparse).  Version 1 files
# remain readable: the repartition sidecar and env metadata are
# ADDITIVE (absent keys degrade to refusals/no-ops, never misparses)
VERSION = 1
# exit code of a crash:exit fault firing (the process-wide contract
# lives in errors.ExitCode; distinct from peer:dead's 86 and the
# erragree teardown's 97)
CRASH_EXIT_CODE = int(ExitCode.CRASH_INJECTED)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """The armed checkpoint selection a solver carries.

    ``path`` is where snapshots land (None = resume-only: continue a
    crashed solve without writing further snapshots); ``every`` the
    chunk length in iterations; ``secs`` the WALL-CLOCK snapshot
    cadence (mutually exclusive with ``every`` -- slow iterations
    would otherwise stretch the loss window unboundedly; the chunk
    drivers size each chunk from the measured s/iteration so one chunk
    targets ~``secs`` of wall time); ``resume`` a loaded
    :class:`SolverSnapshot` consumed by the first solve;
    ``repartition`` opts into SHAPE-PORTABLE resume: an N-part
    snapshot restores onto this solver's (different) partition via the
    global row-permutation sidecar (:func:`reassemble_global`) --
    cross-tier resume (dist -> single-device/host and back) falls out
    of the same path."""

    path: str | None = None
    every: int = 0
    resume: "SolverSnapshot | None" = None
    secs: float = 0.0
    repartition: bool = False

    def __post_init__(self):
        if self.every > 0 and self.secs > 0:
            raise ValueError("checkpoint cadence is EITHER ckpt_every "
                             "K iterations OR ckpt_secs S wall-clock "
                             "seconds, not both")
        if self.secs < 0:
            raise ValueError("ckpt_secs must be positive seconds")
        if self.path is not None and self.every <= 0 and self.secs <= 0:
            raise ValueError("checkpointing needs a snapshot cadence "
                             "(ckpt_every K or ckpt_secs S)")
        if self.path is None and self.resume is None:
            raise ValueError("a CheckpointConfig needs a snapshot path "
                             "and/or a snapshot to resume from")
        if self.repartition and self.resume is None:
            raise ValueError("repartition is a resume policy; it needs "
                             "a snapshot to resume from")

    # chunk length of the first dispatch under a wall-clock cadence,
    # before any s/iteration measurement exists (small, so the probe
    # costs at most one early snapshot)
    PROBE_CHUNK = 16

    def chunk_for(self, s_per_iter: float | None) -> int:
        """The next dispatch's chunk length: the iteration period when
        one is set; under a wall-clock cadence, ``secs`` divided by the
        measured seconds/iteration (a probe chunk until one exists);
        unbounded for resume-only configurations -- one final chunk to
        convergence."""
        if self.every > 0:
            return self.every
        if self.secs > 0:
            if not s_per_iter or s_per_iter <= 0:
                return self.PROBE_CHUNK
            return max(1, min(int(self.secs / s_per_iter) or 1, 1 << 24))
        return 1 << 30


@dataclasses.dataclass
class SolverSnapshot:
    """One loaded snapshot: validated metadata + named host arrays."""

    meta: dict
    arrays: dict

    @property
    def iteration(self) -> int:
        return int(self.meta["iteration"])


# the carry leaves that are psum'd scalars (mesh tiers: replicated,
# not sharded) -- everything else is a per-part vector
SCALAR_LEAVES = frozenset({"gamma", "alpha", "rr"})


def carry_names(pipelined: bool, precond: bool) -> tuple:
    """The canonical order of the loop-carry leaves a snapshot stores
    (x first, then the recurrence vectors, then the scalars) -- ONE
    layout shared by the snapshot writer, the resume reconstruction,
    and every tier's ``state_io`` program outputs, so the single- and
    multi-part tiers' snapshots stay field-compatible."""
    if not pipelined:
        names = ("x", "r", "p", "gamma")
        return names + (("rr",) if precond else ())
    if precond:
        return ("x", "r", "u", "w", "p", "s", "q", "z",
                "gamma", "alpha", "rr")
    return ("x", "r", "w", "p", "t", "z", "gamma", "alpha")


def ca_carry_names(kind: str) -> tuple:
    """Loop-carry leaves of the COMMUNICATION-AVOIDING recurrences
    (ROADMAP item 4c).  ``sstep``: at a block boundary the s-step
    state is exactly classic-shaped -- the basis and Gram products
    are rebuilt from ``(r, p)`` at every block start, so nothing else
    survives the boundary and the snapshot layout matches classic CG's
    (block-boundary-aligned cadence is the solver's job).  ``pl``: the
    deep pipeline has no classic-shaped boundary, so the snapshot
    carries its WHOLE working set -- the z-window ``Z``/``V``, the
    Gram column ``zzq``, the pending products ``gb``, the scalar
    histories ``gammas``/``deltas``, and the ABSOLUTE pipeline
    counters ``j``/``adv``."""
    if kind == "sstep":
        return ("x", "r", "p", "gamma")
    return ("x", "q", "dprev", "ptilde", "Z", "V", "zzq", "gb",
            "gammas", "deltas", "j", "adv")


# the batched tier's per-RHS carry leaves that are (B,)-shaped column
# vectors rather than per-row vectors: replicated on the mesh tiers
# (like the psum'd scalars), passed through untouched by repartition
BATCHED_COL_LEAVES = frozenset({"gamma", "rr", "done", "iters"})


def batched_carry_names(precond: bool) -> tuple:
    """Loop-carry leaves of the BATCHED classic recurrence
    (acg_tpu.solvers.batched): x/r/p are (n, B) column blocks --
    per-RHS leaves, one column per right-hand side -- and
    gamma[/rr]/done/iters are (B,) per-RHS vectors.  A snapshot of
    this layout is what lets a whole BATCH survive preemption with
    every RHS's progress (including already-frozen columns) intact."""
    names = ("x", "r", "p", "gamma")
    if precond:
        names = names + ("rr",)
    return names + ("done", "iters")


# tiers whose carry leaves are field-compatible global row vectors
# once reassembled (carry_names is shared): the repartition-resume set.
# sharded-dia pads rows to the mesh and is excluded -- its vectors are
# not plain global row order.  The batched tiers repartition among
# themselves (their leaves carry a trailing per-RHS axis).
REPARTITION_TIERS = frozenset({"jax-cg", "dist-cg", "host-cg"})
BATCHED_REPARTITION_TIERS = frozenset({"jax-cg-batched",
                                       "dist-cg-batched"})


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# the keys of env_meta() a resume compares
ENV_KEYS = ("torch", "cuda", "device")


def env_meta() -> dict:
    """The runtime environment a snapshot was written under (torch and
    CUDA versions and the device name): a resume across a version or
    device change is numerically legal but can perturb the trajectory,
    so :func:`check_resume_env` warns instead of silently continuing.
    The reference stamps its jax/jaxlib/backend here; the rest of the
    file is byte-compatible."""
    import torch

    meta = {"torch": str(torch.__version__),
            "cuda": torch.version.cuda}
    try:
        meta["device"] = (torch.cuda.get_device_name(
            torch.cuda.current_device()) if torch.cuda.is_available()
            else "cpu")
    except RuntimeError:  # a driver that cannot be queried: still
        meta["device"] = None  # record the versions
    return meta


def check_resume_env(snap: SolverSnapshot, stats=None) -> list:
    """Compare the snapshot's recorded environment against this
    process's; mismatches WARN (stderr + a structured
    ``resume-env-mismatch`` event on ``stats``) instead of refusing --
    the resume is legal, but a changed torch/CUDA/device can shift
    rounding enough to move the iteration count.  Keys only one side
    records (a reference snapshot's jax stamp) are not compared.
    Returns the mismatch descriptions ([] when clean or when the
    snapshot predates env recording)."""
    import sys

    recorded = snap.meta.get("env") or {}
    if not recorded:
        return []
    here = env_meta()
    mismatches = [
        f"{key} {recorded.get(key)!r} -> {here.get(key)!r}"
        for key in ENV_KEYS
        if key in recorded and key in here
        and recorded.get(key) != here.get(key)]
    if mismatches:
        detail = ", ".join(mismatches)
        sys.stderr.write(
            f"acg-tpu-torch: warning: resuming across an environment "
            f"change ({detail}); the trajectory may deviate from the "
            f"pre-crash run's\n")
        if stats is not None:
            from acg_tpu_torch.telemetry import record_event
            record_event(stats, "resume-env-mismatch", detail)
    return mismatches


def vector_checksum(v) -> int:
    """CRC32 of a host vector's bytes -- stored for ``b`` so a resume
    against a different right-hand side refuses instead of silently
    continuing somebody else's solve."""
    return _crc(np.ascontiguousarray(np.asarray(v)).tobytes())


def save_snapshot(path, meta: dict, arrays: dict) -> int:
    """Write one snapshot atomically; returns the byte size.

    Layout: ``MAGIC`` + one header line
    ``{version, header_crc, payload_crc, header_len}`` + the JSON
    header (meta + per-array manifest) + the raw little-endian array
    payload.  The file lands under a temporary name and is
    ``os.replace``d into place, so a crash mid-write can never leave a
    torn snapshot where a good one stood.

    The writer stamps the runtime environment (:func:`env_meta`) into
    the metadata so ``--resume`` across a jax/jaxlib/backend change
    can warn (:func:`check_resume_env`)."""
    meta = dict(meta)
    meta.setdefault("env", env_meta())
    manifest = []
    blobs = []
    off = 0
    for name, arr in arrays.items():
        a = np.asarray(arr)
        # record the shape BEFORE ascontiguousarray: it promotes 0-d
        # scalars (the carried gamma/alpha/rr) to shape (1,), which
        # would resume a scalar as a 1-vector and break the loop carry
        shape = list(a.shape)
        raw = np.ascontiguousarray(a).tobytes()
        manifest.append({"name": str(name), "dtype": str(a.dtype),
                         "shape": shape, "offset": off,
                         "nbytes": len(raw)})
        blobs.append(raw)
        off += len(raw)
    payload = b"".join(blobs)
    header = json.dumps({"meta": meta, "arrays": manifest},
                        sort_keys=True).encode("utf-8")
    preamble = json.dumps({"version": VERSION,
                           "header_crc": _crc(header),
                           "payload_crc": _crc(payload),
                           "header_len": len(header)}).encode("utf-8")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(preamble + b"\n")
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    # live-observatory tier: a committed snapshot is status evidence
    # (the operator's "how stale would a resume be" question; no-op
    # disarmed)
    from acg_tpu_torch import observatory
    observatory.note_event(
        "snapshot", f"seq {meta.get('seq', '?')} committed at "
                    f"iteration {meta.get('iteration', '?')}")
    return len(MAGIC) + len(preamble) + 1 + len(header) + len(payload)


def load_snapshot(path) -> SolverSnapshot:
    """Read + verify one snapshot; raises a typed
    :class:`~acg_tpu.errors.AcgError` on any integrity failure (bad
    magic, unknown version, header or payload checksum mismatch,
    truncation) -- a resumed solve must never start from garbage."""
    def bad(why: str):
        return AcgError(ErrorCode.INVALID_VALUE,
                        f"{path}: not a usable snapshot ({why})")

    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise AcgError(ErrorCode.INVALID_VALUE, f"{path}: {e}")
    if not blob.startswith(MAGIC):
        raise bad("bad magic; not an acg-tpu snapshot")
    rest = blob[len(MAGIC):]
    nl = rest.find(b"\n")
    if nl < 0:
        raise bad("truncated preamble")
    try:
        pre = json.loads(rest[:nl])
    except ValueError:
        raise bad("unparseable preamble")
    if int(pre.get("version", -1)) != VERSION:
        raise bad(f"unknown snapshot version {pre.get('version')!r}")
    hlen = int(pre["header_len"])
    header = rest[nl + 1: nl + 1 + hlen]
    payload = rest[nl + 1 + hlen:]
    if len(header) != hlen:
        raise bad("truncated header")
    if _crc(header) != int(pre["header_crc"]):
        raise bad("header checksum mismatch")
    if _crc(payload) != int(pre["payload_crc"]):
        raise bad("payload checksum mismatch")
    doc = json.loads(header)
    arrays = {}
    for m in doc["arrays"]:
        start, n = int(m["offset"]), int(m["nbytes"])
        raw = payload[start: start + n]
        if len(raw) != n:
            raise bad(f"array {m['name']!r} truncated")
        arrays[m["name"]] = np.frombuffer(
            raw, dtype=np.dtype(m["dtype"])).reshape(m["shape"]).copy()
    return SolverSnapshot(meta=doc["meta"], arrays=arrays)


def validate_resume(snap: SolverSnapshot, *, tier: str, pipelined: bool,
                    precond: str | None, n: int, dtype,
                    b_crc: int | None = None,
                    nparts: int | None = None,
                    repartition: bool = False,
                    nrhs: int | None = None,
                    algorithm: str | None = None) -> None:
    """Refuse a snapshot that does not describe THIS solve: wrong tier,
    algorithm, preconditioner, size, dtype, partition count, or
    right-hand side.  A mismatch here means the operator pointed
    ``--resume`` at somebody else's solve -- continuing would converge
    to the wrong answer with a green exit code.

    ``repartition=True`` (the ``--resume-repartition`` opt-in) relaxes
    EXACTLY the shape checks -- tier and partition count -- for the
    tiers whose reassembled carries are field-compatible
    (:data:`REPARTITION_TIERS`): an N-part snapshot may then restore
    onto an M-part mesh, the single-device tier, or the host oracle.
    Algorithm, preconditioner, size, dtype and right-hand-side
    mismatches keep refusing -- those would still converge to the
    wrong answer."""
    m = snap.meta

    def need(key, want, what):
        got = m.get(key)
        if got != want:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"snapshot does not match this solve: {what} is "
                f"{got!r}, this run has {want!r}")

    if repartition:
        got_tier = m.get("tier")
        # batched tiers repartition among themselves: their carry
        # leaves carry a trailing per-RHS axis the single-RHS tiers'
        # reconstruction cannot consume (and vice versa)
        allowed = (BATCHED_REPARTITION_TIERS if nrhs is not None
                   else REPARTITION_TIERS)
        if tier not in allowed or got_tier not in allowed:
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                f"repartition resume supports the "
                f"{'/'.join(sorted(allowed))} tiers; this "
                f"snapshot is {got_tier!r} and this solve "
                f"{tier!r}")
    else:
        need("tier", tier, "solver tier")
        if nparts is not None:
            need("nparts", int(nparts), "partition count")
    need("pipelined", bool(pipelined), "algorithm (pipelined)")
    if algorithm is not None or m.get("algorithm") is not None:
        # communication-avoiding recurrences snapshot a DIFFERENT carry
        # layout per recurrence (ca_carry_names): an sstep:4 snapshot
        # resumed as pipelined:3 (or classic) would scramble the state
        need("algorithm", algorithm, "recurrence")
    need("precond", precond, "preconditioner")
    need("n", int(n), "unknowns")
    need("dtype", str(np.dtype(dtype)), "vector dtype")
    if nrhs is not None:
        # a batch must resume as the SAME batch: per-RHS leaves of a
        # different width would scramble every column's Krylov state
        need("nrhs", int(nrhs), "right-hand-side count")
    if b_crc is not None and m.get("b_crc") is not None:
        need("b_crc", int(b_crc), "right-hand-side checksum")


def reassemble_global(snap: SolverSnapshot) -> SolverSnapshot:
    """An N-part snapshot's carry vectors reassembled into GLOBAL row
    order via the stored row-permutation sidecar (``_rowperm`` array +
    ``part_rows`` metadata), ready to re-slice onto any partition --
    the shape-portable half of ``--resume-repartition``.  Snapshots
    from the single-device/host tiers (no sidecar, nparts absent or 1)
    already store global vectors and pass through unchanged.  A
    missing, malformed or corrupted sidecar REFUSES with a typed
    error: scattering rows through a wrong permutation would resume a
    scrambled Krylov state and converge to a wrong answer."""
    m = snap.meta
    nparts = int(m.get("nparts") or 1)
    if nparts <= 1 and "_rowperm" not in snap.arrays:
        return snap

    def bad(why: str):
        return AcgError(
            ErrorCode.INVALID_VALUE,
            f"snapshot cannot be repartitioned: {why}")

    n = int(m["n"])
    perm = snap.arrays.get("_rowperm")
    part_rows = m.get("part_rows")
    if perm is None or part_rows is None:
        raise bad("it lacks the row-permutation sidecar (_rowperm + "
                  "part_rows; written by checkpoint-armed distributed "
                  "solves from this release on) -- re-snapshot, or "
                  "resume on the matching partition without "
                  "--resume-repartition")
    perm = np.asarray(perm).reshape(-1).astype(np.int64, copy=False)
    try:
        part_rows = [int(r) for r in part_rows]
    except (TypeError, ValueError):
        raise bad(f"part_rows is not a row-count list: {part_rows!r}")
    if len(part_rows) != nparts or any(r < 0 for r in part_rows) \
            or sum(part_rows) != n:
        raise bad(f"part_rows {part_rows!r} does not partition "
                  f"{n} rows into {nparts} parts")
    from acg_tpu_torch.partition import is_permutation
    if not is_permutation(perm, n):
        raise bad(f"the row-permutation sidecar is not a permutation "
                  f"of {n} rows (corrupted or stale sidecar)")

    batched = int(m.get("nrhs") or 0) > 1
    arrays = {}
    for name, a in snap.arrays.items():
        if name == "_rowperm":
            continue
        a = np.asarray(a)
        if name in SCALAR_LEAVES or a.ndim == 0 \
                or (batched and name in BATCHED_COL_LEAVES):
            # per-RHS column vectors (gamma/done/iters of the batched
            # carry) are replicated, not row-partitioned: pass through
            arrays[name] = a
            continue
        if batched:
            # batched per-RHS leaves stack as (nparts, pad, B): the
            # row permutation applies to axis 1, columns ride along
            if a.ndim != 3 or a.shape[0] != nparts \
                    or a.shape[1] < max(part_rows, default=0):
                raise bad(f"carry leaf {name!r} (shape {a.shape}) "
                          f"does not hold the {nparts}-part batched "
                          f"stacked layout")
            out = np.zeros((n, a.shape[2]), dtype=a.dtype)
            off = 0
            for p, rows in enumerate(part_rows):
                out[perm[off: off + rows]] = a[p, :rows]
                off += rows
            arrays[name] = out
            continue
        if a.ndim != 2 or a.shape[0] != nparts \
                or a.shape[1] < max(part_rows, default=0):
            raise bad(f"carry leaf {name!r} (shape {a.shape}) does "
                      f"not hold the {nparts}-part stacked layout")
        out = np.zeros(n, dtype=a.dtype)
        off = 0
        for p, rows in enumerate(part_rows):
            out[perm[off: off + rows]] = a[p, :rows]
            off += rows
        arrays[name] = out
    meta = dict(m)
    meta["repartitioned_from"] = {"tier": m.get("tier"),
                                  "nparts": nparts}
    meta.pop("nparts", None)
    meta.pop("part_rows", None)
    return SolverSnapshot(meta=meta, arrays=arrays)


def apply_repartition(snap: SolverSnapshot, *, tier: str, nparts: int,
                      stats, precond_spec=None) -> tuple:
    """The shared repartition-resume sequence (ONE implementation for
    the jax-cg / dist-cg / host-cg chunk drivers): reassemble the
    snapshot's carry into global row order, and when the source shape
    differs from this solve's, record the repartition metric + the
    structured event and warn when the preconditioner operator depends
    on the partition (continuing under a different M is flexible-CG).
    Returns ``(snapshot, repartitioned)`` -- ``repartitioned`` is
    ``{"tier", "nparts"}`` of the source, or None when the shapes
    already matched."""
    import sys

    src = (snap.meta.get("tier"), int(snap.meta.get("nparts") or 1))
    snap = reassemble_global(snap)
    if src == (tier, int(nparts)):
        return snap, None
    from acg_tpu_torch import metrics
    from acg_tpu_torch.telemetry import record_event

    metrics.record_repartition()
    record_event(stats, "repartition",
                 f"resumed a {src[1]}-part {src[0]} snapshot on "
                 f"{int(nparts)}-part {tier}")
    from acg_tpu_torch.precond import partition_sensitive
    if precond_spec is not None and partition_sensitive(precond_spec):
        sys.stderr.write(
            f"acg-tpu-torch: warning: --precond {precond_spec} depends on "
            f"the partition; the repartitioned resume continues with "
            f"a DIFFERENT M (flexible-CG semantics -- expect a few "
            f"extra iterations)\n")
    return snap, {"tier": src[0], "nparts": src[1]}


def agree_seq(seq: int, iteration: int, timeout: float = 120.0) -> None:
    """Multi-controller snapshot commit barrier: every controller
    reports its (sequence, iteration) pair and all verify the pod holds
    ONE agreed state before the primary writes -- a snapshot whose
    ranks disagree on the iteration number is corruption with a valid
    checksum.  Single-process: free."""
    from acg_tpu_torch.parallel import multihost

    if multihost.process_count() == 1:
        return
    from acg_tpu_torch.parallel.erragree import allgather_blobs

    mine = f"{int(seq)}:{int(iteration)}"
    got = allgather_blobs(mine, tag="ckpt-seq", timeout=timeout)
    if any(g != mine for g in got):
        raise AcgError(
            ErrorCode.INVALID_VALUE,
            f"snapshot sequence disagreement across controllers: "
            f"{sorted(set(got))} (mine {mine}) -- refusing to commit")


def trace_tail(trace, n: int = 8) -> list:
    """The trailing telemetry-ring rows as small JSON-able dicts (the
    snapshot's post-mortem evidence; [] without a trace)."""
    if trace is None:
        return []
    m = min(int(n), trace.iterations.size)
    return [trace.record_dict(trace.iterations.size - m + i)
            for i in range(m)]
