"""Host reference CG solvers (numpy, float64): the correctness oracles.

A copy of ``acg_tpu/solvers/host_cg.py`` (the reference's textbook host
solver ``acg/cg.c``), with the same numpy arithmetic op for op, so x and
the statistics come out bitwise-equal to the JAX package's:

* :class:`HostCGSolver` -- serial CG (PCG under ``precond``, through
  :class:`~acg_tpu_torch.precond.HostPrecond`), all four stopping
  criteria, the update order of ``acgsolver_solve`` (``cg.c:198-407``):

      r0 = b - A x0;  p = r;  gamma = (r,r)
      repeat:  t = A p
               alpha = gamma / (p,t)
               x += alpha p;  r -= alpha t
               gamma' = (r,r);  beta = gamma'/gamma;  p = r + beta p

* :class:`NativeHostCGSolver` -- the same recurrence in the native C++
  core (``native/src/cg.cpp``, :mod:`acg_tpu_torch._native`).
* :class:`HostDistCGSolver` -- the multi-part host CG over subdomains
  (``acgsolver_solvempi``, ``cg.c:408``).
* :func:`host_batched_cg` / :func:`host_block_cg` -- the eager
  multi-RHS oracles of the batched tier.

They compute on the host by definition: no device array is involved.
``HostCGSolver`` records its convergence trace through
:class:`~acg_tpu_torch.telemetry.EagerTraceRecorder` (``trace``) and
prints the heartbeat line (``progress``), and carries the robustness
tier's recovery, health and checkpoint hooks as the reference does.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from acg_tpu_torch import metrics, observatory
from acg_tpu_torch.errors import IndefiniteMatrixError, NotConvergedError
from acg_tpu_torch.matrix import SymCsrMatrix
from acg_tpu_torch.solvers.stats import (SolverStats, StoppingCriteria,
                                         cg_flops_per_iteration)
from acg_tpu_torch.telemetry import EagerTraceRecorder, add_timing

def as_csr(A: SymCsrMatrix | sp.spmatrix,
           epsilon: float = 0.0) -> sp.csr_matrix:
    """Normalise a solver matrix argument to scipy CSR with the
    ``--epsilon`` diagonal shift applied (``symcsrmatrix.c:760-862``)."""
    if isinstance(A, SymCsrMatrix):
        return A.to_csr(epsilon)
    A = sp.csr_matrix(A)
    if epsilon:
        A = (A + epsilon * sp.eye(A.shape[0], format="csr")).tocsr()
    return A


class HostCGSolver:
    """Serial host CG over a :class:`SymCsrMatrix` (the ``acgsolver``
    role); ``precond`` (a :class:`~acg_tpu_torch.precond.PrecondSpec` or
    its text) makes it the eager PCG oracle.  ``trace`` (window size; 0 =
    off) records each iteration's ``(rnrm2, alpha, beta, pAp)`` into
    ``last_trace``/``stats.trace`` (under ``precond`` the rnrm2 slot is
    the preconditioned norm sqrt((r, z)), as the device rings record
    it); ``progress`` (iterations; 0 = off) prints the heartbeat line
    every that many iterations.

    ``recovery`` (:class:`~acg_tpu_torch.solvers.resilience.
    RecoveryPolicy`) arms breakdown detection -- non-finite residual or
    non-positive (p, Ap) -- with eager in-place restart; detection also
    arms while the fault injector (:mod:`acg_tpu_torch.faults`) is
    active.  ``health`` (:class:`~acg_tpu_torch.health.HealthSpec`) is
    the eager twin of the device audit, ABFT and stall detector;
    ``ckpt`` (:class:`~acg_tpu_torch.checkpoint.CheckpointConfig`)
    writes snapshots in-loop and answers breakdowns with the rollback
    rung first.  The class is the reference's (``acg_tpu/solvers/
    host_cg.py``), with the hooks' types and the counts checked."""

    def __init__(self, A: SymCsrMatrix | sp.spmatrix, epsilon: float = 0.0,
                 recovery=None, trace: int = 0, progress: int = 0,
                 precond=None, health=None, ckpt=None):
        self.A = as_csr(A, epsilon)
        self.n = self.A.shape[0]
        # survivability tier (acg_tpu.checkpoint): the eager twin of
        # the compiled chunk drivers -- snapshots written in-loop every
        # ``ckpt.every`` iterations, breakdowns answered by the
        # rollback rung first
        if ckpt is not None:
            from acg_tpu_torch.checkpoint import CheckpointConfig
            if not isinstance(ckpt, CheckpointConfig):
                raise ValueError("ckpt must be an acg_tpu_torch.checkpoint."
                                 "CheckpointConfig or None")
        self.ckpt = ckpt
        self.nnz_full = self.A.nnz
        from acg_tpu_torch.health import HealthSpec
        from acg_tpu_torch.solvers.resilience import RecoveryPolicy
        if recovery is not None and not isinstance(recovery,
                                                   RecoveryPolicy):
            raise ValueError("recovery must be an acg_tpu_torch.solvers."
                             "resilience.RecoveryPolicy or None")
        if health is not None and not isinstance(health, HealthSpec):
            raise ValueError("health must be an acg_tpu_torch.health."
                             "HealthSpec or None")
        self.recovery = recovery
        # numerical-health tier (acg_tpu.health): the EAGER twin of the
        # compiled tiers' in-loop audit -- f64 arithmetic, so this
        # solver doubles as the ground-truth-gap oracle in the tests.
        # `replace` applies residual replacement literally (r := b - Ax
        # in place) instead of the compiled tiers' restart hand-off
        if health is not None and not getattr(health, "armed", False):
            health = None
        self.health_spec = health
        # preconditioning tier (acg_tpu.precond): the eager PCG twin of
        # the compiled solvers' -- same three kinds, f64 numpy/scipy
        # arithmetic (this solver doubles as the PCG oracle in tests)
        from acg_tpu_torch.precond import parse_precond
        self.precond_spec = parse_precond(precond)
        self._mhost = None
        # telemetry tier (acg_tpu.telemetry): the eager twin of the
        # compiled solvers' device ring -- same (rnrm2, alpha, beta,
        # pAp) tuple, same capacity/wrap semantics, recorded per
        # iteration in plain Python
        self.trace = int(trace)
        self.progress = int(progress)
        if self.trace < 0 or self.progress < 0:
            raise ValueError("trace/progress must be >= 0 (iteration "
                             "counts; 0 disables)")
        self.last_trace = None
        self.stats = SolverStats(unknowns=self.n)

    def _op(self, name, t, n_bytes, flops):
        self.stats.ops[name].add(1, t, n_bytes)
        self.stats.nflops += flops

    def solve(self, b: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        A, n = self.A, self.n
        b = np.asarray(b, dtype=np.float64)
        x = np.array(x0, dtype=np.float64, copy=True) if x0 is not None else np.zeros(n)
        dbl = 8
        from acg_tpu_torch import faults
        fault = faults.device_fault()
        _spec_all = faults.active_fault()
        if (_spec_all is not None and _spec_all.site == "crash"
                and (self.ckpt is None or self.ckpt.path is None)):
            from acg_tpu_torch.errors import AcgError, ErrorCode
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "crash:exit fires between snapshot commits; arm "
                "--ckpt FILE --ckpt-every K (a crash with no snapshot "
                "to resume from proves nothing)")
        if fault is not None and (fault.site == "halo" or fault.part > 0):
            from acg_tpu_torch.errors import AcgError, ErrorCode
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "the serial host solver has no halo and only part 0: "
                "this fault spec could never fire")
        if (fault is not None and fault.site == "precond"
                and self.precond_spec is None):
            from acg_tpu_torch.errors import AcgError, ErrorCode
            raise AcgError(
                ErrorCode.INVALID_VALUE,
                "precond fault injection needs an armed preconditioner "
                "(--precond jacobi|bjacobi|cheby:K); this solve runs "
                "unpreconditioned CG")
        M = None
        if self.precond_spec is not None:
            if self._mhost is None:
                from acg_tpu_torch.precond import HostPrecond
                self._mhost = HostPrecond(self.precond_spec, A)
            M = self._mhost
            from acg_tpu_torch.precond import (bytes_per_apply, flops_per_apply,
                                         state_bytes)
            self._mflops = flops_per_apply(self.precond_spec, self.n,
                                           3.0 * self.nnz_full)
            # kind-aware per-apply traffic (cheby streams the CSR
            # degree-many times), matching the compiled tiers' census
            self._mbytes = bytes_per_apply(
                self.precond_spec, self.n, 8,
                self.nnz_full * (8 + 4) + 2 * self.n * 8,
                state_bytes(M.state))
        pol = self.recovery
        # detection mirrors the device tiers' _detect: recovery, an
        # active injector, or a health spec whose detectors trip (the
        # replace/abort/stall actions route through the driver so the
        # restart budget and the resilience counters stay honest)
        detect = (pol is not None or fault is not None
                  or (self.health_spec is not None
                      and self.health_spec.arms_detect))
        driver = None
        if detect:
            from acg_tpu_torch.solvers.resilience import RecoveryDriver
            driver = RecoveryDriver(pol, st, "host-cg")
        hspec = self.health_spec
        audited = hspec is not None and hspec.every > 0
        # audit bookkeeping mirroring the device tiers' carried vector
        h_gap, h_gap_max, h_naud, h_stall = float("nan"), 0.0, 0, 0
        # ABFT checksum bookkeeping (the eager Huang-Abraham twin):
        # column checksum c = A^T 1 = A 1 (symmetric), compared against
        # sum(A p) at the audit cadence with the device tiers' exact
        # mismatch scale
        abft_armed = hspec is not None and hspec.abft
        ab_rel, ab_max, ab_n, ab_trips = float("nan"), 0.0, 0, 0
        if abft_armed:
            from acg_tpu_torch.health import abft_default_threshold
            cvec = A @ np.ones(n)
            ab_tau = (hspec.abft_threshold
                      or abft_default_threshold(np.float64, n))

        def aud_vec():
            """The device tiers' fetched audit vector, rebuilt from the
            eager counters (8 slots with ABFT armed, 4 without)."""
            base = [h_gap, h_gap_max, h_naud, h_stall]
            if abft_armed:
                base += [ab_rel, ab_max, ab_n, ab_trips]
            return base

        rr_prev = float("inf")
        recorder = None
        if self.trace:
            from acg_tpu_torch.telemetry import EagerTraceRecorder
            recorder = EagerTraceRecorder(self.trace, audit=audited)

        def finish_trace():
            if recorder is not None:
                st.trace = self.last_trace = recorder.finish()
            return st.trace

        tstart = time.perf_counter()
        # st.timings["ckpt"] accumulates across solves on a shared
        # stats object; bill only THIS solve's snapshot seconds below
        ck_base = st.timings.get("ckpt", 0.0)
        st.bnrm2 = float(np.linalg.norm(b))
        st.x0nrm2 = float(np.linalg.norm(x))

        t0 = time.perf_counter()
        r = b - A @ x
        self._op("gemv", time.perf_counter() - t0,
                 self.nnz_full * (dbl + 4) + 2 * n * dbl, 3.0 * self.nnz_full)

        napply = [0]

        def papply(r, k=None):
            """One timed preconditioner apply (eager: seconds are real,
            unlike the compiled tiers' replayed estimates).  The op row
            counts per the compiled tiers' convention: cheby bills its
            degree-many SpMVs per apply, so host and device censuses
            agree."""
            t0 = time.perf_counter()
            z = M.apply(r)
            if fault is not None and k is not None:
                z = fault.apply_precond_np(z, k)
            napply[0] += 1
            per = (self.precond_spec.degree
                   if self.precond_spec.kind == "cheby" else 1)
            self.stats.ops["precond"].add(per, time.perf_counter() - t0,
                                          int(self._mbytes))
            self.stats.nflops += self._mflops
            return z

        if M is not None:
            z = papply(r)
            p = z.copy()
            gamma = float(r @ z)
            rr = float(r @ r)
            self._op("dot", 0.0, 2 * n * dbl, 2.0 * n)
        else:
            p = r.copy()
            gamma = rr = float(r @ r)
        self._op("copy", 0.0, 2 * n * dbl, 0.0)

        t0 = time.perf_counter()
        self._op("nrm2", time.perf_counter() - t0, n * dbl, 2.0 * n)
        st.r0nrm2 = st.rnrm2 = float(np.sqrt(rr))
        st.dxnrm2 = np.inf

        res_tol = max(crit.residual_atol,
                      crit.residual_rtol * st.r0nrm2)
        st.niterations = 0
        st.nsolves += 1
        converged = (not crit.unbounded) and self._test(crit, st, res_tol)
        k = 0

        # -- survivability tier: resume reconstruction + snapshot state
        ck = self.ckpt
        pc_kind = (str(self.precond_spec)
                   if self.precond_spec is not None else None)
        resumed_from = None
        nsnaps = 0
        last_snap = None
        if ck is not None and ck.resume is not None:
            from acg_tpu_torch import checkpoint as ckpt_mod
            from acg_tpu_torch import metrics as _m
            from acg_tpu_torch.telemetry import record_event
            snap = ck.resume
            ckpt_mod.validate_resume(
                snap, tier="host-cg", pipelined=False, precond=pc_kind,
                n=n, dtype=np.float64,
                b_crc=ckpt_mod.vector_checksum(b),
                repartition=ck.repartition)
            ckpt_mod.check_resume_env(snap, st)
            if ck.repartition:
                # shape-portable resume: a stacked N-part snapshot
                # reassembles into the global row vectors this eager
                # oracle natively carries
                snap, _rep = ckpt_mod.apply_repartition(
                    snap, tier="host-cg", nparts=1, stats=st,
                    precond_spec=self.precond_spec)
            x = np.array(snap.arrays["x"], dtype=np.float64)
            r = np.array(snap.arrays["r"], dtype=np.float64)
            p = np.array(snap.arrays["p"], dtype=np.float64)
            gamma = float(snap.arrays["gamma"])
            rr = (float(snap.arrays["rr"]) if "rr" in snap.arrays
                  else gamma)
            k = resumed_from = snap.iteration
            sm = snap.meta
            # the FIRST attempt's absolute target and norms (never
            # re-baseline rtol against an already-small residual)
            res_tol = float(sm["abs_tol"])
            st.bnrm2 = float(sm["bnrm2"])
            st.x0nrm2 = float(sm["x0nrm2"])
            st.r0nrm2 = float(sm["r0nrm2"])
            st.rnrm2 = float(np.sqrt(rr))
            last_snap = (k, dict(snap.arrays))
            converged = ((not crit.unbounded)
                         and self._test(crit, st, res_tol))
            _m.record_resume()
            record_event(st, "resume",
                         f"resumed from snapshot at iteration {k}")

        # wall-clock cadence (ckpt_secs): time of the last commit
        last_commit = [time.perf_counter()]

        def _commit_snapshot():
            """One snapshot at the current iteration boundary (atomic
            rename, checkpoint.save_snapshot); billed to the 'ckpt'
            phase so solve latency stays clean."""
            nonlocal nsnaps, last_snap
            from acg_tpu_torch import checkpoint as ckpt_mod
            from acg_tpu_torch import metrics as _m
            from acg_tpu_torch.telemetry import add_timing
            t_ck = time.perf_counter()
            last_commit[0] = t_ck
            arrs = {"x": x.copy(), "r": r.copy(), "p": p.copy(),
                    "gamma": np.float64(gamma)}
            if M is not None:
                arrs["rr"] = np.float64(rr)
            meta = {
                "tier": "host-cg", "pipelined": False,
                "precond": pc_kind, "n": int(n), "dtype": "float64",
                "iteration": int(k), "seq": nsnaps + 1,
                "abs_tol": float(res_tol),
                "bnrm2": st.bnrm2, "x0nrm2": st.x0nrm2,
                "r0nrm2": st.r0nrm2,
                "b_crc": ckpt_mod.vector_checksum(b),
                "fault": (str(faults.active_fault())
                          if faults.active_fault() is not None else None),
                "trace_tail": ckpt_mod.trace_tail(None),
            }
            nbytes = ckpt_mod.save_snapshot(ck.path, meta, arrs)
            dt = time.perf_counter() - t_ck
            add_timing(st, "ckpt", dt)
            _m.record_snapshot(nbytes, dt)
            prev = last_snap[0] if last_snap is not None else (
                resumed_from or 0)
            nsnaps += 1
            last_snap = (int(k), arrs)
            # crash:exit models preemption between iterations, after
            # the snapshot committed (crossing semantics: a resumed
            # solve starting at-or-past K does not re-kill itself)
            faults.maybe_crash(prev, k)

        def _breakdown(why: str):
            """Detected-breakdown recovery (eager twin of the compiled
            chunk drivers, same RecoveryDriver bookkeeping): FIRST roll
            the Krylov state back to the last snapshot when one exists;
            else recompute the true residual from the last finite
            iterate and rebuild the Krylov space; raise once the
            policy's restarts are exhausted."""
            nonlocal x, r, p, gamma, rr, M, k, fault
            driver.log_trace_window(finish_trace())
            driver.note_breakdown(k)
            # a deterministically-injected fault that already fired
            # must not re-fire after the rollback rewinds k
            if (fault is not None and fault.device_site
                    and fault.iteration < k):
                fault = None
            if (last_snap is not None
                    and driver.on_rollback(k, last_snap[0])):
                ks, arrs = last_snap
                x = np.array(arrs["x"])
                r = np.array(arrs["r"])
                p = np.array(arrs["p"])
                gamma = float(arrs["gamma"])
                rr = float(arrs.get("rr", gamma))
                k = ks
                st.rnrm2 = float(np.sqrt(rr))
                return
            if not driver.on_breakdown(k, noted=True):
                st.tsolve += time.perf_counter() - tstart
                st.converged = False
                st.fexcept_arrays = [x, r]
                if hspec is not None:
                    # the audits that ran must reach the health
                    # surfaces on exactly the failing solves
                    from acg_tpu_torch.health import note_audit
                    note_audit(st, aud_vec(), hspec, "host-cg")
                raise driver.give_up(
                    k, st.rnrm2,
                    snapshot=(ck.path if ck is not None and nsnaps
                              else None))
            if not np.isfinite(x).all():
                x = (np.array(x0, dtype=np.float64, copy=True)
                     if x0 is not None else np.zeros(n))
                driver.record("iterate non-finite; restarting from the "
                              "initial guess")
            r = b - A @ x
            if M is not None:
                # preserve-or-rebuild (the compiled tiers' contract):
                # immutable finite state survives; a poisoned one is
                # refactored from the matrix
                if not all(np.isfinite(np.asarray(leaf)).all()
                           for leaf in M.state):
                    from acg_tpu_torch.precond import HostPrecond
                    self._mhost = M = HostPrecond(self.precond_spec, A)
                    driver.record(f"preconditioner "
                                  f"({self.precond_spec}) state "
                                  f"non-finite; rebuilt from the matrix")
                else:
                    driver.record(f"preconditioner "
                                  f"({self.precond_spec}) state "
                                  f"preserved across restart")
                z = M.apply(r)
                p = z.copy()
                gamma = float(r @ z)
                rr = float(r @ r)
            else:
                p = r.copy()
                gamma = rr = float(r @ r)
            st.rnrm2 = float(np.sqrt(rr))

        while not converged and k < crit.maxits:
            t0 = time.perf_counter()
            t = A @ p
            if fault is not None:
                t = fault.apply_spmv_np(t, k)
            self._op("gemv", time.perf_counter() - t0,
                     self.nnz_full * (dbl + 4) + 2 * n * dbl, 3.0 * self.nnz_full)

            if abft_armed and (k + 1) % hspec.every == 0:
                # the eager Huang-Abraham check of THIS iteration's
                # t = A p: sum(t) vs (c, p), the device tiers' exact
                # mismatch scale -- a sign-flipped element (sdc:flip)
                # is finite, so only this test can see it
                ssum, cp, tt = float(t.sum()), float(cvec @ p), float(t @ t)
                denom = (np.sqrt(max(tt, 0.0) * n) + abs(ssum) + abs(cp)
                         + np.finfo(np.float64).tiny)
                rel = abs(ssum - cp) / denom
                ab_rel, ab_n = rel, ab_n + 1
                ab_max = max(ab_max, rel)
                if rel > ab_tau:
                    ab_trips += 1
                    k += 1
                    st.niterations = k
                    st.ntotaliterations += 1
                    _breakdown("ABFT checksum mismatch")
                    converged = self._test(crit, st, res_tol)
                    continue

            t0 = time.perf_counter()
            pdott = float(p @ t)
            if fault is not None:
                pdott = fault.apply_dot_np(pdott, k)
            self._op("dot", time.perf_counter() - t0, 2 * n * dbl, 2.0 * n)
            if detect and (not np.isfinite(pdott)
                           or (pdott <= 0.0 and gamma > 0.0)):
                k += 1
                st.niterations = k
                st.ntotaliterations += 1
                if recorder is not None:
                    # the poisoned scalar stays visible in the window
                    # the recovery log quotes; no update ran -> no
                    # alpha/beta for this iteration (preconditioned
                    # norm under precond, the compiled rings' slot)
                    gq = gamma if M is not None else st.rnrm2 ** 2
                    recorder.record(np.sqrt(gq) if gq >= 0 else gq,
                                    np.nan, np.nan, pdott)
                _breakdown("non-finite or non-positive p^T A p")
                converged = self._test(crit, st, res_tol)
                continue
            if pdott == 0.0:
                if gamma == 0.0:
                    # r = p = 0: exactly converged (reachable in
                    # fixed-iteration mode past convergence); iterating
                    # further is a 0/0, not an indefiniteness
                    break
                # (p, Ap) == 0 for p != 0: not positive definite; abort
                # like the reference (cg.c:304) instead of dividing
                st.tsolve += time.perf_counter() - tstart
                st.converged = False
                st.fexcept_arrays = [x, r]
                finish_trace()
                raise IndefiniteMatrixError(
                    f"(p, Ap) = 0 at iteration {k}")
            alpha = gamma / pdott

            t0 = time.perf_counter()
            x += alpha * p
            r -= alpha * t
            self._op("axpy", time.perf_counter() - t0, 3 * n * dbl, 2.0 * n)
            self._op("axpy", 0.0, 3 * n * dbl, 2.0 * n)

            if M is not None:
                z = papply(r, k)
                t0 = time.perf_counter()
                gamma_next = float(r @ z)
                rr = float(r @ r)
                self._op("dot", time.perf_counter() - t0, 2 * n * dbl,
                         2.0 * n)
                self._op("nrm2", 0.0, n * dbl, 2.0 * n)
            else:
                t0 = time.perf_counter()
                gamma_next = rr = float(r @ r)
                self._op("nrm2", time.perf_counter() - t0, n * dbl,
                         2.0 * n)
            if detect and (not np.isfinite(gamma_next)
                           or not np.isfinite(rr)
                           # a negative (r, z): the non-SPD-M signal
                           or (M is not None and gamma_next < 0)
                           # sign anomaly under the health tier: a
                           # negative computed (r, r) is arithmetic
                           # poison (device-tier rationale)
                           or (hspec is not None and gamma_next < 0)):
                k += 1
                st.niterations = k
                st.ntotaliterations += 1
                if recorder is not None:
                    # the compiled rings record the PRECONDITIONED
                    # residual norm under precond (the raw poisoned
                    # gamma stays visible); mirror them exactly
                    gq = gamma_next if M is not None else rr
                    recorder.record(np.sqrt(gq) if gq >= 0 else gq,
                                    alpha, np.nan, pdott)
                _breakdown("non-finite residual"
                           if not np.isfinite(rr)
                           else "non-SPD preconditioner signal")
                converged = self._test(crit, st, res_tol)
                continue
            gap = float("nan")
            if audited and (k + 1) % hspec.every == 0:
                # the eager twin of the device audit: true residual in
                # f64 through the same CSR, gap relative to ||b||
                rt = b - A @ x
                gap = (float(np.linalg.norm(rt - r))
                       / max(st.bnrm2, 1e-300))
                h_gap, h_naud = gap, h_naud + 1
                h_gap_max = max(h_gap_max, gap)
                if hspec.threshold and gap > hspec.threshold:
                    if hspec.action == "abort":
                        st.tsolve += time.perf_counter() - tstart
                        st.converged = False
                        st.fexcept_arrays = [x, r]
                        finish_trace()
                        from acg_tpu_torch.errors import BreakdownError
                        from acg_tpu_torch.health import note_audit
                        note_audit(st, aud_vec(), hspec, "host-cg")
                        raise BreakdownError(
                            f"host-cg: true-residual gap {gap:.3e} "
                            f"exceeds threshold {hspec.threshold:g} at "
                            f"iteration {k} (--on-gap abort)")
                    if hspec.action == "replace":
                        # residual replacement, applied literally (Van
                        # der Vorst & Ye): the recurrence residual is
                        # swapped for the true one -- but BOUNDED by
                        # the same restart budget the compiled tiers
                        # consume, and counted on the same resilience
                        # counters (driver.on_breakdown), so the
                        # cross-tier stats stay comparable and a
                        # hair-trigger threshold cannot loop forever
                        if not driver.on_breakdown(k):
                            st.tsolve += time.perf_counter() - tstart
                            st.converged = False
                            st.fexcept_arrays = [x, r]
                            finish_trace()
                            from acg_tpu_torch.errors import BreakdownError
                            from acg_tpu_torch.health import note_audit
                            note_audit(st, aud_vec(), hspec, "host-cg")
                            raise BreakdownError(
                                f"host-cg: true-residual gap {gap:.3e} "
                                f"exceeds threshold "
                                f"{hspec.threshold:g} at iteration "
                                f"{k} (--on-gap replace); "
                                f"{st.nrestarts} restart(s) exhausted "
                                f"and no fallback available")
                        st.recovery_log.append(
                            f"residual replacement at iteration {k}: "
                            f"gap {gap:.3e} > {hspec.threshold:g}")
                        r = rt
                        if M is not None:
                            z = papply(r)
                            gamma_next = float(r @ z)
                        else:
                            gamma_next = float(r @ r)
                        rr = float(r @ r)
            if hspec is not None and hspec.stall_window:
                h_stall = 0 if rr < rr_prev else h_stall + 1
                if h_stall >= hspec.stall_window:
                    # the stagnation detector feeds the breakdown path
                    # (an armed stall window always arms the driver --
                    # see the detect computation above), so restarts,
                    # counters, and the give-up raise match the
                    # compiled tiers'
                    k += 1
                    st.niterations = k
                    st.ntotaliterations += 1
                    st.rnrm2 = float(np.sqrt(rr)) if rr >= 0 else rr
                    h_stall = 0
                    _breakdown(f"stagnation: {hspec.stall_window} "
                               f"non-decreasing iterations")
                    converged = self._test(crit, st, res_tol)
                    continue
            rr_prev = rr
            beta = gamma_next / gamma
            gamma = gamma_next
            if crit.needs_diff:
                # ||x_{k+1} - x_k|| = |alpha| * ||p_k|| (the pre-update p)
                st.dxnrm2 = abs(alpha) * float(np.linalg.norm(p))

            t0 = time.perf_counter()
            p = (z if M is not None else r) + beta * p
            self._op("axpy", time.perf_counter() - t0, 3 * n * dbl, 2.0 * n)

            k += 1
            st.niterations = k
            st.ntotaliterations += 1
            st.rnrm2 = float(np.sqrt(rr))
            if recorder is not None:
                # the eager-twin contract: under precond the compiled
                # rings record the PRECONDITIONED norm sqrt((r, z)) in
                # the rnrm2 slot -- record the same quantity here (and
                # this iteration's audit gap in the gap column)
                gq = gamma if M is not None else rr
                recorder.record(float(np.sqrt(gq)) if gq >= 0 else gq,
                                alpha, beta, pdott, gap=gap)
            if self.progress and k % self.progress == 0:
                import sys

                # the observatory's shared heartbeat line: the oracle
                # path prints the same iterations/sec + ETA shape the
                # compiled loops' callback does, and feeds the status
                # endpoint the same samples
                from acg_tpu_torch import observatory
                sys.stderr.write(observatory.heartbeat_line(
                    "host-cg", k, st.rnrm2) + "\n")
            if not crit.unbounded:
                converged = self._test(crit, st, res_tol)
            if (ck is not None and ck.path is not None and not converged
                    and k < crit.maxits):
                due = (k % ck.every == 0 if ck.every > 0
                       else time.perf_counter() - last_commit[0]
                       >= ck.secs)
                if due:
                    _commit_snapshot()

        t_solve = time.perf_counter() - tstart
        # snapshot serialisation is billed to its own phase, never the
        # solve (the compiled chunk drivers' convention)
        t_solve -= st.timings.get("ckpt", 0.0) - ck_base
        st.tsolve += t_solve
        from acg_tpu_torch.telemetry import add_timing
        add_timing(st, "solve", t_solve)
        st.converged = converged or crit.unbounded
        if ck is not None:
            # niterations reports iterations THIS process executed (the
            # compiled chunk drivers' convention); the trajectory
            # iteration lives in the ckpt section
            if resumed_from is not None:
                st.niterations = max(k - resumed_from, 0)
            st.ckpt = {
                "path": ck.path,
                "every": int(ck.every),
                "snapshots": nsnaps,
                "iteration": int(k),
                "rollbacks": driver.rollbacks if driver is not None else 0,
            }
            if ck.secs > 0:
                st.ckpt["secs"] = float(ck.secs)
            if resumed_from is not None:
                st.ckpt["resumed_from"] = resumed_from
        if hspec is not None:
            from acg_tpu_torch.health import note_audit
            note_audit(st, aud_vec(), hspec, "host-cg")
        from acg_tpu_torch import metrics
        metrics.record_solve(t_solve, st.niterations, st.converged,
                             solver="host-cg")
        if M is not None:
            per = (self.precond_spec.degree
                   if self.precond_spec.kind == "cheby" else 1)
            st.precond.update({"kind": str(self.precond_spec),
                               "applies": napply[0],
                               "flops_per_apply": self._mflops})
            if self.precond_spec.kind == "cheby":
                st.precond["lambda_min"] = float(M.state[0])
                st.precond["lambda_max"] = float(M.state[1])
            metrics.record_precond(self.precond_spec.kind,
                                   napply[0] * per)
        st.fexcept_arrays = [x, r]
        finish_trace()
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{k} iterations, residual {st.rnrm2:.3e} > {res_tol:.3e}")
        return x

    @staticmethod
    def _test(crit: StoppingCriteria, st: SolverStats, res_tol: float) -> bool:
        if res_tol > 0 and st.rnrm2 < res_tol:
            return True
        if crit.diff_atol > 0 and st.dxnrm2 < crit.diff_atol:
            return True
        if crit.diff_rtol > 0 and st.dxnrm2 < crit.diff_rtol * max(st.x0nrm2, 1e-300):
            return True
        return False


class NativeHostCGSolver:
    """Host CG through the native C++ core (``native/src/cg.cpp``): the
    same recurrences and stopping criteria as :class:`HostCGSolver` (the
    two oracles cross-check each other), with the OpenMP SpMV loop at C
    speed.  Raises when the native library is not available."""

    def __init__(self, A: SymCsrMatrix | sp.spmatrix, epsilon: float = 0.0):
        from acg_tpu_torch import _native

        if not _native.available():
            raise RuntimeError(
                f"native core unavailable ({_native.build_error}; it is "
                f"built from native/src with g++) -- use --solver host")
        self._native = _native
        self.A = as_csr(A, epsilon)
        self.n = self.A.shape[0]
        self.nnz_full = self.A.nnz
        self.stats = SolverStats(unknowns=self.n)

    def solve(self, b: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        A, n = self.A, self.n
        b = np.asarray(b, dtype=np.float64)

        tstart = time.perf_counter()
        (x, r, niter, rnrm2, r0nrm2, dxnrm2, converged,
         indefinite) = self._native.cg_solve(
            A.indptr, A.indices, A.data, b, x0, crit.maxits,
            crit.residual_atol, crit.residual_rtol,
            crit.diff_atol, crit.diff_rtol)
        st.tsolve += time.perf_counter() - tstart

        st.nsolves += 1
        st.niterations = niter
        st.ntotaliterations += niter
        st.bnrm2 = float(np.linalg.norm(b))
        st.x0nrm2 = float(np.linalg.norm(x0)) if x0 is not None else 0.0
        st.r0nrm2, st.rnrm2 = r0nrm2, rnrm2
        st.dxnrm2 = dxnrm2
        st.converged = converged
        dbl = 8
        st.nflops += (cg_flops_per_iteration(self.nnz_full, n) * niter
                      + 3.0 * self.nnz_full + 2.0 * n)
        st.ops["gemv"].add(niter + 1, 0.0,
                           (self.nnz_full * (dbl + 8) + 2 * n * dbl)
                           * (niter + 1))
        st.ops["dot"].add(2 * niter, 0.0, 2 * n * dbl * 2 * niter)
        st.ops["axpy"].add(3 * niter, 0.0, 3 * n * dbl * 3 * niter)
        # scan x AND the final residual, like HostCGSolver
        st.fexcept_arrays = [x, r]
        if indefinite:
            raise IndefiniteMatrixError(f"(p, Ap) = 0 at iteration {niter}")
        if not converged and raise_on_divergence:
            raise NotConvergedError(
                f"{niter} iterations, residual {rnrm2:.3e}")
        return x


class HostDistCGSolver:
    """Distributed host CG over subdomains (``acgsolver_solvempi``,
    ``cg.c:408``), single-controller: per-part ghost-aware
    :class:`~acg_tpu_torch.vector.PVector` BLAS-1 with reductions summed
    across parts (the ``MPI_Allreduce`` role) and the halo exchange of
    :func:`~acg_tpu_torch.graph.halo_exchange_host`.  The host oracle of
    the stacked :class:`~acg_tpu_torch.parallel.dist.DistCGSolver` -- the
    same data layout, no device."""

    def __init__(self, subs):
        self.subs = subs
        self.n = sum(s.nowned for s in subs)
        self.nnz_total = sum(int(s.A_local.nnz + s.A_ghost.nnz) for s in subs)
        self.stats = SolverStats(unknowns=self.n)

    def _spmv(self, ps):
        """Distributed SpMV: halo(p) then local + off-diagonal blocks
        (``acgsymcsrmatrix_dsymvmpi``, ``symcsrmatrix.c:1353-1397``)."""
        from acg_tpu_torch.graph import dsymv_dist_host
        return dsymv_dist_host(self.subs, [p.data for p in ps])

    def solve(self, b_global: np.ndarray, x0: np.ndarray | None = None,
              criteria: StoppingCriteria | None = None,
              raise_on_divergence: bool = True) -> np.ndarray:
        from acg_tpu_torch.graph import gather_vector, scatter_vector
        from acg_tpu_torch.vector import PVector

        crit = criteria or StoppingCriteria()
        st = self.stats
        st.criteria = crit
        subs = self.subs
        b_global = np.asarray(b_global, dtype=np.float64)

        def pvecs(global_vec):
            return [PVector(v, s.nghost) for s, v in
                    zip(subs, scatter_vector(subs, global_vec))]

        def gdot(us, vs):
            return float(sum(u.dot(v) for u, v in zip(us, vs)))

        bs = pvecs(b_global)
        xs = pvecs(np.asarray(x0, dtype=np.float64) if x0 is not None
                   else np.zeros(self.n))

        tstart = time.perf_counter()
        st.bnrm2 = float(np.sqrt(gdot(bs, bs)))
        st.x0nrm2 = float(np.sqrt(gdot(xs, xs)))
        ts = self._spmv(xs)
        rs = [PVector(b.owned - t, 0) for b, t in zip(bs, ts)]
        ps = [PVector(np.concatenate([r.owned, np.zeros(s.nghost)]), s.nghost)
              for r, s in zip(rs, subs)]
        gamma = gdot(rs, rs)
        st.r0nrm2 = st.rnrm2 = float(np.sqrt(gamma))
        st.dxnrm2 = np.inf
        res_tol = max(crit.residual_atol, crit.residual_rtol * st.r0nrm2)
        st.niterations = 0
        st.nsolves += 1
        converged = (not crit.unbounded) and HostCGSolver._test(
            crit, st, res_tol)
        k = 0
        while not converged and k < crit.maxits:
            ts = self._spmv(ps)
            tvs = [PVector(t, 0) for t in ts]
            pdott = float(sum(np.dot(p.owned, t) for p, t in zip(ps, ts)))
            alpha = gamma / pdott
            if crit.needs_diff:
                st.dxnrm2 = abs(alpha) * float(
                    np.sqrt(gdot(ps, ps)))
            for x, r, p, t in zip(xs, rs, ps, tvs):
                x.axpy(alpha, p)
                r.axpy(-alpha, t)
            gamma_next = gdot(rs, rs)
            beta = gamma_next / gamma
            gamma = gamma_next
            for p, r in zip(ps, rs):
                p.aypx(beta, r)
            k += 1
            st.niterations = k
            st.ntotaliterations += 1
            st.rnrm2 = float(np.sqrt(gamma))
            if not crit.unbounded:
                converged = HostCGSolver._test(crit, st, res_tol)

        st.tsolve += time.perf_counter() - tstart
        st.converged = converged or crit.unbounded
        st.nflops += (3.0 * self.nnz_total + 10.0 * self.n) * max(k, 1)
        x = gather_vector(subs, [x.data for x in xs], self.n)
        st.fexcept_arrays = [x]
        if not st.converged and raise_on_divergence:
            raise NotConvergedError(
                f"{k} iterations, residual {st.rnrm2:.3e} > {res_tol:.3e}")
        return x


# -- batched/block eager oracles (the ground-truth parity targets) --------

def host_batched_cg(A, B, x0=None, criteria: StoppingCriteria | None = None
                    ) -> tuple:
    """Eager f64 multi-RHS twin of the batched device tier: the classic
    recurrence run per column (a plain numpy loop: no fusion, no masks),
    the parity target of the batched solvers.  Returns ``(X,
    niterations, rnrm2)`` with per-RHS arrays."""
    crit = criteria or StoppingCriteria()
    A = as_csr(A)
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    n, nrhs = B.shape
    X = (np.zeros((n, nrhs)) if x0 is None
         else np.array(x0, dtype=np.float64, copy=True))
    iters = np.zeros(nrhs, dtype=np.int64)
    rn = np.zeros(nrhs)
    for j in range(nrhs):
        x = X[:, j].copy()
        r = B[:, j] - A @ x
        p = r.copy()
        gamma = float(r @ r)
        res_tol = max(crit.residual_atol,
                      crit.residual_rtol * np.sqrt(gamma))
        k = 0
        while (crit.unbounded or gamma >= res_tol * res_tol) \
                and k < crit.maxits:
            t = A @ p
            alpha = gamma / float(p @ t)
            x += alpha * p
            r -= alpha * t
            gamma_next = float(r @ r)
            beta = gamma_next / gamma
            gamma = gamma_next
            p = r + beta * p
            k += 1
        X[:, j] = x
        iters[j] = k
        rn[j] = np.sqrt(gamma)
    return X, iters, rn


def host_block_cg(A, B, x0=None, criteria: StoppingCriteria | None = None
                  ) -> tuple:
    """Eager f64 block-CG oracle (O'Leary 1980): one shared Krylov block,
    B x B Gram solves per iteration, rank deflation by relative Tikhonov
    jitter -- the recurrence of the device block tier
    (:mod:`acg_tpu_torch.solvers.batched`) in plain numpy.  Returns
    ``(X, niterations, rnrm2, block_iterations)``."""
    crit = criteria or StoppingCriteria()
    A = as_csr(A)
    B = np.asarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    n, nrhs = B.shape
    X = (np.zeros((n, nrhs)) if x0 is None
         else np.array(x0, dtype=np.float64, copy=True))
    eps = np.finfo(np.float64).eps

    def deflated_solve(M, G):
        tr = np.trace(M) / M.shape[0]
        jitter = 64.0 * eps * max(abs(tr), eps)
        return np.linalg.solve(M + jitter * np.eye(M.shape[0]), G)

    R = B - A @ X
    rr = np.einsum("nb,nb->b", R, R)
    res_tol = np.maximum(crit.residual_atol,
                         crit.residual_rtol * np.sqrt(rr))
    done = (np.zeros(nrhs, bool) if crit.unbounded
            else rr < res_tol * res_tol)
    iters = np.zeros(nrhs, dtype=np.int64)
    P = R.copy()
    G = R.T @ R
    k = 0
    while k < crit.maxits and not done.all():
        Q = A @ P
        W = P.T @ Q
        alpha = deflated_solve(W, G)
        X = X + P @ alpha
        R = R - Q @ alpha
        rr = np.einsum("nb,nb->b", R, R)
        iters += (~done).astype(np.int64)
        if not crit.unbounded:
            done = done | (~done & (rr < res_tol * res_tol))
        G_new = R.T @ R
        beta = deflated_solve(G, G_new)
        P = R + P @ beta
        G = G_new
        k += 1
    return X, iters, np.sqrt(rr), k
