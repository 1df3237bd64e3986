"""The decision observatory: a cost-model planner over the port's
programs (``--plan [FILE]``, ``--autotune``).

The counterpart of ``acg_tpu/planner.py``.  It enumerates the programs
the port can run for one problem -- classic, pipelined, ``sstep:S`` and
``pipelined:L`` recurrences x ``auto``/``fused`` kernels x ``xla``/
``dma`` halo transports x preconditioners x assembled/matrix-free
operands -- prunes the ones the CLI would refuse with a typed reason,
and ranks the rest by predicted seconds a solve:

    (per-iteration device traffic over the probed triad bandwidth
     + per-iteration communication from the calibration's alpha-beta
       fits over the recurrence's reduction schedule and the
       partition's halo plane) x (iterations from the Lanczos-kappa CG
       bound, adjusted per recurrence)
    + the per-solve dispatch [+ the per-iteration dispatch]

The candidate labels, the refusal reasons and the iteration model are
the reference's arithmetic: given the same calibration, kappa,
bandwidth and per-solve dispatch, :func:`build_plan` ranks the same
labels in the same order with the same prices.  Three inputs are the
port's own.  ``iter_dispatch_s`` prices the launches the port pays on
every iteration: for each recurrence (on stacked parts, each recurrence
and halo transport), the dispatches one iteration of its program counts
on this problem (kernels ``auto``, no preconditioner) times the
measured launch latency (:mod:`acg_tpu_torch.perfmodel`) -- an s-step
iteration dispatches about twice a classic one.  On stacked parts the
reduction rounds' and halo exchanges' own dispatches
(``comm_launches``) are left out of it and billed once, in the comm
term: a calibration's alpha holds them; without one, alpha is that many
launches (``launch_s`` each) and 1/beta the probed bandwidth, where the
reference used TPU stand-in constants.  Such plans are marked
``uncalibrated`` as the reference marks them.

Every planned solve records plan-vs-actual in its ``plan:`` stats
section and the ``--history`` ledger, and a later plan for the same
(matrix, parts, calibration) key rescales its prices by the geometric
mean of the measured/predicted ratios (self-correction).  Building a
plan touches no solve program; ``--autotune`` only rewrites the parsed
flags before the ordinary construction runs.
"""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np

PLAN_SCHEMA = "acg-tpu-plan/1"

ALGORITHMS = ("classic", "pipelined", "sstep:2", "sstep:4", "sstep:8",
              "pipelined:1", "pipelined:2", "pipelined:3")
KERNEL_CHOICES = ("auto", "fused")
COMM_CHOICES = ("xla", "dma")
CHEBY_DEGREES = (2, 4, 8)

# the iteration-count penalties of a longer basis (the reference's
# constants; plan-vs-actual self-correction rescales the prices)
SSTEP_MONOMIAL_PENALTY = 0.015   # x (1 + c * S^2)
SSTEP_CHEBY_PENALTY = 0.02      # x (1 + c * S)
PL_PENALTY = 0.03               # x (1 + c * L)
PIPELINED_PENALTY = 0.05
JACOBI_KAPPA_FACTOR = 0.6
BJACOBI_KAPPA_FACTOR = 0.5

CORRECTION_WINDOW = 8
SSTEP_EXTRA_PASSES = 4


# -- candidate enumeration -------------------------------------------------

def _precond_choices(precond) -> list:
    """``none`` and the requested preconditioner (cheby: each degree of
    :data:`CHEBY_DEGREES`)."""
    choices = ["none"]
    if precond in (None, "", "none"):
        return choices
    p = str(precond)
    if p.startswith("cheby"):
        choices.extend(f"cheby:{k}" for k in CHEBY_DEGREES)
    else:
        choices.append(p)
    return choices


def fused_refusal(pc: str, dtype_name: str | None) -> tuple | None:
    """The fused cell's refusal, or None: the fused kernels have no
    preconditioner hook, and single-device ``--kernels fused`` follows
    :func:`acg_tpu_torch.ops.kernels.fused_cg_route`, which takes f32,
    mixed and bf16 and refuses f64 (K3/K4 are f32-accumulated)."""
    if pc != "none":
        return ("fused-precond", "the fused two-phase kernels have no "
                                 "preconditioner hook")
    if dtype_name in ("f64", "float64"):
        return ("fused-f64", "the fused kernels K3/K4 run f32, mixed "
                             "and bf16 (fused_cg_route refuses f64)")
    return None


def enumerate_candidates(nparts: int, precond=None, cal: dict | None = None,
                         operator_armed: bool = False,
                         kernels=KERNEL_CHOICES, comms=COMM_CHOICES,
                         dtype_name: str | None = None
                         ) -> tuple[list, list]:
    """``(candidates, pruned)`` over the program space; every pruned
    cell carries a typed reason (the CLI's refusals)."""
    from acg_tpu_torch.recurrence import parse_algorithm

    cal_kinds = (cal or {}).get("collectives", {})
    dma_fitted = isinstance(cal_kinds.get("dma"), dict) \
        and "alpha_s" in cal_kinds["dma"]
    candidates, pruned = [], []
    for alg in ALGORITHMS:
        spec = parse_algorithm(alg)
        ca = spec is not None and spec.communication_avoiding
        for kern in kernels:
            for comm in comms:
                for pc in _precond_choices(precond):
                    for matfree in ((False, True) if operator_armed
                                    else (False,)):
                        cand = {"algorithm": alg, "kernels": kern,
                                "comm": comm, "precond": pc,
                                "matrix_free": bool(matfree)}
                        reason = None
                        if ca and pc != "none":
                            reason = ("ca-precond", "the CA recurrences "
                                      "run unpreconditioned (the CLI "
                                      "--algorithm refusal)")
                        elif ca and kern == "fused":
                            reason = ("ca-fused", "--algorithm x "
                                      "--kernels fused is refused by "
                                      "the CLI")
                        elif kern == "fused" and (fr := fused_refusal(
                                pc, dtype_name if nparts < 2 else None)):
                            reason = fr
                        elif comm == "dma" and nparts < 2:
                            reason = ("dma-single-part", "the one-sided "
                                      "transport needs a multi-part "
                                      "mesh")
                        elif comm == "dma" and not dma_fitted:
                            reason = ("dma-unbenchmarked", "no dma fit "
                                      "in the calibration; the planner "
                                      "will not price a transport it "
                                      "cannot predict")
                        elif operator_armed and not matfree:
                            reason = ("assembled-bypassed", "--operator "
                                      "is armed; the dispatched "
                                      "programs are matrix-free")
                        if reason is not None:
                            pruned.append({**cand, "reason": reason[0],
                                           "detail": reason[1]})
                        else:
                            candidates.append(cand)
    return candidates, pruned


def candidate_label(cand: dict) -> str:
    tag = "matfree" if cand.get("matrix_free") else "assembled"
    return (f"{cand['algorithm']}/{cand['kernels']}/{cand['comm']}/"
            f"{cand['precond']}/{tag}")


# -- static problem measurements ------------------------------------------

def halo_plane_rows(csr, nparts: int) -> int:
    """Ghost rows of the widest part under the contiguous band
    partition: the halo plane an exchange moves, in rows."""
    n = int(csr.shape[0])
    p = max(int(nparts), 1)
    if p < 2:
        return 0
    bounds = [round(i * n / p) for i in range(p + 1)]
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    worst = 0
    for i in range(p):
        lo, hi = bounds[i], bounds[i + 1]
        cols = indices[indptr[lo]:indptr[hi]]
        ghost = np.unique(cols[(cols < lo) | (cols >= hi)])
        worst = max(worst, int(ghost.size))
    return worst


def kappa_estimate(csr, rtol: float, maxits: int,
                   precond=None) -> tuple:
    """``(kappa, source)`` from a traced host-oracle solve and its
    Lanczos tridiagonal (the ``--explain`` convergence estimator), size
    guarded as there."""
    if csr.shape[0] > 200_000 or csr.nnz > 2_000_000:
        return None, "unavailable (matrix too large for the " \
                     "host-oracle Lanczos estimate)"
    from acg_tpu_torch import health
    from acg_tpu_torch.solvers.host_cg import HostCGSolver
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    rt = rtol if 0 < rtol < 1 else 1e-9
    crit = StoppingCriteria(maxits=min(max(int(maxits), 200), 2000),
                            residual_rtol=rt)
    try:
        hs = HostCGSolver(csr, trace=4096, precond=precond)
        hs.solve(np.ones(csr.shape[0]), criteria=crit,
                 raise_on_divergence=False)
        est = health.spectrum_estimate(hs.last_trace)
    except Exception as e:  # noqa: BLE001 -- the plan degrades, never sinks
        return None, f"unavailable ({type(e).__name__})"
    kappa = (est or {}).get("kappa")
    if not kappa or kappa <= 0:
        return None, "unavailable (non-positive Ritz value)"
    return float(kappa), "lanczos-oracle"


# -- pricing ---------------------------------------------------------------

def _fit_or_fallback(ctx: dict, kind: str,
                     launches: float = 1.0) -> tuple[dict, bool]:
    """The calibration's fit of one kind, or the uncalibrated price from
    the device's figures: alpha ``launches`` launch latencies (the
    dispatches one round of the kind counts), 1/beta the probed
    bandwidth (the card's memory rate when the probe failed)."""
    from acg_tpu_torch.perfmodel import HBM_BYTES_S

    fit = (ctx.get("cal") or {}).get("collectives", {}).get(kind)
    if isinstance(fit, dict) and "alpha_s" in fit:
        return fit, True
    gbs = ctx.get("bw_gbs") or HBM_BYTES_S / 1e9
    return {"alpha_s": float(launches) * float(ctx.get("launch_s") or 0.0),
            "beta_s_per_byte": 1.0 / (gbs * 1e9)}, False


def _iter_dispatch(ctx: dict, cand: dict) -> float:
    """Seconds of dispatch an iteration of ``cand`` outside its comm:
    the figure of its recurrence and transport, else of its recurrence,
    else classic's."""
    idisp = ctx.get("iter_dispatch_s") or {}
    alg, comm = cand["algorithm"], cand["comm"]
    for key in (f"{alg}/{comm}", alg, f"classic/{comm}", "classic"):
        if key in idisp:
            return float(idisp[key])
    return 0.0


def _iterations_for(cand: dict, kappa, rtol: float, maxits: int) -> tuple:
    """``(predicted_iterations, kappa_effective)``: the CG bound at the
    preconditioner's compressed kappa, inflated by the recurrence's
    penalty."""
    from acg_tpu_torch.health import predicted_iterations
    from acg_tpu_torch.recurrence import parse_algorithm

    pc = cand["precond"]
    keff = kappa
    if keff is not None:
        if pc == "jacobi":
            keff = keff * JACOBI_KAPPA_FACTOR
        elif pc.startswith("bjacobi"):
            keff = keff * BJACOBI_KAPPA_FACTOR
        elif pc.startswith("cheby:"):
            deg = int(pc.split(":", 1)[1])
            keff = max(keff / float(deg * deg), 1.0 + 1e-9)
    base = predicted_iterations(keff, rtol) if keff else None
    if base is None:
        base = int(maxits)
    spec = parse_algorithm(cand["algorithm"])
    mult = 1.0
    if spec is not None and spec.kind == "sstep":
        mult = (1.0 + SSTEP_CHEBY_PENALTY * spec.param
                if spec.basis == "chebyshev"
                else 1.0 + SSTEP_MONOMIAL_PENALTY * spec.param ** 2)
    elif spec is not None and spec.kind == "pl":
        mult = 1.0 + PL_PENALTY * spec.param
    elif cand["algorithm"] == "pipelined":
        mult = 1.0 + PIPELINED_PENALTY
    its = max(1, min(int(math.ceil(base * mult)), int(maxits)))
    return its, keff


def price_candidate(cand: dict, ctx: dict) -> dict:
    """One candidate's predicted cost: ``ctx`` holds the problem's
    sizes, the probed constants, the calibration and the convergence
    inputs."""
    from acg_tpu_torch.commbench import predict_seconds
    from acg_tpu_torch.perfmodel import HBM_BYTES_S
    from acg_tpu_torch.recurrence import parse_algorithm, reduction_schedule

    n, nnz = int(ctx["n"]), int(ctx["nnz"])
    vec_b = int(ctx["vec_itemsize"])
    spec = parse_algorithm(cand["algorithm"])
    pipelined = cand["algorithm"] == "pipelined"
    pc = cand["precond"]
    schedule = reduction_schedule(spec, pipelined, precond=pc != "none")
    its, keff = _iterations_for(cand, ctx.get("kappa"), ctx["rtol"],
                                ctx["maxits"])

    mat_bytes = 0.0 if cand["matrix_free"] \
        else nnz * (ctx["mat_itemsize"] + ctx["idx_bytes"])
    spmv_mult = float(schedule.get("spmv_per_iteration", 1.0))
    passes = 21 if (pipelined or (spec is not None
                                  and spec.kind == "pl")) else 15
    if spec is not None and spec.kind == "sstep":
        passes += SSTEP_EXTRA_PASSES
    hbm_bytes = mat_bytes * spmv_mult + passes * n * vec_b
    halo_exchanges = spmv_mult
    if pc != "none":
        from acg_tpu_torch.precond import bytes_per_apply, parse_precond
        pspec = parse_precond(pc)
        hbm_bytes += bytes_per_apply(pspec, n, vec_b, mat_bytes,
                                     state_bytes=float(n * vec_b))
        if pspec.kind == "cheby":
            halo_exchanges += pspec.degree
    bw = ctx.get("bw_gbs") or HBM_BYTES_S / 1e9
    t_hbm = hbm_bytes / (bw * 1e9)

    t_ar = t_halo = 0.0
    nparts = int(ctx["nparts"])
    calibrated = True
    rounds = ctx.get("comm_launches") or {}
    if nparts > 1:
        ar_fit, ar_cal = _fit_or_fallback(ctx, "all_reduce",
                                          rounds.get("reduction", 1.0))
        nred = float(schedule.get("allreduce_per_iteration", 0.0))
        scalars = float(schedule.get("allreduce_scalars", 1))
        t_ar = nred * float(predict_seconds(ar_fit, scalars * vec_b))
        hidden = float(schedule.get("reduction_latency_hidden", 0) or 0)
        if hidden > 0:
            # p(l): the window reduction overlaps L SpMVs
            t_ar = max(0.0, t_ar - hidden * mat_bytes / (bw * 1e9))
        halo_kind = "dma" if cand["comm"] == "dma" else "all_to_all"
        halo_fit, halo_cal = _fit_or_fallback(
            ctx, halo_kind, rounds.get(cand["comm"], 1.0))
        halo_bytes = float(ctx.get("halo_rows", 0)) * vec_b
        t_one = float(predict_seconds(halo_fit, halo_bytes))
        if cand["kernels"] == "fused":
            # the fused tier hides the halo behind the interior SpMV
            t_int = (mat_bytes / nparts) / (bw * 1e9)
            t_one = max(0.0, t_one - t_int)
        t_halo = t_one * halo_exchanges
        calibrated = ar_cal and halo_cal
    t_comm = t_ar + t_halo
    t_iter = t_hbm + t_comm
    disp = float(ctx.get("dispatch_s") or 0.0)
    iter_disp = _iter_dispatch(ctx, cand)
    total = its * (t_iter + iter_disp) + disp
    comp = {"hbm": its * t_hbm, "comm": its * t_comm,
            "dispatch": disp + its * iter_disp}
    dominant = max(comp, key=lambda k: comp[k])
    return {
        **cand,
        "label": candidate_label(cand),
        "predicted_iterations": int(its),
        "kappa_effective": (round(float(keff), 6)
                            if keff is not None else None),
        "s_per_iteration": {"hbm": t_hbm, "allreduce": t_ar,
                            "halo": t_halo},
        "components_s": comp,
        "dominant": dominant,
        "predicted_s_per_solve": float(total),
        "calibrated": bool(calibrated),
    }


# -- plan-vs-actual self-correction ---------------------------------------

def plan_key(matrix_id, nparts, calibration) -> str:
    """The self-correction join key: the same matrix on the same parts
    under the same calibration."""
    return f"{matrix_id}|{int(nparts)}p|{calibration}"


def consult_history(history_dir, matrix_id, nparts,
                    calibration) -> dict:
    """``{"scale", "nsamples"}``: the geometric mean of measured /
    predicted seconds a solve over the last :data:`CORRECTION_WINDOW`
    plan-vs-actual rows of the ``--history`` ledger under the same key
    (scale 1.0 when there are none)."""
    out = {"scale": 1.0, "nsamples": 0}
    if not history_dir:
        return out
    from acg_tpu_torch import observatory

    key = plan_key(matrix_id, nparts, calibration)
    ratios = []
    for entry in observatory.history_scan(history_dir):
        doc = entry.get("doc") or {}
        plan = ((doc.get("stats") or {}).get("plan")) or {}
        if plan.get("key") != key:
            continue
        try:
            pred = float(plan.get("predicted_s_per_solve"))
            meas = float(plan.get("measured_s_per_solve"))
        except (TypeError, ValueError):
            continue
        if pred > 0 and meas > 0 and math.isfinite(pred) \
                and math.isfinite(meas):
            ratios.append(meas / pred)
    ratios = ratios[-CORRECTION_WINDOW:]
    if ratios:
        out["scale"] = float(math.exp(
            sum(math.log(r) for r in ratios) / len(ratios)))
        out["nsamples"] = len(ratios)
    return out


# -- the ranked plan document ---------------------------------------------

def plan_id(doc: dict) -> str:
    """Content-hashed plan id (the reference's hash)."""
    payload = {k: v for k, v in doc.items() if k != "plan_id"}
    h = hashlib.sha256(json.dumps(payload, sort_keys=True,
                                  default=str).encode()).hexdigest()
    return (f"plan-{doc.get('backend', 'x')}-"
            f"{int(doc.get('nparts', 0))}p-{h[:10]}")


def build_plan(csr, *, matrix_id, nparts, dtype_name, rtol, maxits,
               mat_itemsize, vec_itemsize, idx_bytes=4.0,
               precond=None, cal=None, kappa=None,
               kappa_source="unavailable", bw_gbs=None,
               dispatch_s=None, history_dir=None, backend="cpu",
               operator_armed=False, kernels=KERNEL_CHOICES,
               comms=COMM_CHOICES, launch_s=None, iter_dispatch_s=None,
               comm_launches=None) -> dict:
    """Price the candidate space of one problem and return the ranked
    ``acg-tpu-plan/1`` document.  Host arithmetic only: the same inputs
    give the same document.  The port's inputs (``launch_s``,
    ``iter_dispatch_s``, ``comm_launches``) enter the document only when
    given, so without them the document is the reference's.
    ``iter_dispatch_s`` maps a recurrence (``"sstep:4"``), or a
    recurrence and transport (``"sstep:4/dma"``), to its seconds of
    dispatch an iteration outside the comm; ``comm_launches`` holds the
    dispatches of one reduction round (``"reduction"``) and of one halo
    exchange under each transport (``"xla"``, ``"dma"``)
    (:func:`dispatch_by_recurrence`)."""
    from acg_tpu_torch.commbench import UNCALIBRATED

    cal_id = (cal or {}).get("calibration_id") or UNCALIBRATED
    candidates, pruned = enumerate_candidates(
        nparts, precond=precond, cal=cal,
        operator_armed=operator_armed, kernels=kernels, comms=comms,
        dtype_name=dtype_name)
    correction = consult_history(history_dir, matrix_id, nparts, cal_id)
    ctx = {"n": int(csr.shape[0]), "nnz": int(csr.nnz),
           "mat_itemsize": float(mat_itemsize),
           "vec_itemsize": int(vec_itemsize),
           "idx_bytes": float(idx_bytes),
           "halo_rows": halo_plane_rows(csr, nparts),
           "nparts": int(nparts), "cal": cal, "kappa": kappa,
           "rtol": float(rtol), "maxits": int(maxits),
           "bw_gbs": bw_gbs, "dispatch_s": dispatch_s,
           "launch_s": launch_s, "iter_dispatch_s": iter_dispatch_s,
           "comm_launches": comm_launches}
    ranked = [price_candidate(c, ctx) for c in candidates]
    scale = float(correction["scale"])
    for row in ranked:
        row["predicted_s_per_solve"] = \
            row["predicted_s_per_solve"] * scale
        row["components_s"] = {k: v * scale
                               for k, v in row["components_s"].items()}
    ranked.sort(key=lambda r: (r["predicted_s_per_solve"], r["label"]))
    doc = {
        "schema": PLAN_SCHEMA,
        "matrix": str(matrix_id),
        "nparts": int(nparts),
        "dtype": str(dtype_name),
        "rtol": float(rtol),
        "maxits": int(maxits),
        "backend": str(backend),
        "calibration": cal_id,
        "uncalibrated": cal is None,
        "kappa": (round(float(kappa), 6) if kappa else None),
        "kappa_source": str(kappa_source),
        "bw_gbs": (round(float(bw_gbs), 3) if bw_gbs else None),
        "dispatch_s": (float(dispatch_s) if dispatch_s else None),
        "halo_plane_rows": int(ctx["halo_rows"]),
        "correction": {"scale": round(scale, 6),
                       "nsamples": int(correction["nsamples"]),
                       "key": plan_key(matrix_id, nparts, cal_id)},
        "ranked": ranked,
        "pruned": pruned,
    }
    if launch_s:
        doc["launch_s"] = float(launch_s)
    for k in ("iter_dispatch_s", "comm_launches"):
        if ctx[k]:
            doc[k] = {key: float(v) for key, v in ctx[k].items()}
    doc["plan_id"] = plan_id(doc)
    return doc


def validate_plan(doc) -> list[str]:
    """Problems with a plan document (empty = valid): schema, id
    integrity, a sorted non-empty ranking of finite predictions, typed
    reasons on every pruned cell, the calibration provenance."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != PLAN_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, expected "
                        f"{PLAN_SCHEMA!r}")
        return problems
    pid = doc.get("plan_id")
    if not isinstance(pid, str) or not pid:
        problems.append("missing plan_id")
    elif pid != plan_id(doc):
        problems.append("plan_id does not match the document content "
                        "(edited after planning?)")
    ranked = doc.get("ranked")
    if not isinstance(ranked, list) or not ranked:
        problems.append("empty ranking")
        return problems
    for row in ranked:
        if not isinstance(row, dict):
            problems.append(f"bad ranked row {row!r}")
            break
        t = row.get("predicted_s_per_solve")
        if not isinstance(t, (int, float)) or not math.isfinite(t) \
                or t < 0:
            problems.append(f"{row.get('label')}: non-finite "
                            f"prediction {t!r}")
            break
    times = [r.get("predicted_s_per_solve", 0) for r in ranked
             if isinstance(r, dict)]
    if times != sorted(times):
        problems.append("ranking is not sorted by predicted time")
    for cell in doc.get("pruned") or []:
        if not isinstance(cell, dict) or not cell.get("reason"):
            problems.append(f"pruned cell without a typed reason: "
                            f"{cell!r}")
            break
    if not isinstance(doc.get("calibration"), str):
        problems.append("missing calibration provenance")
    return problems


def render_plan(doc: dict, limit: int = 12) -> str:
    """The ranked table (``--explain --plan``, ``--autotune``)."""
    lines = [f"== plan: {doc['matrix']} on {doc['nparts']} part(s), "
             f"{doc['dtype']}, rtol {doc['rtol']:g} ==",
             f"  plan {doc['plan_id']}; calibration "
             f"{doc['calibration']}"
             + ("  ** UNCALIBRATED: comm priced from the device's own "
                "figures **" if doc.get("uncalibrated") else ""),
             "  kappa "
             + (f"{doc['kappa']:.4g} ({doc['kappa_source']})"
                if doc.get("kappa") else f"{doc['kappa_source']}")
             + (f"; correction x{doc['correction']['scale']:.3f} over "
                f"{doc['correction']['nsamples']} prior run(s)"
                if doc["correction"]["nsamples"] else
                "; no prior plan-vs-actual rows (correction x1.000)")]
    idisp = doc.get("iter_dispatch_s")
    if idisp:
        lines.append("  dispatch an iteration outside the comm (counted "
                     "launches x launch latency): " + ", ".join(
                         f"{k} {v:.3e} s" for k, v in idisp.items()))
    lines.append(f"  {'#':>2}  {'candidate':<42} {'pred s/solve':>12} "
                 f"{'iters':>6}  dominant")
    for i, row in enumerate(doc["ranked"][:limit], 1):
        lines.append(f"  {i:>2}  {row['label']:<42} "
                     f"{row['predicted_s_per_solve']:>12.3e} "
                     f"{row['predicted_iterations']:>6}  "
                     f"{row['dominant']}")
    extra = len(doc["ranked"]) - limit
    if extra > 0:
        lines.append(f"  ... {extra} more candidate(s)")
    if doc.get("pruned"):
        reasons: dict[str, int] = {}
        for cell in doc["pruned"]:
            reasons[cell["reason"]] = reasons.get(cell["reason"], 0) + 1
        pr = ", ".join(f"{k} x{v}" for k, v in sorted(reasons.items()))
        lines.append(f"  pruned {len(doc['pruned'])} cell(s): {pr}")
    return "\n".join(lines) + "\n"


def write_plan(doc: dict, dest) -> None:
    """Write the plan to a path (``"-"``: stdout)."""
    import sys
    if dest in (None, "-"):
        json.dump(doc, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return
    with open(dest, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


# -- CLI integration -------------------------------------------------------

def _operand(csr, part, nparts, dtype, vec_dtype, device):
    """What every candidate of this problem runs on: the stacked parts'
    problem (``nparts > 1``) or the device matrix, built once."""
    if nparts > 1:
        from acg_tpu_torch.parallel.dist import DistributedProblem
        return DistributedProblem.build(csr, part, nparts, dtype=dtype,
                                        vector_dtype=vec_dtype)
    from acg_tpu_torch.ops.spmv import device_matrix_from_csr
    return device_matrix_from_csr(csr, dtype=dtype, device=device)


def _build_candidate(cand: dict, operand, csr, vec_dtype, device):
    """The solver the CLI would build for ``cand`` over ``operand``
    (:func:`_operand`; a matrix-free cell probes its assembled twin, as
    the reference's probe does)."""
    from acg_tpu_torch.precond import parse_precond
    from acg_tpu_torch.recurrence import parse_algorithm

    spec = parse_algorithm(cand["algorithm"])
    pipelined = cand["algorithm"] == "pipelined"
    algorithm = spec if spec is not None \
        and spec.communication_avoiding else None
    pc = parse_precond(None if cand["precond"] == "none"
                       else cand["precond"])
    if getattr(operand, "nparts", None) is not None:
        from acg_tpu_torch.parallel.dist import DistCGSolver, resolve_comm
        return DistCGSolver(operand, pipelined=pipelined,
                            comm=resolve_comm(cand["comm"]),
                            kernels=cand["kernels"], precond=pc,
                            algorithm=algorithm, device=device)
    from acg_tpu_torch.solvers.cg import TorchCGSolver
    return TorchCGSolver(operand, pipelined=pipelined, kernels=cand["kernels"],
                         vector_dtype=vec_dtype, precond=pc,
                         algorithm=algorithm, host_matrix=csr,
                         device=device)


def dispatch_by_recurrence(operand, csr, vec_dtype, device, launch_s,
                           flag_s, comms=COMM_CHOICES) -> tuple:
    """``(iter_dispatch_s, comm_launches)`` of this problem (see
    :func:`build_plan`).  An iteration's dispatch seconds are its
    program's counted dispatches
    (:func:`acg_tpu_torch.perfmodel.count_dispatches`; kernels ``auto``,
    no preconditioner) times the launch latency, plus the flag read over
    a chunk: for each recurrence of :data:`ALGORITHMS`, and on stacked
    parts for each recurrence and transport, less the dispatches of the
    iteration's reduction rounds and halo exchanges
    (:func:`acg_tpu_torch.commbench.comm_round_dispatches`, which
    ``comm_launches`` records), so the comm term bills them once.  A
    recurrence the tier refuses, or whose counting solve ends in a typed
    solver outcome, is left out (it prices at the classic figure); on a
    CUDA device any other error raises."""
    import torch

    from acg_tpu_torch import commbench, perfmodel
    from acg_tpu_torch.recurrence import parse_algorithm, reduction_schedule

    on_cuda = torch.device(device).type == "cuda"
    stacked = getattr(operand, "nparts", None) is not None
    b = np.ones(csr.shape[0])

    def cand(alg, comm):
        return {"algorithm": alg, "kernels": "auto", "comm": comm,
                "precond": "none", "matrix_free": False}

    rounds = None
    if stacked:
        rounds = {}
        for comm in comms:
            got = commbench.comm_round_dispatches(
                _build_candidate(cand("classic", comm), operand, csr,
                                 vec_dtype, device), b)
            rounds["reduction"] = float(got["reduction"])
            rounds[comm] = float(got.get("halo", 0))
    out = {}
    for alg in ALGORITHMS:
        for comm in (comms if stacked else ("xla",)):
            try:
                s = _build_candidate(cand(alg, comm), operand, csr,
                                     vec_dtype, device)
            except _refusals():
                continue
            try:
                counted = perfmodel.count_dispatches(s, b)
            except _solver_outcomes():
                continue
            except Exception:
                if on_cuda:
                    raise
                continue
            if not stacked:
                out[alg] = perfmodel.dispatch_seconds(counted, launch_s,
                                                      flag_s)
                continue
            sched = reduction_schedule(parse_algorithm(alg),
                                       alg == "pipelined")
            in_comm = (float(sched["allreduce_per_iteration"])
                       * rounds["reduction"]
                       + float(sched.get("spmv_per_iteration", 1.0))
                       * rounds[comm])
            rest = dict(counted, dispatches_per_iteration=max(
                counted["dispatches_per_iteration"] - in_comm, 0.0))
            out[f"{alg}/{comm}"] = perfmodel.dispatch_seconds(
                rest, launch_s, flag_s)
    return out, rounds


def _probe_constants(device, use_cache: bool = True) -> dict:
    """The measured constants of a plan on ``device``: the triad
    bandwidth (behind the probe cache), the launch latency and the flag
    read.  A failed bandwidth probe leaves None (the card's memory rate
    prices instead)."""
    import torch

    from acg_tpu_torch import perfmodel

    device = torch.device(device)
    bw = None
    try:
        bw = (perfmodel.cached_triad_probe_gbs(use_cache=use_cache,
                                               device=device)
              if device.type == "cuda" else
              perfmodel.cached_triad_probe_gbs(1 << 22, use_cache=use_cache,
                                               lo=0.5, device=device))
    except RuntimeError:
        pass
    return {"bw_gbs": bw,
            "launch_s": perfmodel.launch_latency_seconds(device),
            "flag_s": perfmodel.flag_read_seconds(device)}


def plan_for_args(args, csr, nparts, dtype, vec_dtype, device,
                  part=None) -> dict:
    """The plan of one CLI invocation (``--plan``/``--autotune``): the
    probed constants, each recurrence's dispatch an iteration on this
    problem (:func:`dispatch_by_recurrence`), kappa, the calibration and
    the ledger."""
    import torch

    device = torch.device(device)
    k = _probe_constants(device,
                         use_cache=not getattr(args, "no_probe_cache",
                                               False))
    if part is None:
        from acg_tpu_torch.partition import partition_rows
        part = partition_rows(csr, nparts, seed=args.seed, method="band")
    iter_disp, rounds = dispatch_by_recurrence(
        _operand(csr, part, nparts, dtype, vec_dtype, device), csr,
        vec_dtype, device, k["launch_s"], k["flag_s"])
    kappa, source = kappa_estimate(csr, args.residual_rtol,
                                   args.max_iterations)
    pc = getattr(args, "_precond", None)
    return build_plan(
        csr, matrix_id=str(args.A), nparts=int(nparts),
        dtype_name=str(args.dtype), rtol=float(args.residual_rtol),
        maxits=int(args.max_iterations),
        mat_itemsize=torch.empty((), dtype=dtype).element_size(),
        vec_itemsize=torch.empty((), dtype=vec_dtype).element_size(),
        precond=(str(pc) if pc is not None else None),
        cal=getattr(args, "_calibration", None),
        kappa=kappa, kappa_source=source, bw_gbs=k["bw_gbs"],
        dispatch_s=k["flag_s"], history_dir=getattr(args, "history", None),
        backend=device.type,
        operator_armed=getattr(args, "_operator_spec", None) is not None,
        launch_s=k["launch_s"], iter_dispatch_s=iter_disp,
        comm_launches=rounds)


def run_plan_explain(args, dtype, vec_dtype, device) -> int:
    """``--explain --plan``: print the ranked table without solving, and
    write the document when ``--plan`` names a file."""
    import sys

    from acg_tpu_torch.commbench import visible_parts
    from acg_tpu_torch.perfmodel import explain_matrix

    csr = explain_matrix(args)
    nparts = args.nparts or visible_parts(device, 4)
    doc = plan_for_args(args, csr, nparts, dtype, vec_dtype, device)
    sys.stderr.write(render_plan(doc))
    if args.plan not in (None, "-"):
        try:
            write_plan(doc, args.plan)
        except OSError as e:
            sys.stderr.write(f"acg-tpu-torch: --plan {args.plan}: {e}\n")
            return 1
    return 0


def apply_candidate_to_args(args, cand: dict) -> str:
    """Rewrite the parsed flags so the ordinary construction dispatches
    ``cand``; returns its halo transport."""
    from acg_tpu_torch.precond import parse_precond
    from acg_tpu_torch.recurrence import parse_algorithm

    alg = cand["algorithm"]
    spec = parse_algorithm(alg)
    if spec is not None and spec.communication_avoiding:
        args.solver = "acg"
        args._algorithm = spec
    else:
        args.solver = "acg-pipelined" if alg == "pipelined" else "acg"
        args._algorithm = None
    args.kernels = cand["kernels"]
    args._precond = parse_precond(None if cand["precond"] == "none"
                                  else cand["precond"])
    args.comm = cand["comm"]
    return cand["comm"]


# what a candidate may end in without failing the run: the tier refuses
# to build it (a ValueError, as the reference's refusals), or its solve
# ends in a typed solver outcome (divergence, breakdown).  A ValueError
# from a solve is a kernel wrapper's refusal to launch, never an outcome.
def _refusals() -> tuple:
    from acg_tpu_torch.errors import AcgError
    return (ValueError, AcgError)


def _solver_outcomes() -> tuple:
    from acg_tpu_torch.errors import (AcgError, BreakdownError,
                                      NotConvergedError)
    return (BreakdownError, NotConvergedError, AcgError)


def autotune_select(args, doc: dict, csr, part, nparts, b, dtype,
                    vec_dtype, device, err, top: int = 2,
                    probe_its: int | None = None, rounds: int = 2,
                    max_probes: int = 8) -> dict | None:
    """Verify the plan's leading candidates by timed probes and return
    the winner's ranked row; None when none survived (the caller then
    dispatches the flag-selected program, with provenance
    ``fallback``).  Down the ranking, at most ``max_probes`` candidates
    are built and run once to the run's tolerance, for at most
    ``probe_its`` iterations (4 chunks by default); a candidate the tier
    refuses to build, or whose probe ends in a typed solver outcome
    (divergence) or breaks down, is disqualified, until ``top`` survive.
    The survivors are timed ``rounds`` times in turns (the min of their
    rounds, seconds an iteration), so load on the host skews them alike.
    On a CUDA device any other error of a probe's solve raises -- a
    kernel wrapper's ValueError among them."""
    import time

    import torch

    from acg_tpu_torch._device import device_sync
    from acg_tpu_torch.solvers.cg import CHUNK
    from acg_tpu_torch.solvers.stats import StoppingCriteria

    device = torch.device(device)
    its = int(probe_its or 4 * CHUNK)
    crit = StoppingCriteria(maxits=its,
                            residual_rtol=float(args.residual_rtol))
    operand = _operand(csr, part, nparts, dtype, vec_dtype, device)
    live = []
    for row in doc["ranked"][:max(int(max_probes), 1)]:
        if len(live) >= max(int(top), 1):
            break
        why = None
        try:
            s = _build_candidate(row, operand, csr, vec_dtype, device)
        except _refusals() as e:
            why = f"refused: {type(e).__name__}: {e}"
        else:
            try:
                s.solve(b, criteria=crit, host_result=False,
                        raise_on_divergence=False)
                if s.stats.nbreakdowns:
                    why = (f"broke down {s.stats.nbreakdowns} time(s) "
                           f"within {its} iterations")
            except _solver_outcomes() as e:
                why = f"{type(e).__name__}: {e}"
            except Exception:
                if device.type == "cuda":
                    raise
                why = "failed"
        if why is not None:
            err.write(f"acg-tpu-torch: autotune: probe {row['label']} "
                      f"{why}; candidate disqualified\n")
            continue
        live.append([row, s, math.inf])
    for _ in range(max(int(rounds), 1)):
        for entry in live:
            device_sync(device)
            t0 = time.perf_counter()
            entry[1].solve(b, criteria=crit, host_result=False,
                           raise_on_divergence=False)
            device_sync(device)
            per_it = ((time.perf_counter() - t0)
                      / max(int(entry[1].stats.niterations), 1))
            entry[2] = min(entry[2], per_it)
    for row, s, secs in live:
        err.write(f"acg-tpu-torch: autotune: probe {row['label']}: "
                  f"{secs:.4g} s an iteration over "
                  f"{s.stats.niterations} its\n")
    if not live:
        return None
    return min(live, key=lambda e: e[2])[0]
