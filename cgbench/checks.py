"""How ``correct`` is decided: the program's answers against the plain
reference's, at the timed sizes.

Each sampled answer ``x`` (a solve's iterate, gathered whole) is held
against classic CG of :mod:`cgbench.reference` in float64 on the same
right-hand side, run for the same number of iterations:

* ``x_gap_rel``: ``||x - x_ref|| / ||x_ref||``, the widest over the
  samples;
* ``res_rel`` (mixes with a tolerance): ``||b - A x|| / ||b||`` with the
  reference's own stencil, so a solve that stopped early fails;

``checks/<cell>.json`` names the numbers a cell compares and their
limits (and the readings each limit was set from).
"""

from __future__ import annotations

import dataclasses
import math
import sys

import torch

from cgbench import reference

SAMPLES = 2   # answers of the window a run compares, drawn from the seed


@dataclasses.dataclass
class Answer:
    x: torch.Tensor        # the whole iterate
    rhs: int               # index into the mix's pool of right-hand sides
    iterations: int


def numbers(answers: list[Answer], rhs: torch.Tensor, traffic: dict,
            n: int, dim: int) -> dict:
    """Every number the comparison can give, the widest over ``answers``."""
    out: dict[str, float] = {}
    refs: dict = {}

    def widest(name, v):
        v = float(v)
        if not math.isfinite(v):
            v = math.inf   # a NaN answer is the widest gap, not none
        out[name] = max(out.get(name, 0.0), v)

    for a in answers:
        b = rhs[a.rhs]
        x = a.x.to(torch.float64)
        key = (a.rhs, a.iterations)
        if key not in refs:
            refs[key] = reference.cg(b, n, dim, a.iterations)[0]
        xr = refs[key]
        widest("x_gap_rel", torch.linalg.vector_norm(x - xr)
               / torch.linalg.vector_norm(xr))
        if traffic["rtol"] > 0:
            res = b - reference.stencil_apply(x, n, dim)
            widest("res_rel", torch.linalg.vector_norm(res)
                   / torch.linalg.vector_norm(b))
    return out


def judge(values: dict, checks: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` for the cell's compared
    numbers; a number with no value (nothing sampled) fails."""
    shown = {}
    ok = True
    for name, spec in checks.items():
        v = values.get(name)
        lim = float(spec["limit"])
        ok = ok and v is not None and v <= lim
        if v is not None and not math.isfinite(v):
            v = sys.float_info.max   # JSON has no infinity
        shown[name] = {"value": v, "limit": lim}
    return ok, shown


def control_answers(rhs: torch.Tensor, traffic: dict, n: int, dim: int,
                    which: list[int]) -> list[Answer]:
    """The control: the reference in the program's place, computed in
    float32, the precision below the configuration's float64, under the
    mix's own stopping rule."""
    out = []
    for j in which:
        x, k = reference.cg(rhs[j], n, dim, int(traffic["iterations"]),
                            float(traffic["rtol"]), dtype=torch.float32)
        out.append(Answer(x=x, rhs=j, iterations=k))
    return out
