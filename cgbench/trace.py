"""The reduction of a ``torch.profiler`` capture to one card's figures.

A card's busy time is the union of its own device intervals (kernels,
copies and fills, on every stream, NCCL's included: an NCCL kernel holds
the card while it waits for its peers), clipped to the traced slice.
Host annotations and their device twins are never counted.  Across
cards the busy *share* is averaged, never the seconds summed.

The name patterns below are a frozen copy of ``acg_tpu_torch.tracing``'s
``_HLO_PATTERNS``, ``_KEYWORD_PATTERNS`` and ``_classify_op``, and the
interval algebra one of its ``_union_seconds`` / ``_overlap_seconds`` /
``_subtract_seconds``: later changes to the program cannot move them.
"""

from __future__ import annotations

import bisect
import re

# the annotation that brackets the traced slice on each rank
SLICE = "cgbench:slice"

# -- frozen copy of the program's classifier ----------------------------

_HLO_PATTERNS = (
    ("allreduce", re.compile(
        r"%?(all[-_.]?reduce|reduce[-_.]?scatter)"
        r"([-_.](start|done))?[.\d]*$", re.I)),
    ("halo", re.compile(
        r"%?(all[-_.]?to[-_.]?all|collective[-_.]?permute)"
        r"([-_.](start|done))?[.\d]*$", re.I)),
    ("dot", re.compile(r"%?(dot|gemm|convolution)[.\d]*$", re.I)),
    ("fusion", re.compile(r"%?(loop_|input_|output_)?fusion\.\d+$", re.I)),
    ("copy", re.compile(r"%?(copy|transpose|bitcast)"
                        r"([-_.](start|done))?[.\d]*$", re.I)),
)
_KEYWORD_PATTERNS = (
    ("allreduce", re.compile(r"nccl\w*(AllReduce|AllGather|ReduceScatter)",
                             re.I)),
    ("halo", re.compile(r"halo_put|nccl\w*SendRecv", re.I)),
    ("fusion", re.compile(r"cg_phase_[ab]_kernel|pipelined_update_kernel",
                          re.I)),
    ("dot", re.compile(r"part_dot_kernel|(?<!\w)dot_kernel|"
                       r"reduce_1Block_kernel|at::native::reduce_kernel")),
    ("gemv", re.compile(r"spmv|matvec|gemv", re.I)),
    ("allreduce", re.compile(r"\bpsum\b", re.I)),
    ("halo", re.compile(r"ppermute|halo_exchange", re.I)),
)
_PJIT_RE = re.compile(r"^(?:PjitFunction|jit_?)\(?([^)]*)\)?$")


def classify_op(name: str) -> str | None:
    """The program's op class of a kernel name (frozen copy)."""
    m = _PJIT_RE.match(name)
    if m:
        inner = m.group(1)
        for cls, pat in _HLO_PATTERNS + _KEYWORD_PATTERNS:
            if pat.search(inner):
                return cls
        return "program"
    for cls, pat in _HLO_PATTERNS:
        if pat.fullmatch(name):
            return cls
    for cls, pat in _KEYWORD_PATTERNS:
        if pat.search(name):
            return cls
    return None


# the port's hand-written kernels, by the name CUPTI gives them
_HAND = (("dia_spmv_kernel", "K1 dia_spmv"),
         ("cg_phase_a_kernel", "K3 cg_phase_a"),
         ("cg_phase_b_kernel", "K4 cg_phase_b"),
         ("pipelined_update_kernel", "K5 pipelined_update"),
         ("halo_put", "K6 halo_put"),
         ("stencil_spmv_kernel", "K7 stencil_spmv"),
         ("part_dot_kernel", "part_dot"))
_NCCL = re.compile(r"nccl\w*?_?(AllGather|AllReduce|ReduceScatter|Broadcast|"
                   r"SendRecv|Reduce|Send|Recv)", re.I)
_FUNCTOR = re.compile(r"(\w*Func\w*)")
K1 = "K1 dia_spmv"


def _short(name: str) -> str:
    s = name[5:] if name.startswith("void ") else name
    base = re.split(r"[<(]", s, maxsplit=1)[0].split("::")[-1].strip()
    funcs = _FUNCTOR.findall(name)
    return f"{base}[{funcs[-1]}]" if funcs else base


def label(name: str, kind: str) -> str:
    """The breakdown's class of one device event: the port's kernels by
    number, NCCL by collective, eager ATen by the program's class and
    the kernel's short name."""
    if kind == "memcpy":
        for d in ("DtoH", "HtoD", "DtoD", "PtoP"):
            if d in name:
                return f"memcpy {d}"
        return "memcpy"
    if kind == "memset":
        return "memset"
    for key, lab in _HAND:
        if key in name:
            return lab
    m = _NCCL.search(name)
    if m or "nccl" in name.lower():
        return "NCCL " + (m.group(1) if m else "other")
    cls = classify_op(name)
    return f"eager ATen {cls or 'other'}: {_short(name)}"


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


# -- frozen copy of the program's interval algebra ----------------------

def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


def overlap_length(a, b) -> float:
    am, bm = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(am) and j < len(bm):
        lo = max(am[i][0], bm[j][0])
        hi = min(am[i][1], bm[j][1])
        if hi > lo:
            total += hi - lo
        if am[i][1] < bm[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract_length(base, cover) -> float:
    """The length of ``union(base)`` not covered by ``union(cover)``."""
    return union_length(base) - overlap_length(base, cover)


# -- events -------------------------------------------------------------

def events_of(prof):
    """``(device, host, marks)`` of a finished ``torch.profiler.profile``:
    device events as ``(start_ns, end_ns, kind, name)`` with kind
    ``kernel``, ``memcpy`` or ``memset``; host operator and runtime
    events as ``(start_ns, end_ns, name)``; host annotations as
    ``(name, start_ns, end_ns)``.  Annotations' device twins are
    dropped."""
    device, host, marks = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        note = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                else name.startswith("cgbench:"))
        if "CUDA" in str(e.device_type()):
            if note:
                continue
            kind = ("memcpy" if name.startswith("Memcpy") else
                    "memset" if name.startswith("Memset") else "kernel")
            device.append((start, end, kind, name))
        elif note:
            marks.append((name, start, end))
        else:
            host.append((start, end, name))
    return device, host, marks


def slice_bounds(marks, name: str = SLICE) -> tuple[int, int]:
    spans = [(s, e) for n, s, e in marks if n == name]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {name!r} annotation in the "
                           f"capture, found {len(spans)}")
    return spans[0]


class _HostIndex:
    """What the host was doing at an instant: the innermost host event
    that covers it (the latest-starting one)."""

    def __init__(self, host):
        self.ev = sorted(host)
        self.starts = [s for s, _, _ in self.ev]

    def at(self, t) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for k in range(i, max(i - 256, -1), -1):
            s, e, name = self.ev[k]
            if e >= t:
                return name
        return "no traced host op (Python)"


def summarize(device, host, lo: int, hi: int) -> dict:
    """One card's figures over the slice ``[lo, hi]`` (ns): every device
    interval clipped to it.  Seconds are floats; counts are of events
    that start inside the slice."""
    if hi <= lo:
        raise ValueError(f"empty slice [{lo}, {hi}]")
    busy, nccl, compute = [], [], []
    ops: dict[str, float] = {}
    launches = dtoh = k1_launches = 0
    k1_ns = 0
    for s, e, kind, name in device:
        a, b = max(s, lo), min(e, hi)
        starts_inside = lo <= s <= hi
        if b < a or (b == a and not starts_inside):
            continue
        busy.append((a, b))
        (nccl if is_nccl(name) else compute).append((a, b))
        lab = label(name, kind)
        ops[lab] = ops.get(lab, 0.0) + (b - a) * 1e-9
        if starts_inside:
            launches += 1
            dtoh += kind == "memcpy" and "DtoH" in name
            if lab == K1:
                k1_launches += 1
                k1_ns += e - s
    runs = merged(busy)
    gaps: dict[str, list] = {}
    index = _HostIndex(host)
    cur = lo
    for s, e in runs + [[hi, hi]]:
        if s > cur:
            what = index.at((cur + s) // 2)
            g = gaps.setdefault(what, [0.0, 0])
            g[0] += (s - cur) * 1e-9
            g[1] += 1
        cur = max(cur, e)
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": sum(e - s for s, e in runs) * 1e-9,
        "launches": launches,
        "dtoh_copies": dtoh,
        "k1_launches": k1_launches,
        "k1_s": k1_ns * 1e-9,
        "nccl_s": union_length(nccl) * 1e-9,
        "nccl_exposed_s": subtract_length(nccl, compute) * 1e-9,
        "device_ops": ops,
        "idle_gaps": gaps,
    }


def combine(cards: list[dict]) -> tuple[float, float]:
    """``(busy_s, window_s)`` of the run: the mean over cards of each
    card's busy share, times the first card's window."""
    shares = [c["busy_s"] / c["window_s"] for c in cards]
    window = cards[0]["window_s"]
    return sum(shares) / len(shares) * window, window


def breakdown(cards: list[dict], top: int = 10) -> dict:
    """The device operations that took most time (seconds a card, mean
    over cards) and the first card's idle time by what its host was
    doing (seconds, with the number of gaps in the name)."""
    ops: dict[str, float] = {}
    for c in cards:
        for k, v in c["device_ops"].items():
            ops[k] = ops.get(k, 0.0) + v / len(cards)
    dev = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(cards[0]["idle_gaps"].items(), key=lambda kv: -kv[1][0])
    return {"device_ops": [[k, v] for k, v in dev],
            "idle_gaps": [[f"{k} ({n} gaps)", s] for k, (s, n) in
                          gaps[:top]]}
