"""The port's timeline-tracing tier (acg_tpu_torch.tracing) against the
JAX package's: the capture analysis returns the reference's dict on the
reference tests' synthetic captures and their degrade cases, the port's
own CUDA kernels (as CUPTI names them) map to the op classes of
``--trace``, a torch.profiler capture of a CPU solve through the CLI is
analysed, and the span timeline is the reference's document."""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acg_tpu import tracing as jax_tracing
from acg_tpu_torch import tracing
from acg_tpu_torch.cli import main as torch_main
from acg_tpu_torch.solvers.stats import SolverStats

torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
US = 1e6


def _write_capture(tmp, events, host="vm"):
    d = tmp / "plugins" / "profile" / "run"
    d.mkdir(parents=True, exist_ok=True)
    with gzip.open(d / f"{host}.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def _x(name, ts, dur, **kw):
    return {"ph": "X", "pid": 1, "tid": 1, "name": name, "ts": ts * US,
            "dur": dur * US, **kw}


# the reference tests' synthetic captures (tests/test_tracing.py), by
# file: {host: events}
_CAPTURES = {
    "classes-and-overlap": {"vm": [
        _x("fusion.3", 0.0, 1.0), _x("all-reduce.1", 0.5, 2.0),
        _x("dot.7", 4.0, 0.25), _x("collective-permute.2", 4.0, 0.25),
        _x("batch-dot-simplification", 0.0, 9.0), _x("fusion", 0.0, 9.0),
        _x("$builtins isinstance", 0.0, 9.0), _x("solve", 0.0, 5.0)]},
    "per-file-overlap": {"h0": [_x("all-reduce.1", 0.0, 1.0)],
                         "h1": [_x("fusion.1", 0.0, 1.0)]},
    "straggler-two": {"h0": [_x("solve", 0.0, 1.0)],
                      "h1": [_x("solve", 0.0, 2.0)]},
    "straggler-three": {"h0": [_x("acg:solve", 0.0, 1.0)],
                        "h1": [_x("acg:solve", 0.0, 1.1)],
                        "h2": [_x("acg:solve", 0.0, 2.0)]},
    "pjit-and-keywords": {"vm": [
        _x("PjitFunction(_cg_program)", 0.0, 3.0),
        _x("dia_spmv", 0.1, 0.5), _x("psum", 1.0, 0.2),
        _x("halo_exchange_dma", 1.5, 0.1), _x("acg:compile", 0.0, 0.05),
        _x("acg:solve", 0.05, 3.0)]},
}


@pytest.mark.parametrize("name", sorted(_CAPTURES))
def test_analyze_trace_is_the_references(tmp_path, name):
    for host, events in _CAPTURES[name].items():
        _write_capture(tmp_path, events, host=host)
    an = tracing.analyze_trace(tmp_path)
    assert an == jax_tracing.analyze_trace(tmp_path)
    assert an["available"]
    assert tracing.format_analysis(an) == jax_tracing.format_analysis(an)


@pytest.mark.parametrize("case", ["missing", "xplane-only", "corrupt"])
def test_analyze_trace_degrades_as_the_reference(tmp_path, case):
    d = tmp_path / "plugins" / "profile" / "r"
    target = tmp_path / "nope" if case == "missing" else tmp_path
    if case == "xplane-only":
        d.mkdir(parents=True)
        (d / "vm.xplane.pb").write_bytes(b"\x00proto")
    elif case == "corrupt":
        d.mkdir(parents=True)
        with gzip.open(d / "vm.trace.json.gz", "wt") as f:
            f.write("{torn")
    an = tracing.analyze_trace(target)
    assert an["available"] is False
    assert an == jax_tracing.analyze_trace(target)


# the port's kernels and the library kernels of its plain ops, as CUPTI
# reports them on the card, with the class (and collective kind) the
# analysis gives each
_KERNELS = [
    ("void (anonymous namespace)::dia_spmv_kernel<double, double, 5>"
     "(DiaPlan, double const*, double*)", "gemv", None),
    ("void (anonymous namespace)::stencil_spmv_kernel<double, int, "
     "Div2>(int, Div2, int, long long const*, double const*, double*)",
     "gemv", None),
    ("void (anonymous namespace)::part_dot_kernel<double, double>(long "
     "long, double const*, long long, double const*, long long, double*)",
     "dot", None),
    ("void (anonymous namespace)::halo_put_kernel<double>(double const*, "
     "int const*, double*, int, int)", "halo", "dma"),
    ("void (anonymous namespace)::halo_put_peer_kernel<float>(float "
     "const*, long long)", "halo", "dma"),
    ("void (anonymous namespace)::cg_phase_a_kernel<float, float, 5>"
     "(float const*, float*)", "fusion", None),
    ("void (anonymous namespace)::cg_phase_b_kernel<float>(long long, "
     "float*)", "fusion", None),
    ("void (anonymous namespace)::pipelined_update_kernel<double, double>"
     "(long long, double*, double*)", "fusion", None),
    ("ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "allreduce", "all_reduce"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "allreduce", "all_reduce"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "halo",
     "all_to_all"),
    ("void dot_kernel<double, 128, 0, cublasDotParams<cublasGemvTensor"
     "StridedBatched<double const>, cublasGemvTensorStridedBatched<double>"
     " > >(cublasDotParams<cublasGemvTensorStridedBatched<double const>, "
     "cublasGemvTensorStridedBatched<double> >)", "dot", None),
    ("void reduce_1Block_kernel<double, 128, 7, cublasGemvTensorStrided"
     "Batched<double>, cublasGemvTensorStridedBatched<double>, cublasGemv"
     "TensorStridedBatched<double> >(double const*, int, double*)", "dot",
     None),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<double, "
     "at::native::func_wrapper_t<double, at::native::sum_functor<double, "
     "double, double>::operator()>, unsigned int, double, 4, 4> >(...)",
     "dot", None),
    ("psum", "allreduce", "all_reduce"),
    ("halo_exchange", "halo", "all_to_all"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<double>, std::array<char*, 3ul> >(int, ...)", None,
     None),
    ("Memcpy DtoH (Device -> Pinned)", None, None),
]


@pytest.mark.parametrize("name,cls,kind", _KERNELS)
def test_port_kernel_names_classify(name, cls, kind):
    assert tracing._classify_op(name) == cls
    if kind is not None:
        assert tracing._collective_kind(name, cls) == kind


def test_kineto_categories_count_each_op_once(tmp_path):
    """A torch.profiler-shaped capture: the device kernels count, their
    host twins (cpu_op, cuda_runtime) and each annotation's device twin
    (gpu_user_annotation) do not; the phases come from the host
    annotation."""
    k1 = _KERNELS[0][0]
    dot = _KERNELS[2][0]
    put = _KERNELS[3][0]
    events = [
        _x("acg:solve", 0.0, 2.0, cat="user_annotation"),
        _x("acg:solve", 0.1, 1.8, cat="gpu_user_annotation"),
        _x("acg:compile", 3.0, 1.0, cat="user_annotation"),
        _x("aten::dot", 0.2, 0.05, cat="cpu_op"),
        _x("cudaLaunchKernel", 0.2, 0.01, cat="cuda_runtime"),
        _x("dia_spmv", 0.2, 0.01, cat="cpu_op"),
        _x(k1, 0.3, 0.1, cat="kernel"), _x(dot, 0.5, 0.02, cat="kernel"),
        _x(put, 0.6, 0.01, cat="kernel"), _x(k1, 3.2, 0.1, cat="kernel"),
    ]
    _write_capture(tmp_path, events, host="0")
    an = tracing.analyze_trace(tmp_path)
    assert an["phase_seconds"] == {"compile": pytest.approx(1.0),
                                   "solve": pytest.approx(2.0)}
    assert an["op_seconds"] == {"dot": pytest.approx(0.02),
                                "gemv": pytest.approx(0.2),
                                "halo": pytest.approx(0.01)}
    assert an["op_seconds_in_solve"]["gemv"] == pytest.approx(0.1)
    assert an["collective_kind_seconds_in_solve"] == {
        "dma": pytest.approx(0.01)}
    st = SolverStats()
    for op in ("gemv", "dot", "halo"):
        st.ops[op].add(3, 9.0, 100)
    tracing.attach(st, an)
    assert st.ops["gemv"].t == pytest.approx(0.1)
    assert st.ops["halo"].t == pytest.approx(0.01)
    assert "gemv" in st.tracing["ops_source"]
    assert "tracing:" in st.fwrite()


def test_host_span_only_while_capturing(tmp_path):
    """Host collectives get their span only inside a capture, and only
    when they leave no device event."""
    import contextlib

    assert isinstance(tracing.host_span("psum", True),
                      contextlib.nullcontext)
    with tracing.profiler_trace(tmp_path / "t"):
        assert tracing.capturing()
        assert not isinstance(tracing.host_span("psum", True),
                              contextlib.nullcontext)
        assert isinstance(tracing.host_span("psum", False),
                          contextlib.nullcontext)
    assert not tracing.capturing()
    assert os.listdir(tmp_path / "t") == ["0.trace.json.gz"]


def test_profiler_trace_failed_start_warns(tmp_path, monkeypatch, capsys):
    import torch.profiler as tp

    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", boom)
    ran = []
    with tracing.profiler_trace(tmp_path / "t"):
        ran.append(1)
    assert ran == [1]
    assert "profiler start failed" in capsys.readouterr().err
    assert tracing.analyze_trace(tmp_path / "t")["available"] is False


@pytest.mark.parametrize("extra", [[], ["--nparts", "4", "--comm", "dma"]])
def test_cli_trace_capture_is_analysed(tmp_path, capsys, extra):
    """--trace on the CPU: the capture is <process>.trace.json.gz, its
    acg:compile/acg:solve windows are found once each, and the
    tracing: section says so; --timeline writes one pid per part."""
    tr, tl, st = tmp_path / "tr", tmp_path / "tl.json", tmp_path / "s.json"
    assert torch_main(["gen:poisson2d:16", "--device", "cpu", "-q",
                       "--warmup", "1", "--max-iterations", "300",
                       "--residual-rtol", "1e-8", "--trace", str(tr),
                       "--timeline", str(tl), "--stats-json", str(st)]
                      + extra) == 0
    err = capsys.readouterr().err
    assert os.listdir(tr) == ["0.trace.json.gz"]
    an = tracing.analyze_trace(tr)
    assert an["available"] and an["solve_windows"] == 1
    assert set(an["phase_seconds"]) == {"compile", "solve"}
    assert "tracing:" in err and "available: True" in err
    doc = json.loads(st.read_text())
    assert doc["stats"]["tracing"]["available"] is True
    assert doc["stats"]["tracing"]["timeline"]["nparts"] == (
        4 if extra else 1)
    res = subprocess.run([sys.executable, "scripts/check_timeline.py",
                          str(tl)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    res = subprocess.run([sys.executable, "scripts/trace_report.py",
                          str(tl)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_trace_degrades_without_a_capture(tmp_path, capsys,
                                              monkeypatch):
    """A profiler that cannot start: the solve runs, the CLI warns and
    the tracing: section says why (the reference's contract)."""
    import torch.profiler as tp

    def boom(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", boom)
    assert torch_main(["gen:poisson2d:8", "--device", "cpu", "-q",
                       "--warmup", "0", "--trace",
                       str(tmp_path / "tr")]) == 0
    err = capsys.readouterr().err
    assert "capture analysis unavailable" in err
    assert "total solver time" in err


def test_export_chrome_trace_is_the_references(tmp_path):
    payloads = [{"process": 0, "parts": [0, 1], "t_barrier": 5.0,
                 "spans": [{"name": "ingest", "t0": 1.0, "t1": 1.5,
                            "cat": "phase"},
                           {"name": "solve", "t0": 1.5, "t1": 3.0,
                            "cat": "phase", "part": 1}],
                 "instants": [{"name": "restart", "t": 2.5,
                               "detail": "x"}]}]
    a = tracing.export_chrome_trace(tmp_path / "a.json",
                                    [dict(p) for p in payloads], nparts=2)
    b = jax_tracing.export_chrome_trace(tmp_path / "b.json",
                                        [dict(p) for p in payloads],
                                        nparts=2)
    assert {k: v for k, v in a.items() if k != "file"} == \
        {k: v for k, v in b.items() if k != "file"}
    assert json.loads((tmp_path / "a.json").read_text()) == \
        json.loads((tmp_path / "b.json").read_text())
    skewed = [{"t_barrier": 10.0, "spans": [{"t0": 1.0, "t1": 2.0}],
               "instants": []},
              {"t_barrier": 10.5, "spans": [{"t0": 1.0, "t1": 2.0}],
               "instants": []}]
    twin = json.loads(json.dumps(skewed))
    assert tracing.align_payloads(skewed) == \
        jax_tracing.align_payloads(twin)
    assert skewed == twin
    assert np.isclose(skewed[0]["spans"][0]["t0"], 1.5)


def test_profiler_layout_reader_matches_the_whole_parse(tmp_path):
    """The reader that parses only the counted blocks of a torch.profiler
    capture returns the events a whole parse keeps, on a capture holding
    host operators, annotations and host collective spans."""
    import torch

    from acg_tpu_torch import telemetry

    with tracing.profiler_trace(tmp_path / "t"):
        with telemetry.annotate("solve"):
            v = torch.ones(64)
            for i in range(40):
                with tracing.host_span("psum" if i % 2 else
                                       "halo_exchange", True):
                    v = v + torch.dot(v, v) * 1e-9
    path = str(tmp_path / "t" / "0.trace.json.gz")
    text = gzip.open(path, "rt").read()
    fast = tracing._counted_blocks(text)
    whole = [e for e in json.loads(text)["traceEvents"]
             if e.get("ph") == "X" and tracing._counted(e)]
    assert fast is not None and fast == whole and len(fast) == 41
    an = tracing.analyze_trace(tmp_path / "t")
    assert an["solve_windows"] == 1
    assert set(an["op_seconds_in_solve"]) == {"allreduce", "halo"}
    assert tracing._counted_blocks(json.dumps({"traceEvents": whole})) \
        is None
