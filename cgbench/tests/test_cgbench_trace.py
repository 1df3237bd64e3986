"""A card's busy time from synthetic traces: the union of its own device
intervals clipped to the slice, NCCL included, host annotations never;
across cards the mean busy share, never a sum."""

import pytest

from cgbench import trace

MS = 1_000_000  # ns


class _Ev:
    """A kineto event as ``torch.profiler`` hands it over."""

    def __init__(self, name, start, dur, device, note=False):
        self._v = (name, start, dur, device, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {})()
        self.profiler.kineto_results.events = lambda: events


def test_events_of_drops_annotations_and_their_device_twins():
    prof = _Prof([
        _Ev(trace.SLICE, 0, 10 * MS, False, note=True),
        _Ev(trace.SLICE, 0, 10 * MS, True, note=True),    # device twin
        _Ev("aten::dot", 1 * MS, 1 * MS, False),
        _Ev("void dia_spmv_kernel<double>(DiaPlan)", 2 * MS, 3 * MS, True),
        _Ev("Memcpy DtoH (Device -> Pinned)", 6 * MS, MS // 10, True),
        _Ev("Memset (Device)", 7 * MS, MS // 10, True),
    ])
    device, host, marks = trace.events_of(prof)
    assert [k for _, _, k, _ in device] == ["kernel", "memcpy", "memset"]
    assert host == [(1 * MS, 2 * MS, "aten::dot")]
    assert trace.slice_bounds(marks) == (0, 10 * MS)
    card = trace.summarize(device, host, *trace.slice_bounds(marks))
    assert card["busy_s"] == pytest.approx(3.2e-3)
    assert card["launches"] == 3 and card["dtoh_copies"] == 1
    assert card["k1_launches"] == 1 and card["k1_s"] == pytest.approx(3e-3)


def test_overlapping_streams_count_once_and_nccl_counts():
    # compute [1, 5) ms, NCCL on its own stream [3, 8) ms, waiting on a
    # peer for most of it: the card is busy [1, 8) ms
    device = [(1 * MS, 5 * MS, "kernel", "void dia_spmv_kernel<double>()"),
              (3 * MS, 8 * MS, "kernel",
               "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)")]
    card = trace.summarize(device, [], 0, 10 * MS)
    assert card["busy_s"] == pytest.approx(7e-3)
    assert card["nccl_s"] == pytest.approx(5e-3)
    assert card["nccl_exposed_s"] == pytest.approx(3e-3)
    assert card["busy_s"] <= card["window_s"]


def test_intervals_outside_the_slice_are_clipped():
    device = [(0, 4 * MS, "kernel", "k_before"),      # half inside
              (5 * MS, 6 * MS, "kernel", "k_in"),
              (9 * MS, 20 * MS, "kernel", "k_after"),  # one ms inside
              (30 * MS, 31 * MS, "kernel", "k_outside")]
    card = trace.summarize(device, [], 2 * MS, 10 * MS)
    assert card["window_s"] == pytest.approx(8e-3)
    assert card["busy_s"] == pytest.approx(4e-3)
    assert card["launches"] == 2          # those that start inside


def test_idle_gaps_by_what_the_host_was_doing():
    device = [(0, 1 * MS, "kernel", "a"), (3 * MS, 4 * MS, "kernel", "b")]
    host = [(0, 10 * MS, "aten::_local_scalar_dense"),
            (1 * MS, 3 * MS, "cudaStreamSynchronize")]
    card = trace.summarize(device, host, 0, 5 * MS)
    gaps = card["idle_gaps"]
    assert gaps["cudaStreamSynchronize"] == pytest.approx([2e-3, 1])
    assert gaps["aten::_local_scalar_dense"] == pytest.approx([1e-3, 1])


def test_four_cards_mean_share_never_sum():
    cards = []
    for q in range(4):
        # each card 90 % busy over a 10 ms slice, its kernels on two
        # overlapping streams
        device = [(q * MS, q * MS + 6 * MS, "kernel", "compute"),
                  (q * MS + 5 * MS, q * MS + 9 * MS, "kernel",
                   "ncclDevKernel_AllReduce_Sum_f64_RING_LL")]
        cards.append(trace.summarize(device, [], q * MS, q * MS + 10 * MS))
    busy, window = trace.combine(cards)
    assert 0 < busy <= window
    assert busy == pytest.approx(9e-3) and window == pytest.approx(1e-2)
    assert sum(c["busy_s"] for c in cards) > window   # what a sum would give
    b = trace.breakdown(cards)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert dict(b["device_ops"])["NCCL AllReduce"] == pytest.approx(4e-3)


@pytest.mark.parametrize("name, want", [
    ("void dia_spmv_kernel<double, double, 5>(DiaPlan, double const*)",
     "K1 dia_spmv"),
    ("void (anonymous namespace)::part_dot_kernel<double, double>()",
     "part_dot"),
    ("void cg_phase_b_kernel<float>(long long)", "K4 cg_phase_b"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "NCCL AllGather"),
    ("void dot_kernel<double, 128, 0, cublasDotParams<cublasGemvTensor"
     "StridedBatched<double const> > >()", "eager ATen dot: dot_kernel"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::"
     "AUnaryFunctor<double, double, double, at::native::binary_internal::"
     "MulFunctor<double> >, std::array<char*, 2ul> >(int)",
     "eager ATen other: vectorized_elementwise_kernel[MulFunctor]"),
])
def test_labels(name, want):
    assert trace.label(name, "kernel") == want


def test_union_and_subtract_match_the_programs_algebra():
    a = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    b = [(2.5, 5.5)]
    assert trace.union_length(a) == pytest.approx(4.0)
    assert trace.overlap_length(a, b) == pytest.approx(1.0)
    assert trace.subtract_length(a, b) == pytest.approx(3.0)
