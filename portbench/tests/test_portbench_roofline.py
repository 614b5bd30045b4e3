"""The counts behind each roofline share and the solve's share of the peak,
on shapes whose bytes and operations can be counted by hand, and the
reduction of a profiler trace."""

import pytest

from pb_support import ROOT

from portbench import profile, roofline
from portbench.common import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS


def test_peaks():
    assert PEAK_BYTES_PER_S == 3.35e12
    assert PEAK_FP32_FLOPS == pytest.approx(165e12)


def test_spmm_counts():
    # X 2 x 3 with 4 entries, D 3 x 5: entries 4 * 8 B, row pointers 3 * 4 B,
    # D 15 * 4 B, out 10 * 4 B; 2 * 4 * 5 operations
    assert roofline.spmm(2, 3, 4, 5) == (32 + 12 + 60 + 40, 40)


def test_sddmm_counts():
    # W 2 x 5, H 5 x 3, 4 entries: coordinates 4 * 8, W and H 25 * 4, out 4 * 4
    assert roofline.sddmm(2, 3, 4, 5) == (32 + 100 + 16, 40)


def test_quotient_and_gemm_counts():
    # X 2 x 3, k 5: X 6, W 10, H 15 floats in; W'Q is 5 x 3, QH' is 2 x 5
    assert roofline.quotient(2, 3, 5, 3) == (4 * (6 + 10 + 15 + 15), 4 * 2 * 3 * 5)
    assert roofline.quotient(2, 3, 5, 2) == (4 * (6 + 10 + 15 + 10), 4 * 2 * 3 * 5)
    # W'X: X and W in, 5 x 3 out; XH': X and H in, 2 x 5 out
    assert roofline.gemm(2, 3, 5, 3) == (4 * (6 + 10 + 15), 2 * 2 * 3 * 5)
    assert roofline.gemm(2, 3, 5, 2) == (4 * (6 + 15 + 10), 2 * 2 * 3 * 5)


@pytest.mark.parametrize("counts, by", [
    (roofline.spmm(162541, 59047, 25_000_095, 128), "bytes"),
    (roofline.spmm(59047, 162541, 25_000_095, 512), "bytes"),
    (roofline.sddmm(162541, 59047, 25_000_095, 128), "bytes"),
    (roofline.quotient(100_000, 10_000, 64, 10_000), "operations"),
    (roofline.gemm(100_000, 10_000, 64, 10_000), "bytes"),
])
def test_which_bound_binds_at_the_cells_shapes(counts, by):
    assert roofline.bound_by(*counts) == by


def test_bound_is_the_larger_time():
    assert roofline.bound_s(3.35e12, 0) == 1.0
    assert roofline.bound_s(0, PEAK_FP32_FLOPS) == 1.0
    assert roofline.bound_by(3.35e12, 1.0) == "bytes"
    assert roofline.share([((3.35e12, 0), 2.0), ((0, PEAK_FP32_FLOPS), 2.0)]) == 50.0


def test_solve_flops():
    # KL, sparse: 4 products with X an iteration and one for the objective
    assert roofline.solve_flops("multdiv", (10, 20), 30, 4, 2, 1, 1, 0) == \
        2 * 4 * (2 * 30 * 4) + 2 * 30 * 4
    # HALS, dense X, 3 starts: 2 products and 2 Grams an iteration
    xk, gram = 2 * 200 * 4, 2 * 30 * 16
    assert roofline.solve_flops("cd", (10, 20), None, 4, 5, 3, 1, 0) == \
        3 * (5 * (2 * xk + 2 * gram) + xk + gram)
    # a solve to a target in 2 calls, 2 reads of the error
    assert roofline.solve_flops("projals", (10, 20), None, 4, 10, 1, 2, 2) == \
        10 * (2 * xk + 2 * gram + 2 * 64 // 3) + 2 * xk + 2 * xk


class Ev:
    def __init__(self, name, start, end, device, thread=1, annotation=False):
        self._n, self._s, self._e, self._d = name, start, end, device
        self._t, self._a = thread, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_trace_reduction():
    events = [
        Ev(profile.MARK, 0, 100, False),
        Ev(profile.MARK, 0, 100, True, annotation=True),  # its copy on the device
        Ev("aten::mm", 5, 30, False),
        Ev("cudaLaunchKernel", 6, 8, False),
        Ev("aten::item", 60, 90, False),
        Ev("kernA", 10, 40, True),
        Ev("kernB", 20, 50, True),  # overlaps A: counted once
        Ev("Memcpy DtoH (Device -> Pageable)", 80, 85, True),
    ]
    s = profile.summarize(events)
    assert s["window_s"] == 100e-9
    assert s["busy_s"] == pytest.approx(45e-9)  # [10, 50) and [80, 85)
    assert s["launches"] == 2
    assert s["device_ops"][0] == ["kernA", 30e-9]
    gaps = dict(s["idle_gaps"])
    # [0, 10): the host was in aten::mm at 5; [50, 80) in aten::item; [85, 100)
    # in aten::item at 92? no: 92 is past its end
    assert gaps["aten::item"] == pytest.approx(30e-9)
    assert gaps["aten::mm"] == pytest.approx(10e-9)
    assert gaps[profile.BETWEEN_OPS] == pytest.approx(15e-9)
    assert s["collective_s"] == 0


def test_collective_time_counts_only_nccl_kernels():
    """On a traced solve of two ranks: NCCL's kernels, overlapping each
    other and a product, counted once each instant and only inside the
    solve; ``collective_pct`` is the larger rank's share of its busy time."""
    from types import SimpleNamespace

    from portbench.manifest import load_module

    events = [
        Ev(profile.MARK, 100, 200, False),
        Ev("gemm", 100, 150, True),
        Ev("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 140, 170, True),
        Ev("ncclKernel_Broadcast_RING_LL_Sum_int8_t", 160, 180, True),
        Ev("ncclDevKernel_AllGather_RING_LL(x)", 190, 230, True),  # ends after the solve
        Ev("ncclDevKernel_AllGather_RING_LL(x)", 20, 60, True),  # before it
        Ev("elementwise_kernel_nccl_like", 185, 190, True),  # not NCCL's
    ]
    s = profile.summarize(events)
    assert s["busy_s"] == pytest.approx(95e-9)  # [100, 180), [185, 200)
    assert s["collective_s"] == pytest.approx(50e-9)  # [140, 180), [190, 200)
    other = dict(s, collective_s=10e-9)
    read = load_module(ROOT / "portbench/metrics/collective_pct.py").read
    ctx = SimpleNamespace(trace=dict(s, ranks=[other, s]))
    assert read(ctx) == pytest.approx(100 * 50 / 95)
    assert read(SimpleNamespace(trace=dict(s, collective_s=0.0))) is None
