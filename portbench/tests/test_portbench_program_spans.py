"""The program's spans joined to a device trace (``program_spans.join``) on
a synthetic event list: a kernel goes to the span that holds its launch
call, an idle gap to the span that holds its midpoint; and a traced run of
a small cell on the CPU reads the host-read counter."""

import pytest

from pb_support import tiny_cell

from nmf_tpu_torch.utils.spans import Span
from portbench import harness, program_spans


def span(name, start, end, parent=None, call=1, reads=0):
    s = Span(name, parent, call, {})
    s.start_ns, s.end_ns = start, end
    s.counts["host_reads"] = reads
    return s


def test_join_on_a_synthetic_trace():
    rec = [
        span("nnmf", 0, 1000),  # 0
        span("iter", 100, 900, 0),  # 1
        span("seam.mm", 150, 300, 1),  # 2
        span("stop", 600, 880, 1, reads=1),  # 3
        span("host_read", 700, 880, 3),  # 4
    ]
    # (start, end, name, correlation): kernel 7 launched in seam.mm, kernel 8
    # in stop, a copy launched in the read, a kernel whose launch is not in
    # the trace, one launched before the call
    device = [(200, 500, "gemm", 7), (620, 690, "reduce", 8),
              (695, 705, "Memcpy DtoH (Device -> Pageable)", 9),
              (720, 730, "lost", 10), (40, 60, "early", 11)]
    launches = {7: 160, 8: 610, 9: 701, 11: 20}
    syncs = [(702, "cudaStreamSynchronize"), (950, "cudaDeviceSynchronize")]
    out = program_spans.join(rec, device, launches, syncs, [(0, 1000)])
    by = dict(out["device_by_span"])
    assert by["seam.mm"] == pytest.approx(300e-9)
    assert by["stop"] == pytest.approx(70e-9)
    assert by["stop.host_read"] == pytest.approx(10e-9)
    assert by[program_spans.NO_LAUNCH] == pytest.approx(10e-9)
    assert by["nnmf"] == pytest.approx(20e-9)  # the root of the call owns it
    assert dict(out["launches_by_span"]) == {"seam.mm": 1, "stop": 1, "nnmf": 1,
                                             program_spans.NO_LAUNCH: 1}
    # gaps: 0-40 (nnmf), 60-200 (iter at its midpoint 130), 500-620 (iter),
    # 690-695 (stop), 705-720 and 730-1000 (the read)
    idle = dict(out["idle_by_span"])
    assert idle["nnmf"] == pytest.approx(40e-9)
    assert idle["iter"] == pytest.approx(260e-9)
    assert idle["stop"] == pytest.approx(5e-9)
    assert idle["stop.host_read"] == pytest.approx(285e-9)
    assert out["metrics"]["seam_device_pct"] == pytest.approx(100 * 300 / 410)
    assert out["owned_device_pct"] == pytest.approx(100 * 380 / 410)
    assert out["owned_launches_pct"] == pytest.approx(100 * 2 / 4)
    assert out["host_reads"] == 1 and out["trace_dtoh_copies"] == 1
    assert out["trace_syncs"] == 2
    # stop ends in its read, and its reduce and the read's copy lie inside
    # it: the nearest edge 20 ns away
    assert out["clock_ok"] and out["clock_excess_us"] == pytest.approx(-0.02)


def test_clock_out_of_step_is_seen():
    rec = [span("nnmf", 0, 1000), span("stop", 100, 200, 0),
           span("host_read", 150, 200, 1)]
    device = [(120, 60_300, "reduce", 1)]  # ends 60 us after its read
    out = program_spans.join(rec, device, {1: 110}, [], [(0, 100_000)])
    assert not out["clock_ok"] and out["clock_excess_us"] == pytest.approx(60.1)


def test_device_clock_drift_is_taken_out():
    rec = [span("stop", 0, 10_000), span("host_read", 5_000, 10_000, 0),
           span("stop", 990_000, 1_010_000), span("host_read", 1_000_000, 1_010_000, 2)]
    # the device's clock runs 50 us ahead after the first read, 60 us after
    # the second; the first kernel after each read starts LAUNCH_NS after
    # its launch, the one between them waits in the queue
    device = [(74_000, 80_000, "k1", 1), (600_000, 700_000, "k2", 2),
              (1_084_000, 1_090_000, "k3", 3)]
    launches = {1: 20_000, 2: 500_000, 3: 1_020_000}
    moved, drift = program_spans.device_clock(rec, device, launches)
    assert drift == 60_000
    assert moved[0][0] == pytest.approx(24_000, abs=200)
    assert moved[0][1] - moved[0][0] == 6_000
    assert moved[2][0] == pytest.approx(1_024_000, abs=200)
    # clocks that agree are left as they are
    same = [(24_000, 30_000, "k1", 1), (1_024_000, 1_030_000, "k3", 3)]
    assert program_spans.device_clock(rec, same, launches) == (same, 0)


def test_a_traced_run_reads_the_counter():
    res = harness.run_cell(tiny_cell("ml25m-kl"), 2**31 + 7, 0.1, trace=True, device="cpu")
    # the front door's three checks, 20 stop reads and the objective's read
    # over 20 iterations; the host clocks and the device trace only on a card
    assert res["metrics"]["host_reads_per_iter"] == pytest.approx(24 / 20)
    for name in ("enqueue_ms_per_halfstep", "outside_loop_pct", "seam_device_pct"):
        assert name not in res["metrics"]
    assert res["spans"]["program_spans"]["host_reads_solve1"] == 24
    # the breakdown lists go out on standard error with the set-up parts
    for key in ("device_by_span", "launches_by_span", "idle_by_span"):
        assert key in res["spans"]["program_spans"]


def test_no_run_no_solves():
    # outside harness.run_cell there is no seed or solver to solve with
    assert program_spans.run_args() is None
