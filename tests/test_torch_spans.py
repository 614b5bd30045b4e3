"""The recorder of spans and counters inside the port (``utils/spans.py``),
on the CPU: off by default, nesting and call ids, the host-read counter
against the reads a solve makes, the running lanes of batched restarts, the
store's passes, and one clock with ``torch.profiler``."""

import threading

import numpy as np
import pytest
import torch

import nmf_tpu_torch as nt
from nmf_tpu_torch.io import native
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.sparse_format import build_tiled
from nmf_tpu_torch.utils import spans


def _problem(p=60, n=40, k=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(p, n, generator=g), torch.rand(p, k, generator=g),
            torch.rand(k, n, generator=g))


def _names(rec):
    return [s.name for s in rec.spans]


def test_off_records_nothing():
    X, W0, H0 = _problem()
    assert spans.span("nnmf") is spans.NO_SPAN
    assert spans.span("seam.mm", kind="dense", width=4) is spans.NO_SPAN
    with spans.span("iter") as s:
        assert s is None
    spans.launched()  # nothing to count in
    assert spans.host_read(torch.tensor(True), "bool") is True
    assert spans.host_read(torch.tensor([1.5, 2.0]), "tolist") == [1.5, 2.0]
    res = nt.nnmf(X, 4, init="custom", W0=W0, H0=H0, alg="multdiv", maxiter=5,
                  device="cpu")
    with spans.recording() as rec:
        pass
    assert rec.spans == []
    # recording changes no bit of a solve
    with spans.recording():
        again = nt.nnmf(X, 4, init="custom", W0=W0, H0=H0, alg="multdiv", maxiter=5,
                        device="cpu")
    assert again == res


def test_nesting_and_calls():
    X, W0, H0 = _problem()
    with spans.recording() as rec:
        with spans.span("outer", tag=1):
            nt.nnmf(X, 4, init="custom", W0=W0, H0=H0, alg="cd", maxiter=3, device="cpu")
        nt.nnmf(X, 4, alg="multmse", maxiter=3, device="cpu", init="random")
    s = rec.spans
    assert s[0].name == "outer" and s[0].parent is None and s[0].call is None
    assert s[0].attrs == {"tag": 1}
    calls = [x for x in s if x.name == "nnmf"]
    assert [c.call for c in calls] == [1, 2]
    assert calls[0].parent == 0 and calls[1].parent is None
    assert calls[0].attrs == {"alg": "cd", "k": 4, "replicates": 1, "parallel": False}
    for i, x in enumerate(s):
        assert x.start_ns <= x.end_ns
        if x.parent is not None:
            up = s[x.parent]
            assert x.parent < i and up.start_ns <= x.start_ns and x.end_ns <= up.end_ns
            if up.name != "outer":
                assert x.call == up.call
    names = _names(rec)
    for name in ("nnmf.checks", "nnmf.init", "solve", "solve.prepare", "iter", "half.W",
                 "half.H", "stop", "host_read", "seam.mm", "seam.mtm", "solve.objective"):
        assert name in names, name
    iters = [x for x in s if x.name == "iter"]
    assert [x.attrs["t"] for x in iters] == [0, 1, 2, 0, 1, 2]
    for it in iters:  # the half-steps and the stop test inside each iteration
        kids = [x.name for x in s if x.parent == s.index(it)]
        assert sorted(kids[:2]) == ["half.H", "half.W"] and kids[2:] == ["stop"]


def test_recordings_do_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError, match="do not nest"):
            with spans.recording():
                pass
    with spans.recording() as rec:  # the first one ended: a new one starts
        with spans.span("a"):
            pass
    assert _names(rec) == ["a"]


def test_other_threads_are_not_recorded():
    seen = []

    def work():
        seen.append(spans.span("elsewhere"))
        spans.launched()

    with spans.recording() as rec:
        with spans.span("here"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [spans.NO_SPAN] and _names(rec) == ["here"]
    assert rec.spans[0].counts == {"host_reads": 0, "launches": 0}


@pytest.mark.parametrize("custom", [True, False])
def test_host_reads_count_the_solves_reads(custom):
    X, W0, H0 = _problem()
    kw = dict(init="custom", W0=W0, H0=H0) if custom else dict(init="random")
    with spans.recording() as rec:
        res = nt.nnmf(X, 4, alg="multdiv", maxiter=5, device="cpu", **kw)
    counts = {}
    for x in rec.spans:
        counts[x.name] = counts.get(x.name, 0) + x.counts["host_reads"]
    # the non-negativity checks of X (and of a custom W0 and H0), one stop
    # read an iteration, the objective that builds the Result
    checks = 3 if custom else 1
    assert counts["nnmf.checks"] == checks
    assert counts["stop"] == res.niters == 5
    assert counts["solve"] == 1
    total = sum(counts.values())
    assert total == checks + res.niters + 1
    assert _names(rec).count("host_read") == total
    reads = [x for x in rec.spans if x.name == "host_read"]
    assert [x.attrs["how"] for x in reads] == ["bool"] * (checks + 5) + ["float"]


def test_hals_reads_and_running_lanes():
    X, _, _ = _problem()
    with spans.recording() as rec:
        nt.nnmf(X, 4, alg="cd", init="random", replicates=3, parallel_replicates=True,
                maxiter=200, tol=1e-2, device="cpu")
    s = rec.spans
    names = _names(rec)
    assert names.count("replicates") == 1
    draw, lanes = names.index("replicates.draw"), names.index("replicates.lanes")
    assert s[draw].parent == s[lanes].parent == names.index("replicates") < draw < lanes
    lane_iters = [x for x in s if x.name == "iter" and "lanes" in x.attrs]
    running = [x.attrs["lanes"] for x in lane_iters]
    assert running[0] == 2 and running[-1] == 1
    assert all(a >= b for a, b in zip(running, running[1:]))
    # a HALS half-step reads its Hessian's diagonal once
    for half in (x for x in s if x.name in ("half.W", "half.H")):
        assert half.counts["host_reads"] == 1
    assert all(x.counts["host_reads"] == 1 for x in s if x.name == "stop")


def test_launches_count_in_the_innermost_span():
    with spans.recording() as rec:
        spans.launched()  # no span open: nowhere to count
        with spans.span("outer"):
            spans.launched()
            with spans.span("inner"):
                spans.launched()
                spans.launched()
    assert [x.counts["launches"] for x in rec.spans] == [1, 2]
    assert not hasattr(build, "build_seconds") and not hasattr(native, "build_seconds")


def test_store_and_native_spans(monkeypatch):
    rng = np.random.default_rng(0)
    idx = rng.choice(300 * 200, size=900, replace=False)
    rows, cols = (idx // 200).astype(np.int32), (idx % 200).astype(np.int32)
    vals = rng.random(900, dtype=np.float32)
    monkeypatch.setattr(native, "_lib", None)
    with spans.recording() as rec:
        build_tiled(rows, cols, vals, (300, 200), device="cpu")
        native.load()
    s = rec.spans
    store = s[0]
    assert store.name == "store.build" and store.attrs == {"nnz": 900}
    passes = [x.attrs["pass"] for x in s if x.name == "store.pass"]
    assert passes == ["sort", "bin.fwd", "bin.bwd", "upload"]
    assert all(x.parent == 0 for x in s if x.name == "store.pass")
    load = _names(rec).index("native.load")
    assert s[load].parent is None
    assert all(x.parent == load for x in s if x.name == "native.build")


def test_one_clock_with_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    a = torch.rand(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            with spans.span("work"):
                a @ a
    (work,) = rec.spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert events
    for e in events:
        assert work.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= work.end_ns
