"""The program's own spans (``nmf_tpu_torch.utils.spans``), read in a
``--trace 1`` run after every other metric, and joined to the device trace.

Two more solves of the cell run, each through the harness's ``Solver`` from
the start that ``solve_start`` gives the index ``"spans"``:

1. with the program's recording on and no profiler: host times that the
   profiler does not inflate (``host_reads_per_iter``,
   ``enqueue_ms_per_halfstep``, ``outside_loop_pct``);
2. with the recording on under ``torch.profiler``.  Each device interval
   goes to the innermost program span that holds the host call that
   launched it (the kineto correlation id links a kernel or a copy to its
   CUDA runtime call); each idle gap of the device to the innermost span
   that holds its midpoint (``seam_device_pct`` and the breakdown lists
   ``device_by_span``, ``launches_by_span``, ``idle_by_span``).

The spans are stamped with ``time.time_ns()``, the clock of the profiler's
events, so both lie on one timeline.  A ``host_read`` span is named by its
parent (``stop.host_read``), the share of the device that waited on it.
Against a program that records no spans everything here returns None.

The breakdown lists and the join's checks (the share of the device time and
of the launches owned below ``nnmf``, the host reads against the trace's
syncs and copies, the clock check) go to ``ctx.spans["program_spans"]``,
which ``run.py`` prints on standard error with the set-up parts; the result
line does not carry them.
"""

from __future__ import annotations

import bisect
import importlib
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from portbench import profile
from portbench.common import sync
from portbench import harness
from portbench.harness import nnmf_seed, solve_start

OUTSIDE = "(outside the program's spans)"
NO_LAUNCH = "(no launch call found)"
READ = "host_read"
LAUNCH_NS = 4_000  # launch call to kernel start on an idle H100, at least (measured)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
CLOCK_SLACK_NS = 50_000  # a device interval may end this long after its span


def recorder():
    """The program's recorder, or None for a program without one."""
    try:
        return importlib.import_module("nmf_tpu_torch.utils.spans")
    except ImportError:
        return None


def readings(ctx):
    """The two solves, reduced, once a run; None without a trace, outside
    ``harness.run_cell``, or against a program that records no spans."""
    tr = ctx.trace
    if tr is None:
        return None
    if "program_spans" not in tr:
        tr["program_spans"] = _run(ctx)
    return tr["program_spans"]


def run_args():
    """The run's ``seed`` and its ``Solver``, from the ``harness.run_cell``
    call that is reading the metrics (``Context`` carries neither), or
    None outside one."""
    f = sys._getframe(1)
    while f is not None and f.f_code is not harness.run_cell.__code__:
        f = f.f_back
    if f is None or f.f_locals.get("solve") is None:
        return None
    return f.f_locals["seed"], f.f_locals["solve"]


def _run(ctx):
    spans = recorder()
    found = run_args()
    if spans is None or not hasattr(spans, "recording") or found is None:
        return None
    run_seed, solve = found
    W0, H0 = solve_start(ctx.cell.traffic, ctx.shape, ctx.k, ctx.device, run_seed, "spans")
    seed = nnmf_seed(run_seed, "spans")
    sync(ctx.device)
    with spans.recording() as rec:
        t = time.perf_counter()
        solve(W0, H0, seed)
        sync(ctx.device)
        wall1 = time.perf_counter() - t
    out = host_side(rec.spans)

    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(profile.MARK):
            with spans.recording() as rec2:
                t = time.perf_counter()
                solve(W0, H0, seed)
                sync(ctx.device)
                wall2 = time.perf_counter() - t
    del W0, H0, solve
    device, launches, syncs, marks = events(prof.profiler.kineto_results.events())
    joined = join(rec2.spans, device, launches, syncs, marks)
    out.update(joined.pop("metrics"))
    ctx.spans["program_spans"] = dict(joined, solve1_s=wall1, solve2_s=wall2,
                                      host_reads_solve1=out["host_reads"],
                                      iters_solve1=out["iters"])
    return out


def _labels(rec_spans):
    """A span's name; a ``host_read`` is named by its parent as well."""
    return [s.name if s.name != READ or s.parent is None
            else f"{rec_spans[s.parent].name}.{READ}" for s in rec_spans]


def host_side(rec_spans) -> dict:
    """Solve 1's numbers from its spans alone."""
    in_call = [s for s in rec_spans if s.call is not None]
    reads = sum(s.counts["host_reads"] for s in in_call)
    iters = [s for s in in_call if s.name == "iter"]
    wall = lambda ss: sum(s.end_ns - s.start_ns for s in ss)  # noqa: E731
    calls_ns = wall(s for s in in_call if s.name == "nnmf")
    # each half-step's time without its reads' waits
    half = [None] * len(rec_spans)
    waits = defaultdict(int)
    for i, s in enumerate(rec_spans):
        if s.name in ("half.W", "half.H"):
            half[i] = i
        elif s.parent is not None:
            half[i] = half[s.parent]
        if s.name == READ and half[i] is not None:
            waits[half[i]] += s.end_ns - s.start_ns
    halves = [i for i, s in enumerate(rec_spans) if s.name in ("half.W", "half.H")]
    enq = [rec_spans[i].end_ns - rec_spans[i].start_ns - waits[i] for i in halves]
    return {
        "host_reads": reads,
        "iters": len(iters),
        "host_reads_per_iter": reads / len(iters) if iters else None,
        "enqueue_ms_per_halfstep": sum(enq) / len(enq) / 1e6 if enq else None,
        "outside_loop_pct": (100.0 * (calls_ns - wall(iters)) / calls_ns
                             if calls_ns > 0 else None),
    }


def events(kineto_events):
    """The profiled solve's events as plain tuples: device intervals
    ``(start, end, name, correlation)``, the host time of each CUDA runtime
    call by correlation id, the blocking syncs ``(start, name)`` and the
    solve's marks ``(start, end)``."""
    device, launches, syncs, marks = [], {}, [], []
    for e in kineto_events:
        s, name = e.start_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name != profile.MARK and not e.is_user_annotation():
                device.append((s, s + e.duration_ns(), name, e.correlation_id()))
        elif name == profile.MARK:
            marks.append((s, s + e.duration_ns()))
        elif name.startswith("cu"):  # the CUDA runtime and driver calls
            launches[e.correlation_id()] = s
            if name in SYNCS:
                syncs.append((s, name))
    return device, launches, syncs, marks


def device_clock(rec_spans, device, launches):
    """The device intervals on the host's clock, and the largest shift that
    took.  In a later profiler session of one process the device's
    timestamps drift from the host's (by up to 10 ms over a 4.5 s solve on
    an H100, where the first session keeps them within microseconds).
    After a blocking read the device is idle, so the first kernel launched
    after it starts ``LAUNCH_NS`` after its launch call: each ``host_read``
    gives the drift at its end, and the intervals move by the drift
    interpolated between the reads."""
    reads = sorted((s.start_ns, s.end_ns) for s in rec_spans if s.name == READ)
    if not reads or not device:
        return device, 0
    ends = [e for _, e in reads]
    first = [None] * len(reads)  # least (start - launch call) after each read
    for s, e, _, c in device:
        t = launches.get(c)
        if t is None:
            continue
        k = bisect.bisect_right(ends, t) - 1
        if k >= 0 and (k + 1 == len(reads) or t < reads[k + 1][0]):
            first[k] = s - t if first[k] is None else min(first[k], s - t)
    at, drift = [], []
    for (_, e), f in zip(reads, first):
        if f is not None:
            at.append(e)
            drift.append(f - LAUNCH_NS)
    if not at:
        return device, 0
    shift = lambda t: float(np.interp(t, at, drift))  # noqa: E731
    moved = []
    for s, e, name, c in device:
        d = round(shift(s - shift(s)))  # the drift at the interval's host time
        moved.append((s - d, e - d, name, c))
    return moved, max(abs(d) for d in drift)


def innermost(rec_spans, points):
    """For each of ``points`` (sorted), the index of the innermost recorded
    span that holds it, or None.  The spans nest and are in the order they
    opened."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(rec_spans) and rec_spans[i].start_ns <= t:
            while stack and rec_spans[stack[-1]].end_ns < rec_spans[i].start_ns:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and rec_spans[stack[-1]].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _top(d):
    return [[k[:profile.NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def join(rec_spans, device, launches, syncs, marks) -> dict:
    """Solve 2's device trace by program span: each device interval to the
    innermost span holding its launch call, each idle gap inside the marks
    to the innermost span holding its midpoint."""
    labels = _labels(rec_spans)
    seam = [False] * len(rec_spans)
    below = [False] * len(rec_spans)  # strictly inside an nnmf call
    for i, s in enumerate(rec_spans):
        if s.parent is not None:
            seam[i] = seam[s.parent]
            below[i] = s.call is not None and s.name != "nnmf"
        seam[i] = seam[i] or s.name.startswith("seam.")

    in_marks = lambda t: any(ms <= t <= me for ms, me in marks)  # noqa: E731
    device = [d for d in device if in_marks(launches.get(d[3], d[0]))]
    device, drift = device_clock(rec_spans, device, launches)
    found = sorted((launches[d[3]], k) for k, d in enumerate(device) if d[3] in launches)
    owner = [NO_LAUNCH] * len(device)
    for (t, k), i in zip(found, innermost(rec_spans, [t for t, _ in found])):
        owner[k] = i
    by_span, n_by_span = defaultdict(int), defaultdict(int)
    total = in_seam = owned = 0
    n_total = n_owned = 0
    dtoh = 0
    for (s, e, name, _), i in zip(device, owner):
        label = OUTSIDE if i is None else labels[i] if i != NO_LAUNCH else NO_LAUNCH
        is_launch = not name.startswith(profile.NOT_A_LAUNCH)
        by_span[label] += e - s
        total += e - s
        n_total += is_launch
        if is_launch:
            n_by_span[label] += 1
        if isinstance(i, int):
            in_seam += (e - s) * seam[i]
            owned += (e - s) * below[i]
            n_owned += is_launch and below[i]
            if name.startswith("Memcpy DtoH") and rec_spans[i].call is not None:
                dtoh += 1
    clock_excess = _clock(rec_spans, device, owner, [launches.get(d[3]) for d in device])

    _, gaps = profile._covered(profile._merge((s, e) for s, e, *_ in device), marks)
    gaps.sort(key=lambda g: g[0] + g[1])
    idle = defaultdict(int)
    for (s, e), i in zip(gaps, innermost(rec_spans, [(s + e) // 2 for s, e in gaps])):
        idle[OUTSIDE if i is None else labels[i]] += e - s

    in_call = [s for s in rec_spans if s.call is not None]
    reads = sum(s.counts["host_reads"] for s in in_call)
    sync_idx = innermost(rec_spans, sorted(t for t, _ in syncs))
    n_syncs = sum(1 for i in sync_idx if i is not None and rec_spans[i].call is not None)
    secs = lambda d: {k: v / 1e9 for k, v in d.items()}  # noqa: E731
    return {
        "metrics": {"seam_device_pct": 100.0 * in_seam / total if total else None},
        "device_by_span": _top(secs(by_span)),
        "launches_by_span": _top(n_by_span),
        "idle_by_span": _top(secs(idle)),
        "device_s": total / 1e9,
        "launches": n_total,
        "owned_device_pct": 100.0 * owned / total if total else None,
        "owned_launches_pct": 100.0 * n_owned / n_total if n_total else None,
        "host_reads": reads,
        "trace_dtoh_copies": dtoh,
        "trace_syncs": n_syncs,
        "front_door_reads": sum(s.counts["host_reads"] for s in in_call
                                if s.name == "nnmf.checks"),
        "clock_excess_us": None if clock_excess is None else clock_excess / 1e3,
        "device_clock_drift_us": drift / 1e3,
        "clock_ok": clock_excess is None or clock_excess <= CLOCK_SLACK_NS,
    }


def _clock(rec_spans, device, owner, launched_at):
    """The most by which a device interval leaves the span that its read
    waits for, in ns: for each span whose last child is a ``host_read``
    and that launched nothing after that read began, every interval
    launched inside it must start after the span begins and end by its
    end.  None where no span ends in a read."""
    last = {}
    for i, s in enumerate(rec_spans):
        if s.parent is not None:
            last[s.parent] = i
    waits = {p: c for p, c in last.items() if rec_spans[c].name == READ}
    per_span = defaultdict(list)  # span that ends in a read -> intervals
    for k, i in enumerate(owner):
        j = i if isinstance(i, int) else None
        while j is not None:
            if j in waits:
                per_span[j].append(k)
            j = rec_spans[j].parent
    worst = None
    for j, ks in per_span.items():
        read = rec_spans[waits[j]]
        if any(launched_at[k] > read.start_ns for k in ks if owner[k] != waits[j]):
            continue  # work launched after the read: the span does not end in it
        for k in ks:
            s, e = device[k][:2]
            excess = max(rec_spans[j].start_ns - s, e - rec_spans[j].end_ns)
            worst = excess if worst is None else max(worst, excess)
    return worst
