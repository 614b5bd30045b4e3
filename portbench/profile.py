"""Solves under ``torch.profiler``, reduced to what the per-layer metrics and
the breakdown read.

Each profiled solve runs inside a ``record_function`` range and ends with a
synchronize, so its range on the host covers all of its device work.  Busy
time is the union of the device's activity intervals (kernels, copies,
sets) inside those ranges, so work on several streams at once counts once;
idle is the rest of the ranges.  Each idle gap is put down to the innermost
operator the host was in at the gap's midpoint.  The time of NCCL's kernels
(``collective_s``) is counted inside the ranges the same way: a kernel
that waits for a peer is busy, not idle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

MARK = "portbench.solve"
NOT_A_LAUNCH = ("Memcpy", "Memset")
GAPS_NAMED = 4096  # the longest gaps are named by what the host was doing
BETWEEN_OPS = "(no operator: Python between calls)"
NAME_CHARS = 160  # of a kernel's or operator's name in the breakdown
COLLECTIVE = "nccl"  # the kernels of NCCL's collectives


def profile_solve(run_one) -> dict:
    """``run_one()`` (a solve that ends in a synchronize) under the
    profiler, reduced by ``summarize``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            run_one()
    return summarize(prof.profiler.kineto_results.events())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, points):
    """For each of ``points`` (sorted), the name of the innermost of the
    nested ``host`` ranges (start, end, name) that holds it, or None."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _covered(merged, marks):
    """The ns of the ``merged`` intervals inside the ``marks``, and the gaps
    between them there."""
    busy_ns, gaps = 0, []
    starts = [s for s, _ in merged]
    for ms, me in marks:
        at = ms
        for s, e in merged[max(bisect.bisect_right(starts, ms) - 1, 0):]:
            if s >= me:
                break
            s, e = max(s, ms), min(e, me)
            if e <= s:
                continue
            if s > at:
                gaps.append((at, s))
            busy_ns += e - s
            at = max(at, e)
        if at < me:
            gaps.append((at, me))
    return busy_ns, gaps


def summarize(events) -> dict:
    marks, device, host = [], [], []
    thread = None
    for e in events:
        s, name = e.start_ns(), e.name()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name != MARK and not e.is_user_annotation():
                device.append((s, end, name))
        elif name == MARK:
            marks.append((s, end))
            thread = e.start_thread_id()
        else:
            host.append((s, end, name, e.start_thread_id()))
    host = [(s, end, name) for s, end, name, t in host if t == thread]
    busy_ns, gaps = _covered(_merge((s, e) for s, e, _ in device), marks)
    collective_ns, _ = _covered(_merge((s, e) for s, e, name in device
                                       if name.startswith(COLLECTIVE)), marks)
    window_ns = sum(me - ms for ms, me in marks)

    per_op = defaultdict(int)
    for s, e, name in device:
        per_op[name] += e - s
    gaps.sort(key=lambda g: g[0] - g[1])
    named = gaps[:GAPS_NAMED]
    mids = sorted(((s + e) // 2, e - s) for s, e in named)
    per_gap = defaultdict(int)
    for (_, length), name in zip(mids, _innermost(host, [m for m, _ in mids])):
        per_gap[name or BETWEEN_OPS] += length
    top = lambda d: [[k[:NAME_CHARS], v / 1e9]  # noqa: E731
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": window_ns / 1e9,
        "busy_s": busy_ns / 1e9,
        "collective_s": collective_ns / 1e9,
        "launches": sum(1 for *_, name in device if not name.startswith(NOT_A_LAUNCH)),
        "device_events": len(device),
        "device_ops": top(per_op),
        "idle_gaps": top(per_gap),
    }
