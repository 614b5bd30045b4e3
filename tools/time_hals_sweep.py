#!/usr/bin/env python3
"""The Fast-HALS sweep kernel (``csrc/hals.cu``) at the shapes of the
benchmark's ``ml25m-hals-r5`` cell, against its plain version (the column
loops the solver ran before it) and its bound, on one card:

    python3 tools/time_hals_sweep.py

Shapes (k 128): the W half, 162,541 rows, W row-major; the H half, 59,047
rows, W a transposed view (``H.T``); one lane (the first solve) and four
(the restarts), C the lanes' strided view of one product.  G = H H' from a
uniform H, C = W* G for another uniform W*.  Milliseconds by CUDA events,
median of 5 launches, each after 256 MB are written so that L2 holds none
of the operands.  Bound: W read, C read and W written once at 3.35 TB/s
against 2 rows k^2 flops a lane at 67 TFLOP/s.  Also the kernel's and the
plain float32 loops' largest difference from the plain loops in float64,
as a share of max|W|, and the kernel's registers, spills and shared memory
(``-Xptxas -v`` from the build log).  Prints one JSON line with the card's
name and power limit."""

import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"W": (162_541, 59_047), "H": (59_047, 162_541)}  # rows, other side
K = 128
MEM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

_flush = None


def flush_l2():
    global _flush
    if _flush is None:
        _flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    _flush.zero_()


def time_ms(fn, prepare, reps=5):
    """Median ms of ``fn(arg)`` on a fresh ``arg = prepare()`` each time."""
    fn(prepare())
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        arg = prepare()
        flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def problem(half, m):
    rows, other = SHAPES[half]
    g = torch.Generator(device="cuda").manual_seed(rows + m)
    H = torch.rand(m, K, other, device="cuda", generator=g)
    G = torch.stack([h @ h.T for h in H])
    del H
    target = torch.rand(m, rows, K, device="cuda", generator=g)
    C = torch.bmm(target, G).transpose(0, 1).contiguous().transpose(0, 1)
    del target
    W = torch.rand(m, rows, K, device="cuda", generator=g)
    if half == "H":
        W = W.transpose(1, 2).contiguous().transpose(1, 2)
    return W, G, C


def ptxas_lines(log):
    """The hals kernel's lines of a ``-Xptxas -v`` log."""
    keep, out = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "hals_sweep" in line
        if keep and re.search(r"registers|spill|smem", line):
            out.append(line.strip())
    return out


def main():
    sys.path.insert(0, str(ROOT))
    from nmf_tpu_torch.ops.cuda import build, hals

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script only runs on the card")
    build.load_kernels()
    log = next(build.BUILD.glob("libnmf_kernels_*.log"), None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": smi.strip(), "k": K,
           "ptxas": ptxas_lines(log.read_text()) if log else None, "cells": {}}
    for half in ("W", "H"):
        for m in (1, 4):
            W, G, C = problem(half, m)
            rows = W.shape[1]
            nbytes = m * 3 * rows * K * 4
            flops = m * 2 * rows * K * K
            t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            fresh = lambda: W.clone()  # noqa: E731
            rec = {"rows": rows, "lanes": m,
                   "ms": time_ms(lambda w: hals.hals_sweep(w, G, C, range(K)), fresh),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes_ms": t_bytes, "ops_ms": t_ops,
                   "plain_ms": time_ms(lambda w: hals.hals_sweep_plain(w, G, C, range(K)),
                                       fresh, reps=3),
                   "launches": 1}
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            want = hals.hals_sweep_plain(W.double(), G.double(), C.double(), range(K))
            scale = float(want.abs().max())
            for name, fn in (("kernel", hals.hals_sweep), ("plain", hals.hals_sweep_plain)):
                got = fn(W.clone(), G, C, range(K))
                rec[f"{name}_err_vs_float64"] = float((got.double() - want).abs().max()) / scale
            out["cells"][f"{half}_m{m}"] = rec
            del W, G, C, want
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
