"""The least time the card could take for an operation, from its shapes and
X's entries, and the time it took, by CUDA events.

Bytes: every input read once and every output written once; a sparse X is
its entries as compressed rows (a 4-byte value and a 4-byte column index an
entry, a 4-byte pointer a row).  Operations: 2 per multiply-add of the
products, ``2·nnz·k`` for the sparse ones.  The bound is the larger of bytes
over the memory rate and operations over the float32-exact rate
(``common.PEAK_*``), so it holds for any implementation that keeps float32's
precision.
"""

from __future__ import annotations

import statistics

import torch

from portbench.common import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

F = 4  # bytes of a float32 or an int32


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def bound_by(nbytes: float, flops: float) -> str:
    return "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_FP32_FLOPS else "operations"


def spmm(rows: int, cols: int, nnz: int, width: int):
    """(bytes, operations) of ``X @ D``: X (rows x cols, nnz entries), D
    (cols x width)."""
    return 2 * F * nnz + F * (rows + 1) + F * cols * width + F * rows * width, 2 * nnz * width


def sddmm(p: int, n: int, nnz: int, k: int):
    """``(W @ H)`` at X's entries: the entries' coordinates, W, H in; one
    value an entry out."""
    return 2 * F * nnz + F * k * (p + n) + F * nnz, 2 * nnz * k


def quotient(p: int, n: int, k: int, out_rows: int):
    """``W' (X / (W H + delta))`` (``out_rows`` = n) or ``(X / (W H +
    delta)) H'`` (``out_rows`` = p): X, W, H in, a (k x out_rows) result
    out; the products ``W H`` and the outer one."""
    return F * (p * n + p * k + k * n + k * out_rows), 4 * p * n * k


def gemm(p: int, n: int, k: int, out_rows: int):
    """``W' X`` (``out_rows`` = n) or ``X H'`` (``out_rows`` = p)."""
    return F * (p * n + k * (p + n - out_rows) + k * out_rows), 2 * p * n * k


def time_s(fn, reps: int = 10) -> float:
    """Median seconds of one ``fn()`` by CUDA events around it, after a
    warm-up call, with the 50 MB L2 overwritten before each call as the
    solve's other passes leave it."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 1e3)
    del flush
    return statistics.median(out)


def share(pairs) -> float:
    """Percent of the bound over ``pairs`` of ((bytes, operations),
    seconds) taken together."""
    return 100.0 * sum(bound_s(*c) for c, _ in pairs) / sum(t for _, t in pairs)


def solve_flops(alg: str, shape, nnz, k: int, iters: int, replicates: int,
                calls: int, reads: int) -> float:
    """Operations one solve needs, by its algorithm: ``iters`` iterations of
    each of ``replicates`` starts, the objective that ends each of the
    ``calls`` calls of ``nnmf``, and ``reads`` reads of the relative error.
    ``nnz`` is None for a dense X."""
    p, n = shape
    xk = 2 * (nnz if nnz is not None else p * n) * k  # one product with X
    gram = 2 * (p + n) * k * k
    if alg == "multdiv":
        it, obj = 4 * xk, xk  # two quotient passes of two products each
    elif alg == "cd":
        it, obj = 2 * xk + 2 * gram, xk + gram  # two products, two Grams, the columns
    elif alg == "projals":
        it, obj = 2 * xk + 2 * gram + 2 * k ** 3 // 3, xk
    else:
        raise ValueError(f"no count of operations for alg={alg!r}")
    return replicates * (iters * it + calls * obj) + reads * xk
