"""The dense objectives as one kernel (``csrc/objectives.cu``):
``0.5 * ||X - W H||^2`` and ``gkldiv(X, W H)`` summed tile by tile, the
``p x n`` product never in device memory.  The kernel forms its tiles of
``W @ H`` with the routine of ``wtq`` (``csrc/quotient_tile.cuh``): a thread
block owns ``QT_EDGE`` columns and walks the rows, cut into runs as ``wtq``'s
walk is (``objective_splits``), each run adding its own partial.

A wrapper launches the kernel for float32 tensors on the card or raises; it
takes the plain version (column blocks of ``W @ H``, one reduction a block)
for tensors on the CPU and for float64 (the kernel is float32 only).
``build.launch_counts()`` counts kernel launches, and ``utils.spans``
counts them in the innermost span while it records.
"""

from __future__ import annotations

import torch

from .build import launch
from .mu import QT_EDGE, check_dense_problem, walk_splits

__all__ = [
    "mse_objective_kernel", "kl_objective_kernel", "dense_objective_plain",
    "sqL2dist", "gkldiv", "objective_splits",
]

KINDS = ("mse", "kl")
# Column-block size of the plain version.
_BLOCK_N = 2048


def sqL2dist(a, b):
    """Sum of squared differences ``sum((a - b)^2)``."""
    d = a - b
    return (d * d).sum()


def gkldiv(a, b):
    """Generalized Kullback-Leibler divergence ``sum(a*log(a/b) - a + b)``
    with the ``a == 0`` terms contributing ``b``."""
    a_pos = a > 0
    safe_a = torch.where(a_pos, a, 1)
    safe_b = torch.where(b > 0, b, 1)
    term = torch.where(a_pos, safe_a * (safe_a.log() - safe_b.log()) - a + b, b)
    return term.sum()


def _blockwise_sum(X, W, H, tilefun):
    """``sum_j tilefun(X[:, j_block], (W @ H)[:, j_block])`` without ever
    materializing the full ``W @ H``."""
    n = X.shape[1]
    bn = min(_BLOCK_N, n)
    total = torch.zeros((), dtype=X.dtype, device=X.device)
    for j0 in range(0, n, bn):
        total = total + tilefun(X[:, j0 : j0 + bn], W @ H[:, j0 : j0 + bn])
    return total


def dense_objective_plain(X, W, H, kind):
    """Plain version of the objective kernel: the sum over column blocks of
    ``W @ H``, never the whole product."""
    if kind == "mse":
        return 0.5 * _blockwise_sum(X, W, H, sqL2dist)
    return _blockwise_sum(X, W, H, gkldiv)


def objective_splits(p, n, sms) -> int:
    """Into how many runs the kernel cuts its walk over the ``p`` rows: a
    thread block owns ``QT_EDGE`` columns and all of k, so the output has
    one component a column for ``walk_splits``."""
    return walk_splits(n, p, 1, sms, QT_EDGE)


def _objective(X, W, H, kind):
    if not X.is_cuda or X.dtype == torch.float64:
        return dense_objective_plain(X, W, H, kind)
    p, n, k, W, H, xvec = check_dense_problem(X, W, H, "objective")
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    splits = objective_splits(p, n, sms)
    partial = torch.empty(-(-n // QT_EDGE) * splits, dtype=torch.float64,
                          device=X.device)
    out = torch.empty(1, dtype=torch.float32, device=X.device)
    launch(
        "dense_objective", X, W, H, partial, out, p, n, k, KINDS.index(kind),
        xvec, splits,
    )
    return out[0]


def mse_objective_kernel(X, W, H):
    """``0.5 * ||X - W @ H||_F^2`` for dense X, a 0-d tensor."""
    return _objective(X, W, H, "mse")


def kl_objective_kernel(X, W, H):
    """``gkldiv(X, W @ H)`` for dense X, a 0-d tensor."""
    return _objective(X, W, H, "kl")
