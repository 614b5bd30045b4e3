"""Objective functions.

The dense objectives never hold the whole ``W @ H`` for large problems: they
run over column blocks of H, one product and one reduction per block.  The
sparse objective uses the Gram identity and touches X through ``mm`` only.
"""

from __future__ import annotations

import torch

__all__ = ["sqL2dist", "mse_objective"]

# Column-block size used when evaluating objectives without materializing WH.
_BLOCK_N = 2048
# Matrices with fewer than this many entries just materialize WH.
_SMALL = 1 << 22  # 4M entries


def sqL2dist(a, b):
    """Sum of squared differences ``sum((a - b)^2)``."""
    d = a - b
    return (d * d).sum()


def _blockwise_sum(X, W, H, tilefun):
    """``sum_j tilefun(X[:, j_block], (W @ H)[:, j_block])`` without ever
    materializing the full ``W @ H``."""
    n = X.shape[1]
    bn = min(_BLOCK_N, n)
    total = torch.zeros((), dtype=X.dtype, device=X.device)
    for j0 in range(0, n, bn):
        total = total + tilefun(X[:, j0 : j0 + bn], W @ H[:, j0 : j0 + bn])
    return total


def mse_objective(X, W, H):
    """``0.5 * ||X - W@H||_F^2``.

    Sparse X: ``||X||^2 - 2<X, WH> + <W'W, HH'>`` with
    ``<X, WH> = <W, X @ H'>`` — one ``mm`` and one (p, k) temporary; WH is
    never materialized and the per-nonzero sampled form is avoided on
    purpose (it would build per-block panels over the dense store)."""
    from . import matops

    if matops.is_sparse(X):
        cross = (W * matops.mm(X, H.T)).sum()
        wh_sq = ((W.T @ W) * (H @ H.T)).sum()
        return 0.5 * (matops.sq_norm(X) - 2 * cross + wh_sq)
    if X.numel() <= _SMALL:
        return 0.5 * sqL2dist(X, W @ H)
    return 0.5 * _blockwise_sum(X, W, H, sqL2dist)
