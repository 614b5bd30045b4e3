"""Objective functions.

The dense objectives never hold the whole ``W @ H`` for large problems.  A
float32 X on the card goes through the objective kernel
(``ops/cuda/objectives.py``); on the CPU and in float64 they run over column
blocks of H, one product and one reduction per block.  A dense X on a mesh
(``ShardedDense``) sums its blocks' objectives in float64.  The sparse MSE
objective uses the Gram identity and touches X through ``mm`` only; the
sparse KL objective samples ``W @ H`` at X's nonzeros.
"""

from __future__ import annotations

import torch

from .cuda.objectives import (
    dense_objective_plain,
    gkldiv,
    kl_objective_kernel,
    mse_objective_kernel,
    sqL2dist,
)
from .dense_shard import dense_objective

__all__ = ["sqL2dist", "gkldiv", "mse_objective", "kl_objective"]

# Matrices with fewer than this many entries just materialize WH.
_SMALL = 1 << 22  # 4M entries


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
    if matops.is_sharded_dense(X):
        return dense_objective(X, W, H, mse_objective)
    if X.numel() <= _SMALL:
        return 0.5 * sqL2dist(X, W @ H)
    if matops.is_dense_f32_on_card(X):
        return mse_objective_kernel(X, W, H)
    return dense_objective_plain(X, W, H, "mse")


def kl_objective(X, W, H):
    """``gkldiv(X, W@H)``.

    Sparse X: ``sum_{x>0}[x log(x/wh) - x] + sum_all(wh)`` with wh sampled
    at the nonzeros and ``sum_all(wh) = colsum(W) . rowsum(H)``; on a
    sharded store the first sum is taken block by block, in block order
    (``matops.nnz_sum``)."""
    from . import matops

    if matops.is_sparse(X):
        xv = matops.nnz_values(X)
        wh_at_nnz = matops.sddmm(W, H, X)
        pos = xv > 0
        safe_x = torch.where(pos, xv, 1)
        safe_wh = torch.where(wh_at_nnz > 0, wh_at_nnz, 1)
        nnz_term = matops.nnz_sum(X, torch.where(
            pos, safe_x * (safe_x.log() - safe_wh.log()) - xv, 0))
        mass = torch.dot(W.sum(dim=0), H.sum(dim=1))
        return nnz_term + mass
    if matops.is_sharded_dense(X):
        return dense_objective(X, W, H, kl_objective)
    if X.numel() <= _SMALL:
        return gkldiv(X, W @ H)
    if matops.is_dense_f32_on_card(X):
        return kl_objective_kernel(X, W, H)
    return dense_objective_plain(X, W, H, "kl")
