"""Projected alternating least squares with an L2 ridge (NMF.jl's
``ProjectedALS``)::

    H = max(0, (W'W + lambda I) \\ W'X)
    W = max(0, (X H') / (H H' + lambda I))

by Cholesky factorization of the k x k Grams, ``lambda = cbrt(eps(Float32))``
on both.  Objective ``0.5 ||X - W H||^2 + lambda/2 (||W||^2 + ||H||^2)``.
"""

from __future__ import annotations

import torch

from portbench.reference.common import EPS32, Products, Sparse, mse

LAMBDA = EPS32 ** (1 / 3)


def _cholesky(A):
    """Lower Cholesky factor of ``A``; all NaN where ``A`` is not positive
    definite in float32, so that a breakdown ends in a NaN answer."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def solve(X, W, H, iters: int, prod: Products):
    k = W.shape[1]
    eye = torch.eye(k, dtype=W.dtype, device=W.device)
    for _ in range(iters):
        if isinstance(X, Sparse):
            WtX = X.tmm(prod, X.vals, W).T
        else:
            WtX = prod.mm(W.T, X)
        H = torch.cholesky_solve(WtX, _cholesky(prod.mm(W.T, W) + LAMBDA * eye)).clamp_min(0)
        XHt = X.mm(prod, X.vals, H.T) if isinstance(X, Sparse) else prod.mm(X, H.T)
        W = torch.cholesky_solve(XHt.T, _cholesky(prod.mm(H, H.T) + LAMBDA * eye)).T.clamp_min(0)
    return W, H


def objective(X, W, H) -> float:
    W64, H64 = W.double(), H.double()
    return mse(X, W, H) + 0.5 * LAMBDA * float((W64 * W64).sum() + (H64 * H64).sum())
