"""Lee-Seung multiplicative updates for the generalized KL divergence, as
NMF.jl's ``MultUpdate(obj=:div)`` states them::

    Q = X ./ (W H + delta)
    H .*= (W' Q) ./ (colsum(W)' + lambda)
    Q = X ./ (W H + delta)            (with the new H)
    W .*= (Q H') ./ (rowsum(H)' + lambda)

with ``delta = lambda = sqrt(eps(Float32))``.  For a sparse X the quotient
exists only at X's entries; a dense X is taken a block of rows at a time.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import EPS32, Products, Sparse, kl, row_blocks

DELTA = math.sqrt(EPS32)


def solve(X, W, H, iters: int, prod: Products):
    for _ in range(iters):
        if isinstance(X, Sparse):
            q = X.vals / (X.sampled(prod, W, H) + DELTA)
            H = H * (X.tmm(prod, q, W).T / (W.sum(0)[:, None] + DELTA))
            q = X.vals / (X.sampled(prod, W, H) + DELTA)
            W = W * (X.mm(prod, q, H.T) / (H.sum(1)[None, :] + DELTA))
            continue
        WtQ = torch.zeros_like(H)
        for b in row_blocks(X):
            WtQ += prod.mm(W[b].T, X[b] / (prod.mm(W[b], H) + DELTA))
        H = H * (WtQ / (W.sum(0)[:, None] + DELTA))
        QHt = torch.empty_like(W)
        for b in row_blocks(X):
            QHt[b] = prod.mm(X[b] / (prod.mm(W[b], H) + DELTA), H.T)
        W = W * (QHt / (H.sum(1)[None, :] + DELTA))
    return W, H


def objective(X, W, H) -> float:
    return kl(X, W, H)
