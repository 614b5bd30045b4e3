"""Fast-HALS coordinate descent (Cichocki & Phan; NMF.jl's
``CoordinateDescent`` with no regularization and no shuffle), one column of
a factor at a time::

    W half-step:  HHt = H H',  XHt = X H'
                  for c in 1..k:  W[:, c] = max(0, W[:, c] - (W HHt[:, c] - XHt[:, c]) / HHt[c, c])
    H half-step:  the same on X' with the roles of W and H' swapped

a component whose ``HHt[c, c]`` is 0 keeps its column.  Objective
``0.5 ||X - W H||^2``.

The exact reference solves in float64 (``DTYPE``): on some starts HALS's
path along the non-negativity bound amplifies rounding, and a float32
reference then departs from the exact path as far as the program does; in
float64 only the program's own rounding is measured.  The control stays in
float32, its products in TF32.
"""

from __future__ import annotations

import torch

from portbench.reference.common import Products, Sparse, mse

DTYPE = torch.float64


def _halfstep(Xmm, W, H, prod: Products):
    """``W`` (rows x k) against ``H`` (k x cols); ``Xmm(D)`` is ``X @ D``."""
    HHt = prod.mm(H, H.T)
    XHt = Xmm(H.T)
    hess = HHt.diagonal().tolist()
    W = W.clone()
    for c, h in enumerate(hess):
        if h == 0:
            continue
        grad = prod.mv(W, HHt[:, c]) - XHt[:, c]
        W[:, c] = (W[:, c] - grad / h).clamp_min(0)
    return W


def solve(X, W, H, iters: int, prod: Products):
    if isinstance(X, Sparse):
        fwd = lambda D: X.mm(prod, X.vals, D)  # noqa: E731
        bwd = lambda D: X.tmm(prod, X.vals, D)  # noqa: E731
    else:
        fwd = lambda D: prod.mm(X, D)  # noqa: E731
        bwd = lambda D: prod.mm(X.T, D)  # noqa: E731
    for _ in range(iters):
        W = _halfstep(fwd, W, H, prod)
        H = _halfstep(bwd, H.T, W.T, prod).T
    return W, H


def objective(X, W, H) -> float:
    return mse(X, W, H)
