"""Greedy coordinate descent (Hsieh & Dhillon, KDD 2011) as NMF.jl's
``GreedyCD`` states it, with no regularization.  The W half-step, for the
other factor H held fixed::

    P = H H',  Z = X H',  G = W P - Z
    S = max(0, W - G / (eps + diag(P))) - W         (the proposed steps)
    D = -G S - 0.5 diag(P) S^2                      (their scores)
    p_init = max(-1, max D)

then each row i, on its own: take its best coordinate ``q = argmax D[i]``;
while ``D[i, q] >= nu * p_init`` (``nu = 1e-3``) and fewer than ``k^2``
steps are taken, add ``S[i, q]`` to the row's step, ``S[i, q] P[q, :]`` to
its gradient, and score the row again (against the half-step's W, the steps
kept apart until the end); finally ``W = max(0, W + steps)``.  The H
half-step is the same on X' with the roles of W and H' swapped.  ``eps`` is
float32's, the type the configuration states.  Objective
``0.5 ||X - W H||^2``.

A row's steps depend on no other row, so every step is taken by all the
rows still going at once, gathered by plain indexing: the rows that have
stopped leave the working set, and a row's semantics are those of a loop
over it alone.  ``it`` is the same for every row still going, since all
started together.

The exact reference solves in float64 (``DTYPE``); the control stays in
float32, its products in TF32.
"""

from __future__ import annotations

import torch

from portbench.reference.common import EPS32, Products, Sparse, mse

DTYPE = torch.float64
NU = 1e-3


def _scores(W, G, denom, Pdiag):
    S = (W - G / denom).clamp_min(0) - W
    return S, -G * S - 0.5 * Pdiag * S * S


def _halfstep(Xmm, W, Ht, prod: Products):
    """``W`` (rows x k) against ``Ht`` (cols x k); ``Xmm(D)`` is ``X @ D``."""
    k = W.shape[1]
    P = prod.mm(Ht.T, Ht)
    Pdiag = P.diagonal()
    denom = EPS32 + Pdiag
    G = prod.mm(W, P) - Xmm(Ht)
    S, D = _scores(W, G, denom, Pdiag)
    threshold = NU * max(-1.0, float(D.max()))
    steps = torch.zeros_like(W)
    rows = torch.arange(W.shape[0], device=W.device)
    w = W
    for _ in range(k * k):
        q = D.argmax(1)
        going = D.gather(1, q[:, None]).squeeze(1) >= threshold
        if not bool(going.all()):
            rows, w, G, S, D, q = (a[going] for a in (rows, w, G, S, D, q))
        if rows.numel() == 0:
            break
        s = S.gather(1, q[:, None]).squeeze(1)
        steps[rows, q] += s
        G = G + s[:, None] * P[q]
        S, D = _scores(w, G, denom, Pdiag)
    return (W + steps).clamp_min(0)


def solve(X, W, H, iters: int, prod: Products):
    if isinstance(X, Sparse):
        fwd = lambda D: X.mm(prod, X.vals, D)  # noqa: E731
        bwd = lambda D: X.tmm(prod, X.vals, D)  # noqa: E731
    else:
        fwd = lambda D: prod.mm(X, D)  # noqa: E731
        bwd = lambda D: prod.mm(X.T, D)  # noqa: E731
    for _ in range(iters):
        W = _halfstep(fwd, W, H.T, prod)
        H = _halfstep(bwd, H.T, W, prod).T
    return W, H


def objective(X, W, H) -> float:
    return mse(X, W, H)
