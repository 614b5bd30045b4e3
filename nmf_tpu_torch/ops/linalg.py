"""Small dense linear algebra on the ``k x k`` Grams: the Cholesky solves of
the projected ALS solver (``pdsolve``, ``pdrsolve``) on
``torch.linalg.cholesky`` and ``torch.cholesky_solve``.  The Grams are
``k x k`` and the cost is small next to the ``p x n`` work, so no kernel of
their own."""

from __future__ import annotations

import torch

__all__ = ["pdsolve", "pdrsolve"]


def pdsolve(A, x):
    """``inv(A) @ x`` for symmetric positive definite ``A``; ``x`` is a
    vector or a matrix."""
    L = torch.linalg.cholesky(A)
    if x.dim() == 1:
        return torch.cholesky_solve(x[:, None], L)[:, 0]
    return torch.cholesky_solve(x, L)


def pdrsolve(A, B):
    """``A @ inv(B)`` for symmetric positive definite ``B``, as
    ``(inv(B) @ A')'`` (B is symmetric)."""
    L = torch.linalg.cholesky(B)
    return torch.cholesky_solve(A.T, L).T
