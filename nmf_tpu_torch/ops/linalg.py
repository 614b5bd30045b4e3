"""Small dense linear algebra on the ``k x k`` Grams: the Cholesky solves of
the projected ALS solver (``pdsolve``, ``pdrsolve``) on
``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``.  The Grams are
``k x k`` and the cost is small next to the ``p x n`` work, so no kernel of
their own.

A Gram that is not positive definite in the working precision gives NaN, as
the JAX package's ``cho_factor`` gives it, and no exception: a restart that
breaks down ends with a NaN objective, which the replicate policy never
keeps.  Nothing is read back to the host to find out."""

from __future__ import annotations

import torch

__all__ = ["pdsolve", "pdrsolve"]


def _cholesky(A):
    """Lower Cholesky factor of ``A``; all NaN where the factorization
    fails."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def pdsolve(A, x):
    """``inv(A) @ x`` for symmetric positive definite ``A``; ``x`` is a
    vector or a matrix."""
    L = _cholesky(A)
    if x.dim() == 1:
        return torch.cholesky_solve(x[:, None], L)[:, 0]
    return torch.cholesky_solve(x, L)


def pdrsolve(A, B):
    """``A @ inv(B)`` for symmetric positive definite ``B``, as
    ``(inv(B) @ A')'`` (B is symmetric)."""
    L = _cholesky(B)
    return torch.cholesky_solve(A.T, L).T
