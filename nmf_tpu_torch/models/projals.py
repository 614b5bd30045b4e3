"""Naive projected alternating least squares (L2-regularized).

Minimize ``0.5||X - WH||^2 + (lambda_w/2)||W||^2 + (lambda_h/2)||H||^2`` by
alternating unconstrained least squares (Cholesky on the k x k Grams)
followed by projection onto the non-negative orthant.  X enters only through
``matops.mtm`` (``W'X``) and ``matops.mm`` (``XH'``), once each a sweep.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import matops
from ..ops.linalg import pdrsolve, pdsolve
from ..ops.objectives import mse_objective
from ..utils import spans
from ..utils.dtypes import cbrt_eps
from ..utils.numeric import projectnn
from .common import Result, nmf_skeleton, register_solver

__all__ = ["ProjectedALS"]


@dataclasses.dataclass(frozen=True)
class ProjectedALS:
    """Options for projected ALS.  ``lambda_w`` / ``lambda_h`` are **L2**
    coefficients and default to ``cbrt(eps(T))`` (resolved at solve time)."""

    maxiter: int = 100
    verbose: bool = False
    tol: float | None = None
    update_H: bool = True
    lambda_w: float | None = None
    lambda_h: float | None = None

    def _resolved(self, dtype):
        ce = cbrt_eps(dtype)
        upd = dataclasses.replace(
            self,
            tol=self.tol if self.tol is not None else ce,
            lambda_w=self.lambda_w if self.lambda_w is not None else ce,
            lambda_h=self.lambda_h if self.lambda_h is not None else ce,
        )
        return upd, upd.tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, upd.maxiter, upd.verbose, tol, trace)


def _prepare(upd: ProjectedALS, X, W, H):
    return ()


def _update(upd: ProjectedALS, state, X, W, H):
    """One sweep: H from the ridge-regularized normal equations and a
    projection, then W from the mirrored right-solve and a projection.

    The k x k Grams feed a Cholesky: were they rounded below float32 (TF32)
    their error could exceed the ridge and make them indefinite, which gives
    NaN factors.  The solve's precision scope holds cuBLAS at IEEE float32,
    so the plain ``@`` is exact float32 here."""
    k = W.shape[1]
    eye = torch.eye(k, dtype=W.dtype, device=W.device)
    if upd.update_H:
        with spans.span("half.H"):
            WtW = W.T @ W + upd.lambda_h * eye
            H = projectnn(pdsolve(WtW, matops.mtm(W.T, X)))
    with spans.span("half.W"):
        HHt = H @ H.T + upd.lambda_w * eye
        W = projectnn(pdrsolve(matops.mm(X, H.T), HHt))
    return W, H, state


def _objective(upd: ProjectedALS, state, X, W, H):
    """``0.5||X-WH||^2 + 0.5*lambda_w||W||^2 + 0.5*lambda_h||H||^2``."""
    return (mse_objective(X, W, H) + 0.5 * upd.lambda_w * (W * W).sum()
            + 0.5 * upd.lambda_h * (H * H).sum())


register_solver(ProjectedALS, prepare=_prepare, update=_update,
                objective=_objective, renumber_safe=True)
