"""Coordinate descent / Fast-HALS (Cichocki & Phan), scikit-learn semantics.

The reference's core loop is a sequential scalar Newton sweep over
(component t, row i).  The data dependency is only across *components* — all
rows are independent — so the sweep is a loop over the k components, each
step updating one full column of W with a matrix-vector product
``W @ HHt[:, t]``.  Exact HALS semantics (each coordinate uses the
already-updated values of the other components) are preserved; only the row
dimension is vectorised.  The k-step loop is a Python loop over plain tensor
ops: X enters only through ``matops.mm`` before the loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import matops
from ..ops.objectives import mse_objective
from ..utils.dtypes import cbrt_eps
from .common import Result, nmf_skeleton, register_solver

__all__ = ["CoordinateDescent"]

_REGULARIZATION = ("both", "components", "transformation", "none")


@dataclasses.dataclass(frozen=True)
class CoordinateDescent:
    """Options for coordinate descent.

    ``alpha`` scales the regularization; ``l1ratio`` mixes L1 vs L2;
    ``regularization`` selects whether it hits H ("components"),
    W ("transformation"), "both" or "none".  ``shuffle`` randomizes the
    component order each sweep; pass ``generator`` (a CPU
    ``torch.Generator``) for a deterministic stream."""

    maxiter: int = 100
    verbose: bool = False
    tol: float | None = None
    update_H: bool = True
    alpha: float = 0.0
    l1ratio: float = 0.0
    regularization: str = "both"
    shuffle: bool = False
    generator: torch.Generator | None = None

    def __post_init__(self):
        if self.regularization not in _REGULARIZATION:
            raise ValueError(
                f"regularization must be one of {_REGULARIZATION}."
            )

    def _resolved(self, dtype):
        tol = self.tol if self.tol is not None else cbrt_eps(dtype)
        upd = self
        if self.generator is None:
            upd = dataclasses.replace(
                self, generator=torch.Generator().manual_seed(0)
            )
        return upd, tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, self.maxiter, self.verbose, tol, trace)


def _regsplit(upd: CoordinateDescent):
    """(l1W, l2W, l1H, l2H)."""
    alpha, l1r = float(upd.alpha), float(upd.l1ratio)
    aH = alpha if upd.regularization in ("both", "components") else 0.0
    aW = alpha if upd.regularization in ("both", "transformation") else 0.0
    return aW * l1r, aW * (1 - l1r), aH * l1r, aH * (1 - l1r)


def _halfstep(X, W, H, l1, l2, perm):
    """Update ``W`` (rows x k) holding ``H`` (k x cols) fixed, with the row
    loop vectorised.  ``perm`` (a sequence of ints) gives the component visit
    order.  Returns a new tensor."""
    k = H.shape[0]
    HHt = H @ H.T + l2 * torch.eye(k, dtype=W.dtype, device=W.device)
    XHt = matops.mm(X, H.T) - l1
    # one host read per half-step: a component with a zero Hessian is skipped
    hess = torch.diagonal(HHt).tolist()
    W = W.clone()
    for c in perm:
        if hess[c] == 0:
            continue
        # grad[i] = sum_r HHt[c, r] * W[i, r] - XHt[i, c]
        grad = torch.addmv(XHt[:, c], W, HHt[:, c], beta=-1)
        col = W[:, c]
        col.sub_(grad.div_(hess[c])).clamp_min_(0)
    return W


def _prepare(upd: CoordinateDescent, X, W, H):
    gen = upd.generator
    return (gen if gen is not None else torch.Generator().manual_seed(0),)


def _update(upd: CoordinateDescent, state, X, W, H):
    """One sweep: W first, then H by the transpose trick."""
    (gen,) = state
    k = W.shape[1]
    l1W, l2W, l1H, l2H = _regsplit(upd)

    if upd.shuffle:
        permW = torch.randperm(k, generator=gen).tolist()
        permH = torch.randperm(k, generator=gen).tolist()
    else:
        permW = permH = range(k)

    W = _halfstep(X, W, H, l1W, l2W, permW)
    if upd.update_H:
        H = _halfstep(matops.transpose(X), H.T, W.T, l1H, l2H, permH).T
    return W, H, (gen,)


def _objective(upd: CoordinateDescent, state, X, W, H):
    return mse_objective(X, W, H)


register_solver(CoordinateDescent, prepare=_prepare, update=_update,
                objective=_objective, renumber_safe=True)
