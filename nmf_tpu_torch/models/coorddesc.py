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
from ..utils import spans
from ..utils.dtypes import cbrt_eps
from .common import Result, nmf_skeleton, register_batched, register_solver

__all__ = ["CoordinateDescent"]

_REGULARIZATION = ("both", "components", "transformation", "none")


@dataclasses.dataclass(frozen=True)
class CoordinateDescent:
    """Options for coordinate descent.

    ``alpha`` scales the regularization; ``l1ratio`` mixes L1 vs L2;
    ``regularization`` selects whether it hits H ("components"),
    W ("transformation"), "both" or "none".  ``shuffle`` randomizes the
    component order each sweep; pass ``generator`` (a CPU
    ``torch.Generator``) for a deterministic stream.  Each solve draws from
    a copy of its state and leaves the generator as it was."""

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
    hess = spans.host_read(torch.diagonal(HHt), "tolist")
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
    """The solve's own shuffle stream: a new generator that starts where the
    options' generator stands, which is never advanced, so one options
    object solved twice gives one result (as the JAX package's key does)."""
    gen = torch.Generator()
    if upd.generator is None:
        return (gen.manual_seed(0),)
    return (gen.set_state(upd.generator.get_state()),)


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

    with spans.span("half.W"):
        W = _halfstep(X, W, H, l1W, l2W, permW)
    if upd.update_H:
        with spans.span("half.H"):
            H = _halfstep(matops.transpose(X), H.T, W.T, l1H, l2H, permH).T
    return W, H, (gen,)


def _halfstep_lanes(X, W, H, l1, l2, perm):
    """``_halfstep`` of m lanes at once: ``W`` ``(m, rows, k)``, ``H``
    ``(m, k, cols)``; every lane visits the components in ``perm``.  X
    enters once, through one product of width ``m * k``; the Grams are taken
    lane by lane.  A column step takes each lane's gradient with the
    ``torch.addmv`` of ``_halfstep`` (a matrix-vector product streams the
    lane's W once, and keeps its bits), then steps column c of every lane in
    one batch; a lane whose Hessian entry is 0 keeps that column.  Returns a
    new tensor with ``W``'s layout."""
    m, rows, k = W.shape
    eye = torch.eye(k, dtype=W.dtype, device=W.device)
    HHt = torch.stack([h @ h.T + l2 * eye for h in H])
    XHt = (matops.mm(X, H.permute(2, 0, 1).reshape(H.shape[2], m * k)) - l1
           ).view(rows, m, k).transpose(0, 1)
    hess_t = torch.diagonal(HHt, dim1=1, dim2=2)
    # one host read per half-step: a lane's component with a zero Hessian
    # keeps its column
    hess = spans.host_read(hess_t, "tolist")
    # ``_halfstep`` divides by a Python float, which torch applies on the
    # card as a multiply by its float32 reciprocal and on the CPU as a
    # division: the lanes do the same with their own entries
    safe = torch.where(hess_t == 0, 1, hess_t)
    if W.is_cuda:
        recip = safe.reciprocal()
        scale = lambda g, c: g.mul_(recip[:, c : c + 1])  # noqa: E731
    else:
        scale = lambda g, c: g.div_(safe[:, c : c + 1])  # noqa: E731
    W = W.clone()
    grad = W.new_empty((m, rows))
    for c in perm:
        zero = [hess[lane][c] == 0 for lane in range(m)]
        if all(zero):
            continue
        # grad[l, i] = sum_r HHt[l, r, c] * W[l, i, r] - XHt[l, i, c]
        for lane in range(m):
            torch.addmv(XHt[lane, :, c], W[lane], HHt[lane, :, c], beta=-1,
                        out=grad[lane])
        col = W[:, :, c]
        if any(zero):
            keep = torch.tensor(zero, device=W.device)[:, None]
            col.copy_(torch.where(keep, col, (col - scale(grad, c)).clamp_min(0)))
        else:
            col.sub_(scale(grad, c)).clamp_min_(0)
    return W


def _update_lanes(upd: CoordinateDescent, state, X, W, H):
    """One sweep of every lane (``W`` ``(m, p, k)``, ``H`` ``(m, k, n)``),
    the lanes at one iteration, so all draw the one permutation that
    ``_update`` would draw there."""
    (gen,) = state
    k = W.shape[2]
    l1W, l2W, l1H, l2H = _regsplit(upd)
    if upd.shuffle:
        permW = torch.randperm(k, generator=gen).tolist()
        permH = torch.randperm(k, generator=gen).tolist()
    else:
        permW = permH = range(k)
    with spans.span("half.W"):
        W = _halfstep_lanes(X, W, H, l1W, l2W, permW)
    if upd.update_H:
        with spans.span("half.H"):
            H = _halfstep_lanes(matops.transpose(X), H.transpose(1, 2),
                                W.transpose(1, 2), l1H, l2H, permH).transpose(1, 2)
    return W, H, (gen,)


def _objective(upd: CoordinateDescent, state, X, W, H):
    return mse_objective(X, W, H)


register_solver(CoordinateDescent, prepare=_prepare, update=_update,
                objective=_objective, renumber_safe=True)
register_batched(CoordinateDescent, update=_update_lanes)
