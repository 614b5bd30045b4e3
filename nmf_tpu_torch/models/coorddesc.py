"""Coordinate descent / Fast-HALS (Cichocki & Phan), scikit-learn semantics.

The reference's core loop is a sequential scalar Newton sweep over
(component t, row i).  The data dependency is only across *components* — all
rows are independent — so a half-step forms the Gram ``H H'`` and ``X H'``
(X enters only through ``matops.mm``), then sweeps the k components with
exact HALS semantics (each coordinate uses the already-updated values of the
other components): ``ops.cuda.hals.hals_sweep``, one kernel launch for every
lane on the card, the column loops of its plain version on the CPU and in
float64.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import matops
from ..ops.cuda.hals import hals_sweep
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
    """Update ``W`` (rows x k) holding ``H`` (k x cols) fixed.  ``perm`` (a
    sequence of ints) gives the component visit order; a component with a
    zero Hessian keeps its column.  Returns a new tensor with ``W``'s
    layout."""
    HHt = _gram(H, l2)
    XHt = _minus(matops.mm(X, H.T), l1)
    W = W.clone()
    hals_sweep(W[None], HHt[None], XHt[None], perm)
    return W


def _gram(H, l2):
    """``H H' + l2 I``, with ``l2`` added to the diagonal in place and only
    where it is not 0 (no identity formed: launches a half-step saves)."""
    HHt = H @ H.T
    if l2:
        HHt.diagonal().add_(l2)
    return HHt


def _minus(A, l1):
    """``A - l1``; ``A`` itself where ``l1`` is 0 (the same bits, no pass
    over the product)."""
    return A - l1 if l1 else A


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
    lane by lane, and one sweep steps every lane, each with the bits it has
    alone.  Returns a new tensor with ``W``'s layout."""
    m, rows, k = W.shape
    HHt = torch.stack([_gram(h, l2) for h in H])
    XHt = _minus(matops.mm(X, H.permute(2, 0, 1).reshape(H.shape[2], m * k)), l1
                 ).view(rows, m, k).transpose(0, 1)
    return hals_sweep(W.clone(), HHt, XHt, perm)


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
