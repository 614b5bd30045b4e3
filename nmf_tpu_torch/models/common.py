"""Shared iteration skeleton for all iterative NMF solvers.

One generic loop parameterised by an updater: each solver registers
``prepare(upd, X, W, H) -> state``, ``update(upd, state, X, W, H) ->
(W, H, state)`` and ``objective(upd, state, X, W, H) -> scalar``.

The loop is a Python loop over eager tensor ops.  Each iteration reads the
``converged`` flag back to the host to decide whether to go on: one host sync
per iteration, accepted here — an iteration at the sizes this package is used
for is hundreds of kernel launches, and the read lets the loop stop at the
exact iteration the reference stops at.

The core ``_solve_while_from`` is resumable (state in, state out, iteration
bound): time-to-tolerance loops and checkpointing run it in chunks with
identical results.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..utils.numeric import safe_div

__all__ = [
    "Result",
    "Trace",
    "nmf_checksize",
    "stop_condition",
    "nmf_skeleton",
    "register_solver",
    "renumbered_problem",
    "unrenumber",
    "solve",
]


def nmf_checksize(X, W, H):
    """Validate that X (p x n), W (p x k), H (k x n) are consistent and
    return (p, n, k)."""
    p, n = X.shape
    k = W.shape[1]
    if not (W.shape[0] == p and tuple(H.shape) == (k, n)):
        raise ValueError("Dimensions of X, W, and H are inconsistent.")
    return p, n, k


# ---------------------------------------------------------------------------
# Result


class Trace(NamedTuple):
    """Per-iteration history: entry t holds the objective and the W&H
    relative change after iteration t+1; NaN beyond ``niters``."""

    objvalue: Any
    relchange: Any


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class Result:
    """Outcome of an NMF solve: factors, iteration count, convergence flag
    and the final objective value, with value-semantic ``==`` and ``hash``.
    ``trace`` optionally carries the per-iteration history and is excluded
    from equality and hashing."""

    __slots__ = ("W", "H", "niters", "converged", "objvalue", "trace")

    def __init__(self, W, H, niters, converged, objvalue, trace=None):
        if W.shape[1] != H.shape[0]:
            raise ValueError("Inner dimensions of W and H mismatch.")
        self.W = W
        self.H = H
        self.niters = int(niters)
        self.converged = bool(converged)
        self.objvalue = float(objvalue)
        self.trace = trace

    def __eq__(self, other):
        if not isinstance(other, Result):
            return NotImplemented
        return (
            np.array_equal(_np(self.W), _np(other.W))
            and np.array_equal(_np(self.H), _np(other.H))
            and self.niters == other.niters
            and self.converged == other.converged
            and self.objvalue == other.objvalue
        )

    def __hash__(self):
        return hash(
            (
                _np(self.W).tobytes(),
                _np(self.H).tobytes(),
                self.niters,
                self.converged,
                self.objvalue,
            )
        )

    def __repr__(self):
        return (
            f"Result(W={tuple(self.W.shape)}, H={tuple(self.H.shape)}, "
            f"niters={self.niters}, converged={self.converged}, "
            f"objvalue={self.objvalue})"
        )


# ---------------------------------------------------------------------------
# Convergence test


def stop_condition(W, preW, H, preH, tol):
    """Relative per-component change test.

    For each component j: ``dev_w = sum_i (W[i,j]-preW[i,j])^2`` and
    ``sum_w = sum_i (W[i,j]+preW[i,j])^2`` (and the same over row j of H);
    converged iff ``sqrt(dev) <= tol*sqrt(sum)`` for both factors of every
    component.  Returns 0-d tensors ``(converged, devmax)`` with
    ``devmax = max_j sqrt(max(dev_w/sum_w, dev_h/sum_h))`` (0/0 guarded
    to 0)."""
    dW = W - preW
    sW = W + preW
    dev_w = (dW * dW).sum(dim=0)
    sum_w = (sW * sW).sum(dim=0)
    dH = H - preH
    sH = H + preH
    dev_h = (dH * dH).sum(dim=1)
    sum_h = (sH * sH).sum(dim=1)
    tol = torch.as_tensor(tol, dtype=dev_w.dtype, device=dev_w.device)
    tol2 = tol * tol
    not_conv = (dev_w > tol2 * sum_w) | (dev_h > tol2 * sum_h)
    converged = ~not_conv.any()
    ratio = torch.maximum(safe_div(dev_w, sum_w), safe_div(dev_h, sum_h))
    dev = ratio.max().sqrt()
    return converged, dev


# ---------------------------------------------------------------------------
# Solver registry: maps option-dataclass type -> implementation triple


class SolverImpl(NamedTuple):
    prepare: Callable[..., Any]
    update: Callable[..., Any]
    objective: Callable[..., Any]
    # True (or a predicate of the options) when the solver touches X only
    # through mm/mtm and factor-wise reductions — its math is equivariant
    # under a row/col renumbering of the problem, so a degree-ordered
    # TiledCSR can run the whole solve in renumbered coordinates
    renumber_safe: Any = False


_IMPLS: dict[type, SolverImpl] = {}


def register_solver(options_cls, *, prepare, update, objective,
                    renumber_safe=False):
    """Register the (prepare, update, objective) implementation for an
    options dataclass."""
    _IMPLS[options_cls] = SolverImpl(prepare, update, objective, renumber_safe)
    return options_cls


def _impl_for(upd) -> SolverImpl:
    try:
        return _IMPLS[type(upd)]
    except KeyError:
        raise TypeError(f"No solver registered for {type(upd).__name__}") from None


# ---------------------------------------------------------------------------
# The skeleton


def _solve_while_from(upd, state, X, W, H, t0, maxiter, tol,
                      with_objective=True, history=None):
    """Resumable core: iterate from iteration ``t0`` with an existing solver
    state until converged or ``maxiter``.  Returns
    ``(W, H, state, t, converged, objv)`` including the solver state, so a
    host caller can stop, inspect and continue with identical semantics.
    ``with_objective=False`` skips the final objective pass and returns NaN
    in its slot.  ``history``, a pair of 1-d tensors, receives the objective
    and relative change after each iteration (entry t-1 for iteration t)."""
    impl = _impl_for(upd)
    t = int(t0)
    maxiter = int(maxiter)
    converged = False
    while not converged and t < maxiter:
        Wn, Hn, state = impl.update(upd, state, X, W, H)
        conv, dev = stop_condition(Wn, W, Hn, H, tol)
        W, H = Wn, Hn
        if history is not None:
            history[0][t] = impl.objective(upd, state, X, W, H)
            history[1][t] = dev
        t += 1
        converged = bool(conv)  # the one host sync of the iteration
    if with_objective:
        objv = impl.objective(upd, state, X, W, H)
    else:
        objv = torch.full((), float("nan"), dtype=W.dtype, device=W.device)
    return W, H, state, t, converged, objv


def _prepare(upd, X, W, H):
    return _impl_for(upd).prepare(upd, X, W, H)


def _objective(upd, state, X, W, H):
    return _impl_for(upd).objective(upd, state, X, W, H)


def _renumber_ok(upd, X) -> bool:
    """True when the whole solve can run in a degree-ordered TiledCSR's
    renumbered coordinate space (renumber_safe solver + perms present)."""
    from ..ops import matops

    if not (matops.is_tiled(X) and X.row_perm is not None):
        return False
    safe = _impl_for(upd).renumber_safe
    return bool(safe(upd)) if callable(safe) else bool(safe)


def renumbered_problem(X, W, H):
    """(X', W', H', perms) in X's renumbered coordinates: the factors are
    permuted ONCE and the tiling's perms are stripped so every product skips
    its two O(len*k) factor gathers.  Undo with ``unrenumber``.  Valid only
    for renumber-safe solvers: X consumed via mm/mtm and factor-wise
    reductions, whose math is permutation-equivariant (per-row/column results
    are identical; cross-row reductions like Grams and objectives differ only
    by float summation order)."""
    perms = (X.row_perm, X.row_rank, X.col_perm, X.col_rank)
    # CSR-order COO coordinates move into the renumbered space too; the CSR
    # *order* of the entries is untouched.  Slimmed tilings carry None.
    coo = {}
    if X.row_idx is not None:
        coo["row_idx"] = perms[1][X.row_idx.long()]
        coo["col_idx"] = perms[3][X.col_idx.long()]
    Xr = dataclasses.replace(
        X, row_perm=None, row_rank=None, col_perm=None, col_rank=None, **coo
    )
    # W'[sorted] = W[row_perm[sorted]]; H'[:, sorted] = H[:, col_perm[sorted]]
    return (
        Xr,
        W.index_select(0, perms[0].long()),
        H.index_select(1, perms[2].long()),
        perms,
    )


def unrenumber(W, H, perms):
    """Inverse of :func:`renumbered_problem` on the factors:
    ``W[orig] = W'[row_rank[orig]]``."""
    return W.index_select(0, perms[1].long()), H.index_select(1, perms[3].long())


def nmf_skeleton(upd, X, W, H, maxiter, verbose, tol, trace: bool = False) -> Result:
    """Run the shared iteration skeleton and wrap the outcome in a Result.
    ``upd`` is an options object hooked up via :func:`register_solver`."""
    nmf_checksize(X, W, H)
    renum = _renumber_ok(upd, X)
    if renum:
        X, W, H, perms = renumbered_problem(X, W, H)
    res = _nmf_skeleton_inner(upd, X, W, H, maxiter, verbose, tol, trace)
    if renum:
        Wn, Hn = unrenumber(res.W, res.H, perms)
        res = Result(
            Wn, Hn, res.niters, res.converged, res.objvalue, trace=res.trace
        )
    return res


def _nmf_skeleton_inner(upd, X, W, H, maxiter, verbose, tol, trace) -> Result:
    maxiter = int(maxiter)
    state = _prepare(upd, X, W, H)
    if trace:
        hist = tuple(
            torch.full((maxiter,), float("nan"), dtype=W.dtype, device=W.device)
            for _ in range(2)
        )
        W, H, state, t, converged, objv = _solve_while_from(
            upd, state, X, W, H, 0, maxiter, tol, history=hist
        )
        return Result(W, H, t, converged, objv, trace=Trace(*hist))
    if not verbose:
        W, H, state, t, converged, objv = _solve_while_from(
            upd, state, X, W, H, 0, maxiter, tol
        )
        return Result(W, H, t, converged, objv)

    # single steps with the reference's trace table
    objv = float(_objective(upd, state, X, W, H))
    start = time.time()
    print(
        f"{'Iter':<5}    {'Elapsed time':<13}    {'objv':<13}    "
        f"{'objv.change':<13}    {'(W & H).relchange':<13}"
    )
    print(f"{0:5d}    {0.0:13.6e}    {objv:13.6e}")
    hist = tuple(torch.zeros(1, dtype=W.dtype, device=W.device) for _ in range(2))
    t = 0
    converged = False
    while not converged and t < maxiter:
        W, H, state, _, converged, _ = _solve_while_from(
            upd, state, X, W, H, 0, 1, tol, with_objective=False, history=hist
        )
        t += 1
        preobjv, objv = objv, float(hist[0][0])
        print(
            f"{t:5d}    {time.time() - start:13.6e}    {objv:13.6e}    "
            f"{objv - preobjv:13.6e}    {float(hist[1][0]):13.6e}"
        )
    return Result(W, H, t, converged, objv)


def solve(alg, X, W, H, trace: bool = False, *,
          device=config.DEFAULT_DEVICE) -> Result:
    """Solve NMF with a configured algorithm object.  Returns a new Result;
    the caller's factors are not modified.  ``trace=True`` attaches
    per-iteration history (Result.trace).  ``X``, ``W`` and ``H`` must
    already live on ``device``."""
    from ..ops import matops

    dev = config.resolve_device(device)
    config.check_on_device(
        dev, X=matops.device_probe(X), W=W, H=H
    )
    if not matops.is_sparse(X):
        # the dense kernels read X row-major; a strided view is copied once
        X = X.contiguous()
    return alg._solve(X, W, H, trace)
