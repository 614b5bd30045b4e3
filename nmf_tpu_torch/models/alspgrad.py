"""Alternating least squares via projected gradient (Lin 2007).

Each outer sweep runs two inner projected-gradient solves (H then W), each
with an adaptive backtracking line search (grow or shrink alpha, decided at
the first trial) and a projected-gradient-norm stopping rule.  The outer
updater multiplies ``tolg`` by 0.1 whenever an inner solve converges in a
single iteration.

Both inner solves are the same problem ``min_{Y >= 0} 0.5 || A Y - B ||^2``
given the Grams ``AtA = A'A`` (k x k) and ``AtB = A'B`` (k x m):

* H-update: ``A = W``, ``B = X``, ``Y = H``;
* W-update: ``A = H'``, ``B = X'``, ``Y = W'``.

So one subsolver serves both, X is touched once a sweep a factor (``W'X`` /
``XH'``), and every line-search trial costs one k x k @ k x m product and a
few reductions.

The nested control flow (PG iterations, each with up to ``traceiter``
backtracking trials) is one flat loop, as in the JAX package: a body is
either a gradient phase (a fresh ``G = AtA Y - AtB`` and the convergence
test) or one trial, chosen by the carried ``ls_it``, and both share the
body's one product by choosing its right operand (``Y`` or the trial
direction ``D``).  Where the loop ends depends on the data, so the host
reads the loop condition (one scalar) after every body.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import config
from ..ops import matops
from ..ops.objectives import mse_objective
from ..utils import spans
from ..utils.dtypes import cbrt_eps, eps as _eps, quartic_root_eps
from .common import Result, nmf_skeleton, register_solver

__all__ = ["ALSPGrad", "alspgrad_updateh", "alspgrad_updatew"]


# ---------------------------------------------------------------------------
# The projected-gradient subsolver


class _FlatCarry(NamedTuple):
    Y: torch.Tensor  # accepted iterate
    Yp: torch.Tensor  # grow-branch candidate buffer
    G: torch.Tensor  # gradient at Y, refreshed at each PG-iteration start
    alpha: torch.Tensor
    decr: torch.Tensor  # shrinking (True) vs growing (False) alpha
    ls_it: torch.Tensor  # 0 = next body is a gradient phase; >= 1 = trial number
    t: torch.Tensor  # PG iterations started
    converged: torch.Tensor


def _projgradnorm(G, Y):
    """sqrt(sum of g^2 over entries with g < 0 or y > 0)."""
    mask = (G < 0) | (Y > 0)
    return torch.where(mask, G * G, 0).sum().sqrt()


def _ls_trial(Y, Yp, G, alpha, decr, first, Yn, D, M, beta, sigma):
    """ONE backtracking trial of the adaptive line search, shared by the
    nested ``_line_search`` (verbose path) and the trial phase of
    ``_pg_subsolve``'s flat loop: the one copy of the accept/adapt math.

    ``Y`` is the base iterate the search started from, ``Yn = max(Y -
    alpha*G, 0)`` the candidate, ``D = Yn - Y`` and ``M = AtA @ D``.
    Returns ``(Y_out, Yp_next, alpha_next, decr_out, done)``."""
    dt = Y.dtype
    # growing alpha unchecked can overflow to inf; clamp so that
    # max(Y - alpha*G, 0) never gives NaN where G == 0
    alpha_cap = torch.finfo(dt).max / 2
    dv1 = (G * D).sum()
    dv2 = (M * D).sum()
    suff_decr = (1 - sigma) * dv1 + 0.5 * dv2 < 0
    # the first trial decides the direction and snapshots Yp <- Y
    decr = torch.where(first, ~suff_decr, decr)
    Yp_eff = torch.where(first, Y, Yp)
    # Frobenius isapprox(Yp, Yn, atol=eps(T))
    close = torch.linalg.vector_norm(Yp_eff - Yn) <= _eps(dt)
    take_n = decr & suff_decr  # the shrink branch accepts Yn
    take_p = ~decr & (~suff_decr | close)  # the grow branch accepts Yp
    done = take_n | take_p
    Y_out = torch.where(take_n, Yn, torch.where(take_p, Yp_eff, Y))
    alpha_next = torch.where(
        done, alpha,
        torch.where(decr, alpha * beta, torch.clamp_max(alpha / beta, alpha_cap)),
    )
    # growing and not done: remember this candidate (Yp <- Yn)
    Yp_next = torch.where(done | decr, Yp_eff, Yn)
    return Y_out, Yp_next, alpha_next, decr, done


def _scalars(Y, tolg, beta, sigma):
    """``tolg``, ``beta``, ``sigma`` as 0-d tensors of Y's type and device."""
    return (torch.as_tensor(v, dtype=Y.dtype).to(Y.device) for v in (tolg, beta, sigma))


def _flat_body(AtA, AtB, c: _FlatCarry, traceiter, tolg, beta, sigma) -> _FlatCarry:
    """One body of the flat loop: a gradient phase (``ls_it == 0``) or one
    backtracking trial, sharing the one product ``AtA @ where(is_grad, Y,
    D)``."""
    is_grad = c.ls_it == 0
    # trial candidate from the carried gradient (unused when is_grad)
    Yn = (c.Y - c.alpha * c.G).clamp_min(0)
    D = Yn - c.Y
    M = AtA @ torch.where(is_grad, c.Y, D)  # the body's one product

    # gradient phase: fresh G and the projected-norm convergence test
    G_new = M - AtB
    conv = _projgradnorm(G_new, c.Y) < tolg

    # trial phase: one backtracking step (M = AtA @ D in this phase)
    it = c.ls_it
    Y_trial, Yp_trial, alpha_trial, decr, done = _ls_trial(
        c.Y, c.Yp, c.G, c.alpha, c.decr, it == 1, Yn, D, M, beta, sigma)
    # alpha keeps its last adaptation even when the trials run out
    exhausted = ~done & (it >= traceiter)
    zero = torch.zeros_like(it)
    return _FlatCarry(
        Y=torch.where(is_grad, c.Y, Y_trial),
        Yp=torch.where(is_grad, c.Yp, Yp_trial),
        G=torch.where(is_grad, G_new, c.G),
        alpha=torch.where(is_grad, c.alpha, alpha_trial),
        decr=torch.where(is_grad, c.decr, decr),
        ls_it=torch.where(is_grad, torch.where(conv, zero, zero + 1),
                          torch.where(done | exhausted, zero, it + 1)),
        t=c.t + is_grad.to(c.t.dtype),
        converged=c.converged | (is_grad & conv),
    )


def _pg_subsolve(AtA, AtB, Y0, maxiter, traceiter, tolg, beta, sigma):
    """Solve ``min_{Y>=0} 0.5||A Y - B||^2`` by Lin's projected gradient with
    adaptive backtracking.  Returns ``(Y, t)`` with t (an int) the number of
    outer PG iterations.

    Alpha starts at 1 each call and persists across PG iterations.  If a
    line search exhausts ``traceiter`` trials without accepting, Y is left
    unchanged for that iteration."""
    dev = Y0.device
    tolg, beta, sigma = _scalars(Y0, tolg, beta, sigma)
    i32 = dict(dtype=torch.int32, device=dev)
    c = _FlatCarry(
        Y0, torch.zeros_like(Y0), torch.zeros_like(Y0),
        torch.ones((), dtype=Y0.dtype, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev),
        torch.zeros((), **i32), torch.zeros((), **i32),
        torch.zeros((), dtype=torch.bool, device=dev),
    )

    while spans.host_read(~c.converged & ((c.ls_it > 0) | (c.t < maxiter)),
                          "bool"):  # the host read
        c = _flat_body(AtA, AtB, c, traceiter, tolg, beta, sigma)
    return c.Y, spans.host_read(c.t, "tolist")


# ---------------------------------------------------------------------------
# The nested form, for the verbose table


def _line_search(AtA, Y, G, alpha, traceiter, beta, sigma):
    """The adaptive backtracking line search as a loop over
    :func:`_ls_trial`, a host read a trial.  Returns (Y, alpha,
    backtracks)."""
    Y_out, Yp = Y, torch.zeros_like(Y)
    decr = torch.zeros((), dtype=torch.bool, device=Y.device)
    it = 0
    done = False
    while not done and it < traceiter:
        it += 1
        first = torch.tensor(it == 1, device=Y.device)
        Yn = (Y - alpha * G).clamp_min(0)
        D = Yn - Y
        Y_out, Yp, alpha, decr, done_t = _ls_trial(
            Y, Yp, G, alpha, decr, first, Yn, D, AtA @ D, beta, sigma)
        done = spans.host_read(done_t, "bool")
    return Y_out, alpha, it


def _pg_step(AtA, AtB, Y, alpha, traceiter, tolg, beta, sigma):
    """One outer PG iteration: gradient, projected-norm test, line search.
    Returns (Y, alpha, pgnrm, backtracks, converged)."""
    G = AtA @ Y - AtB
    pgnrm = _projgradnorm(G, Y)
    converged = spans.host_read(pgnrm < tolg, "bool")
    if converged:
        return Y, alpha, pgnrm, 0, True
    Y, alpha, backtracks = _line_search(AtA, Y, G, alpha, traceiter, beta, sigma)
    return Y, alpha, pgnrm, backtracks, False


def _pg_solve_verbose(AtA, AtB, normB2, Y, maxiter, traceiter, tolg, beta, sigma):
    """Host-driven PG solve printing the per-iteration table (Iter / objv /
    objv.change / 1st-ord / alpha / back-tracks)."""
    tolg, beta, sigma = _scalars(Y, tolg, beta, sigma)

    def objective(Y):
        return spans.host_read(
            0.5 * ((Y * (AtA @ Y)).sum() - 2 * (AtB * Y).sum() + normB2), "float")

    print(
        f"{'Iter':>5}    {'objv':>12}    {'objv.change':>12}    "
        f"{'1st-ord':>12}    {'alpha':>8}    {'back-tracks':>12}"
    )
    objv = objective(Y)
    print(f"{0:5d}    {objv:12.5e}")
    alpha = torch.ones((), dtype=Y.dtype, device=Y.device)
    t = 0
    converged = False
    while not converged and t < maxiter:
        t += 1
        Y, alpha, pgnrm, backtracks, converged = _pg_step(
            AtA, AtB, Y, alpha, traceiter, tolg, beta, sigma)
        preobjv, objv = objv, objective(Y)
        print(
            f"{t:5d}    {objv:12.5e}    {objv - preobjv:12.5e}    "
            f"{spans.host_read(pgnrm, 'float'):12.5e}    "
            f"{spans.host_read(alpha, 'float'):8.4f}    {backtracks:12d}"
        )
    return Y, t


# ---------------------------------------------------------------------------
# The per-factor public solvers


def _h_problem(X, W):
    """The H-update's Grams: ``(W'W, W'X)``."""
    return W.T @ W, matops.mtm(W.T, X)


def _w_problem(X, H):
    """The W-update's Grams on transposed data: ``(HH', (XH')')``."""
    return H @ H.T, matops.mm(X, H.T).T.contiguous()


def _checked(X, W, H, device):
    dev = config.resolve_device(device)
    X = matops.as_operand(X)
    config.check_on_device(dev, X=matops.device_probe(X), W=W, H=H)
    return matops.contiguous(X)


@config.precision_scope()
def alspgrad_updateh(X, W, H, *, maxiter: int = 1000, traceiter: int = 20,
                     tolg: float | None = None, beta: float = 0.2,
                     sigma: float = 0.01, verbose: bool = False,
                     device=config.DEFAULT_DEVICE):
    """Solve for H with W fixed.  Returns ``(H, niters)``.  ``tolg`` defaults
    to ``cbrt(eps(T))``.  ``verbose`` prints the per-iteration table through
    a host-driven nested loop: the same math as the flat loop, whose
    reductions may round differently by about an ulp, so a verbose run can
    return other last bits and, in borderline cases, another count.  ``X``,
    ``W`` and ``H`` must live on ``device``."""
    X = _checked(X, W, H, device)
    if tolg is None:
        tolg = cbrt_eps(H.dtype)
    AtA, AtB = _h_problem(X, W)
    if verbose:
        return _pg_solve_verbose(AtA, AtB, matops.sq_norm(X), H, maxiter,
                                 traceiter, tolg, beta, sigma)
    return _pg_subsolve(AtA, AtB, H, maxiter, traceiter, tolg, beta, sigma)


@config.precision_scope()
def alspgrad_updatew(X, W, H, *, maxiter: int = 1000, traceiter: int = 20,
                     tolg: float | None = None, beta: float = 0.2,
                     sigma: float = 0.01, verbose: bool = False,
                     device=config.DEFAULT_DEVICE):
    """Solve for W with H fixed.  Returns ``(W, niters)``; the same defaults
    and verbose note as ``alspgrad_updateh``."""
    X = _checked(X, W, H, device)
    if tolg is None:
        tolg = cbrt_eps(W.dtype)
    AtA, AtB = _w_problem(X, H)
    Y0 = W.T.contiguous()
    if verbose:
        Wt, t = _pg_solve_verbose(AtA, AtB, matops.sq_norm(X), Y0, maxiter,
                                  traceiter, tolg, beta, sigma)
    else:
        Wt, t = _pg_subsolve(AtA, AtB, Y0, maxiter, traceiter, tolg, beta, sigma)
    return Wt.T.contiguous(), t


# ---------------------------------------------------------------------------
# The outer alternating solver


@dataclasses.dataclass(frozen=True)
class ALSPGrad:
    """Options for ALS projected gradient.  ``tolg`` defaults to
    ``eps(T)^(1/4)`` and decays by 10x whenever an inner solve converges in
    one iteration."""

    maxiter: int = 100
    maxsubiter: int = 200
    verbose: bool = False
    tol: float | None = None
    tolg: float | None = None
    update_H: bool = True

    def _resolved(self, dtype):
        upd = dataclasses.replace(
            self,
            tol=self.tol if self.tol is not None else cbrt_eps(dtype),
            tolg=self.tolg if self.tolg is not None else quartic_root_eps(dtype),
        )
        return upd, upd.tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, upd.maxiter, upd.verbose, tol, trace)


_TRACEITER = 20
_BETA = 0.2
_SIGMA = 0.01


def _prepare(upd: ALSPGrad, X, W, H):
    # tolg decays across outer iterations -> state
    return (torch.as_tensor(upd.tolg, dtype=W.dtype).to(W.device),)


def _update(upd: ALSPGrad, state, X, W, H):
    """One outer sweep: the inner H solve, the tolg decay, the inner W
    solve, the tolg decay."""
    (tolg,) = state
    if upd.update_H:
        with spans.span("half.H"):
            AtA, AtB = _h_problem(X, W)
            H, iterH = _pg_subsolve(AtA, AtB, H, upd.maxsubiter, _TRACEITER, tolg,
                                    _BETA, _SIGMA)
            if iterH == 1:
                tolg = tolg * 0.1
    with spans.span("half.W"):
        AtA, AtB = _w_problem(X, H)
        Wt, iterW = _pg_subsolve(AtA, AtB, W.T.contiguous(), upd.maxsubiter,
                                 _TRACEITER, tolg, _BETA, _SIGMA)
        if iterW == 1:
            tolg = tolg * 0.1
    return Wt.T.contiguous(), H, (tolg,)


def _objective(upd: ALSPGrad, state, X, W, H):
    return mse_objective(X, W, H)


register_solver(ALSPGrad, prepare=_prepare, update=_update,
                objective=_objective, renumber_safe=True)
