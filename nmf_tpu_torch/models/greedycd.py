"""Greedy coordinate descent (Hsieh & Dhillon 2011) — the default ``nnmf``
algorithm.

The inner loop has a *data-dependent trip count per row*: each row greedily
applies its best coordinate until the best score drops below ``nu * p_init``
or ``k^2`` steps.  The rows are mutually independent, so one *masked step*
advances every row of a buffer at once: rows that are finished add exact
zeros, which leaves their gradient, scores and best coordinate unchanged, so
a finished row is a fixed point of the step and every row follows exactly
its own schedule however the rows are batched.

The Gram setup (``P = H H'``, ``Z = X H'``, ``G = W P - Z + lambda``) is
plain matrix products; X enters only through ``matops.mm`` and
``matops.transpose``.

Where the loop ends depends on the data, so the host reads the number of
active rows after every masked step (one small device-to-host copy).  A step
over a full-width buffer is a dozen elementwise passes over ``(rows, k)``
arrays, against which the read is small; over a small buffer the loop is
bound by launching those passes, read or no read.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import config
from ..ops import matops
from ..ops.objectives import mse_objective
from ..utils import spans
from ..utils.dtypes import cbrt_eps, eps
from ..utils.numeric import projectnn
from .common import Result, nmf_skeleton, register_batched, register_solver

__all__ = ["GreedyCD"]


@dataclasses.dataclass(frozen=True)
class GreedyCD:
    """Options for greedy CD.  ``lambda_w`` / ``lambda_h`` are **L1**
    coefficients."""

    maxiter: int = 100
    verbose: bool = False
    tol: float | None = None
    update_H: bool = True
    lambda_w: float = 0.0
    lambda_h: float = 0.0

    def __post_init__(self):
        if isinstance(self.maxiter, int) and self.maxiter <= 1:
            raise ValueError("maxiter must be greater than 1.")
        if isinstance(self.tol, (int, float)) and not (self.tol > 0):
            raise ValueError("tol must be positive.")
        if isinstance(self.lambda_w, (int, float)) and self.lambda_w < 0:
            raise ValueError("lambda_w must be non-negative.")
        if isinstance(self.lambda_h, (int, float)) and self.lambda_h < 0:
            raise ValueError("lambda_h must be non-negative.")

    def _resolved(self, dtype):
        tol = self.tol if self.tol is not None else cbrt_eps(dtype)
        return self, tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, self.maxiter, self.verbose, tol, trace)


class _Carry(NamedTuple):
    """State of the greedy schedule of a buffer of rows."""

    delta: torch.Tensor  # (nr, k) accumulated coordinate steps
    G: torch.Tensor  # (nr, k) gradients
    S: torch.Tensor  # (nr, k) proposed steps
    D: torch.Tensor  # (nr, k) score of each proposed step
    qi: torch.Tensor  # (nr,) current best coordinate
    it: torch.Tensor  # (nr,) int32 steps taken


def _scores(W, G, denom, Pdiag):
    """``S[r] = max(0, w - G / (eps + P[r, r])) - w`` and
    ``D[r] = -G * S - 0.5 * P[r, r] * S^2``."""
    S = (W - G / denom).clamp_min(0) - W
    D = -G * S - 0.5 * Pdiag * S * S
    return S, D


def _active(c: _Carry, threshold, max_inner):
    """Rows whose best score still clears the threshold, with steps left."""
    best = c.D.gather(-1, c.qi[..., None]).squeeze(-1)
    return (c.it < max_inner) & (best >= threshold)


def _masked_step(W, c: _Carry, active, P, denom, Pdiag, base=None) -> _Carry:
    """One coordinate step of every ``active`` row of the buffer; a finished
    row adds exact zeros and keeps its carry.  Only adds, multiplies, divides
    and maxima of single elements: a row's bits do not depend on which other
    rows share its buffer.  ``delta`` and ``G`` are updated in place.  With
    ``base`` (the lanes of ``_greedy_rows``) a row's Gram row is row
    ``base + qi`` of the lanes' stacked Grams ``P``."""
    q = c.qi[..., None]
    sv = torch.where(active, c.S.gather(-1, q).squeeze(-1), 0)[..., None]
    # one index a row: no two adds meet in one element, so no atomic order
    c.delta.scatter_add_(-1, q, sv)
    at = c.qi if base is None else (base + c.qi).reshape(-1)
    c.G.add_(sv * P.index_select(0, at).view(c.G.shape))
    S, D = _scores(W, c.G, denom, Pdiag)
    return _Carry(c.delta, c.G, S, D, D.argmax(dim=-1), c.it + active.to(torch.int32))


def _greedy_rows(W, G, S, D, P, denom, Pdiag, threshold, max_inner, base=None):
    """Every row's greedy coordinate schedule from the given initial scores;
    returns the accumulated per-row deltas.  ``G`` is consumed.

    Above ``config.greedycd_cascade["off_rows"]`` rows this runs the
    *compaction cascade*: masked steps over the buffer only while more rows
    are active than fit the next, ``shrink`` times smaller, buffer size; then
    the rows still active are gathered into a buffer of their own and the
    loop goes on there, down to buffer sizes of ``min`` rows.  Early sweeps
    (every row needs many steps) stay at full width, late sweeps (a few rows
    need many, most need a few) fall to a small buffer after a few steps.
    Below ``off_rows`` one buffer of all the rows runs until none is active.
    Either way a row's result is the same, bit for bit.

    With ``base`` the buffer holds the rows of m lanes, each with its own
    Grams (``models/replicates.py``): ``W``, ``G``, ``S`` and ``D`` are
    ``(m, rows, k)``, ``P`` the lanes' Grams stacked ``(m * k, k)``,
    ``denom`` and ``Pdiag`` ``(m, 1, k)``, ``threshold`` and ``base`` (each
    lane's first row of ``P``, ``lane * k``) ``(m, 1)``.  The cascade runs
    over all ``m * rows`` rows; a row gathered into a smaller buffer takes
    its lane's values along.  The deltas come back ``(m, rows, k)``."""
    k = W.shape[-1]
    rows = W.shape[:-1].numel()
    knobs = config.greedycd_cascade
    caps = []  # buffer sizes below the first: rows/shrink, rows/shrink^2, ...
    if rows >= knobs["off_rows"]:
        cur = rows
        while cur // knobs["shrink"] >= knobs["min"]:
            cur //= knobs["shrink"]
            caps.append(cur)
    caps.append(0)  # the last buffer runs until no row is active

    carry = _Carry(
        torch.zeros_like(W) if base is None else W.new_zeros(W.shape),
        G, S, D, D.argmax(dim=-1),
        torch.zeros(W.shape[:-1], dtype=torch.int32, device=W.device),
    )
    delta_full = carry.delta  # level 0 steps it in place
    idx = None  # rows of the buffer; level 0 is the identity
    Wsub, Wflat = W, None
    for cap in caps:
        act = _active(carry, threshold, max_inner)
        while (n_active := spans.host_read(act.sum(), "tolist")) > cap:  # the host read
            carry = _masked_step(Wsub, carry, act, P, denom, Pdiag, base)
            act = _active(carry, threshold, max_inner)
        if idx is not None:  # rows that finished at this level keep their deltas
            delta_full.view(rows, k)[idx] = carry.delta
        if n_active == 0:
            break
        loc = act.reshape(-1).nonzero().squeeze(1)
        if base is not None:  # the lanes' values, one a row from here on
            if idx is None:
                lane = loc // W.shape[1]
                denom, Pdiag = denom[:, 0][lane], Pdiag[:, 0][lane]
                threshold, base = threshold[:, 0][lane], base[:, 0][lane]
            else:
                denom, Pdiag, threshold, base = (
                    a[loc] for a in (denom, Pdiag, threshold, base))
        carry = _Carry(*(a.reshape(-1, *a.shape[act.dim():])[loc] for a in carry))
        idx = loc if idx is None else idx[loc]
        if Wflat is None:
            Wflat = W.reshape(rows, k)
        Wsub = Wflat[idx]
    return delta_full


def _halfstep(X, W, Ht, lam):
    """Update ``W`` (rows x k) holding the other factor ``Ht`` (cols x k)
    fixed.

    Above ``config.greedycd_cascade["slab_rows"]`` rows the update runs one
    row slab after the other: the full-width G/S/D/delta scratch is four
    ``(rows, k)`` arrays, while rows are mutually independent given the
    shared Grams, so slabbing only needs the global ``p_init`` agreed first
    (a maximum over a scoring pass).  Per-row schedules, and therefore
    results, are bit-identical to the full-width path (wherever ``w @ P``
    gives a row the same bits in a slab as in the whole)."""
    dt = W.dtype
    rows, k = W.shape

    P = Ht.T @ Ht  # (k, k)
    Z = matops.mm(X, Ht)  # (rows, k)
    Pdiag = torch.diagonal(P)
    denom = eps(dt) + Pdiag
    nu = 0.001
    max_inner = k * k
    floor = torch.full((), -1.0, dtype=dt, device=W.device)

    def scores(w, z):
        G = w @ P - z + lam
        return (G, *_scores(w, G, denom, Pdiag))

    slab_max = config.greedycd_cascade["slab_rows"]
    if rows <= slab_max:
        G, S, D = scores(W, Z)
        # p_init = max(-1, max_i D[i, q_i])
        threshold = nu * torch.maximum(floor, D.max())
        delta = _greedy_rows(W, G, S, D, P, denom, Pdiag, threshold, max_inner)
        return projectnn(W + delta)

    # The LAST slab starts at rows - slab and overlaps the previous one:
    # overlapped rows run the identical schedule twice and the second write
    # stores identical values, so results stay bit-exact.
    ns = -(-rows // slab_max)
    slab = -(-rows // ns)
    starts = [min(i * slab, rows - slab) for i in range(ns)]
    p_init = floor
    for s0 in starts:
        p_init = torch.maximum(p_init, scores(W[s0 : s0 + slab], Z[s0 : s0 + slab])[2].max())
    threshold = nu * p_init
    delta_full = torch.zeros_like(W)
    for s0 in starts:
        w = W[s0 : s0 + slab]
        G, S, D = scores(w, Z[s0 : s0 + slab])
        delta_full[s0 : s0 + slab] = _greedy_rows(
            w, G, S, D, P, denom, Pdiag, threshold, max_inner)
    return projectnn(W + delta_full)


def _halfstep_lanes(X, W, Ht, lam):
    """``_halfstep`` of m lanes at once: ``W`` ``(m, rows, k)``, ``Ht``
    ``(m, cols, k)``; returns the lanes' deltas ``(m, rows, k)``, which the
    caller adds and projects.

    X enters once, through one product of width ``m * k`` (each lane's
    columns side by side).  The Grams and ``w @ P`` are taken lane by lane,
    so a lane's scores have the bits its own half-step gives them wherever
    the wide product keeps a column's bits; the greedy loop then runs over
    the stacked buffer with each lane's own threshold (``_greedy_rows``), so
    one host read a masked step serves every lane.  Above
    ``config.greedycd_cascade["slab_rows"]`` stacked rows the lanes run in
    row slabs, all lanes a slab, after a scoring pass agrees each lane's
    ``p_init``."""
    dt = W.dtype
    m, rows, k = W.shape
    P = torch.stack([h.T @ h for h in Ht])  # (m, k, k)
    Z = matops.mm(X, Ht.permute(1, 0, 2).reshape(Ht.shape[1], m * k)).view(rows, m, k)
    Pdiag = torch.diagonal(P, dim1=1, dim2=2)[:, None]  # (m, 1, k)
    denom = eps(dt) + Pdiag
    Pflat = P.reshape(m * k, k)
    base = torch.arange(m, device=W.device)[:, None] * k
    nu = 0.001
    max_inner = k * k
    floor = torch.full((), -1.0, dtype=dt, device=W.device)

    def scores(w, z):
        G = torch.empty(w.shape, dtype=dt, device=W.device)
        for lane in range(m):
            torch.matmul(w[lane], P[lane], out=G[lane])
        G.sub_(z.transpose(0, 1)).add_(lam)
        return (G, *_scores(w, G, denom, Pdiag))

    def lane_max(D):
        return D.reshape(m, -1).amax(dim=1)

    slab_max = config.greedycd_cascade["slab_rows"]
    if m * rows <= slab_max:
        G, S, D = scores(W, Z)
        threshold = (nu * torch.maximum(floor, lane_max(D)))[:, None]
        return _greedy_rows(W, G, S, D, Pflat, denom, Pdiag, threshold,
                            max_inner, base)

    # as in _halfstep: the last slab overlaps the one before it
    ns = -(-(m * rows) // slab_max)
    slab = -(-rows // ns)
    starts = [min(i * slab, rows - slab) for i in range(ns)]
    p_init = floor.expand(m)
    for s0 in starts:
        p_init = torch.maximum(
            p_init, lane_max(scores(W[:, s0 : s0 + slab], Z[s0 : s0 + slab])[2]))
    threshold = (nu * p_init)[:, None]
    delta_full = W.new_zeros(W.shape)
    for s0 in starts:
        w = W[:, s0 : s0 + slab]
        G, S, D = scores(w, Z[s0 : s0 + slab])
        delta_full[:, s0 : s0 + slab] = _greedy_rows(
            w, G, S, D, Pflat, denom, Pdiag, threshold, max_inner, base)
    return delta_full


def _prepare(upd: GreedyCD, X, W, H):
    return ()


def _update(upd: GreedyCD, state, X, W, H):
    with spans.span("half.W"):
        W = _halfstep(X, W, H.T, upd.lambda_w)
    if upd.update_H:
        with spans.span("half.H"):
            H = _halfstep(matops.transpose(X), H.T, W, upd.lambda_h).T
    return W, H, state


def _update_lanes(upd: GreedyCD, state, X, W, H):
    """One sweep of every lane: ``W`` ``(m, p, k)``, ``H`` ``(m, k, n)``,
    both returned row-major, as ``_update`` returns one lane's."""
    with spans.span("half.W"):
        W = projectnn(W + _halfstep_lanes(X, W, H.transpose(1, 2), upd.lambda_w))
    if upd.update_H:
        with spans.span("half.H"):
            # H' + delta equals delta + H' element by element: the sum is
            # taken in H's row-major layout
            delta = _halfstep_lanes(matops.transpose(X), H.transpose(1, 2), W,
                                    upd.lambda_h)
            H = projectnn(H + delta.transpose(1, 2))
    return W, H, state


def _objective(upd: GreedyCD, state, X, W, H):
    """``0.5||X-WH||^2 + lambda_w*||W||_1 + lambda_h*||H||_1``."""
    return (mse_objective(X, W, H) + upd.lambda_w * W.abs().sum()
            + upd.lambda_h * H.abs().sum())


register_solver(GreedyCD, prepare=_prepare, update=_update,
                objective=_objective, renumber_safe=True)
register_batched(GreedyCD, update=_update_lanes)
