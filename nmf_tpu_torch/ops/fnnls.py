"""Fast non-negative least squares (FNNLS, Bro & de Jong 1997), batched.

SPA's H estimate comes from here.  FNNLS is an active-set state machine
over a boolean passive-set mask, batched over the right-hand-side columns:
every column carries its own state, and one *step* advances all of them.

The passive-set linear solve uses the masking trick: rows and columns
outside the passive set are replaced by the identity, so a dense batched
``torch.linalg.solve`` gives every column's sub-system solution with zeros
elsewhere, with no shapes that depend on the data.  It runs in batches of a
fixed size (``SOLVE_BATCH``), so that a column's bits do not depend on the
width of the buffer it is solved in.

The state machine is flat: a step either adds a coordinate or takes one
backtracking step, chosen by a per-column ``phase`` flag, and holds exactly
one masked solve.  Columns that are finished or out of outer steps keep
their carry (``where(active, new, old)``), so a finished column is a fixed
point of the step and its result does not depend on which columns share
its batch.  The host reads the number of active columns after every step.

Lockstep: most columns finish after a few coordinate additions while a tail
drives the loop, and every step costs a k x k solve a column.  Above
``config.fnnls_cascade["off_cols"]`` columns the driver runs a compaction
cascade: masked steps over the buffer only while more columns are active
than fit the next, ``shrink`` times smaller, buffer; then the active
columns are gathered into a buffer of their own, down to buffers of
``min`` columns.  The results are those of the plain driver, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config
from ..utils import spans
from . import matops

__all__ = ["fnnls", "nnls_gram"]

# systems a call of the batched solve takes (see ``_masked_solve``)
SOLVE_BATCH = 1024


class _Carry(NamedTuple):
    x: torch.Tensor  # (n, k) current solutions
    P: torch.Tensor  # (n, k) bool passive sets
    w: torch.Tensor  # (n, k) dual / negative gradient
    atb: torch.Tensor  # (n, k) each column's A'b
    outer: torch.Tensor  # (n,) int32 committed or frozen outer steps
    done: torch.Tensor  # (n,) bool
    s: torch.Tensor  # (n, k) trial passive solutions
    phase: torch.Tensor  # (n,) bool: False = add a coordinate, True = backtrack
    it: torch.Tensor  # (n,) int32 backtracking steps (bound k + 1)


def _masked_solve(AtA, atb, P):
    """Solve each column's passive subsystem: rows and columns outside P
    become the identity.  ``atb``, ``P`` are (n, k); returns (n, k).

    The systems go to ``torch.linalg.solve`` in batches of exactly
    ``SOLVE_BATCH`` (the last one filled up with identity systems): on the
    card the library picks its LU routine by the batch's size, and another
    routine gives other last bits, so a column's solution would depend on
    how many columns share its step.  A fixed batch also bounds the memory
    to ``SOLVE_BATCH`` k x k matrices (and their LU copy)."""
    n, k = atb.shape
    eye = torch.eye(k, dtype=AtA.dtype, device=AtA.device)
    b = torch.where(P, atb, 0)
    out = torch.empty_like(b)
    for c0 in range(0, n, SOLVE_BATCH):
        Pc = P[c0 : c0 + SOLVE_BATCH]
        m = Pc.shape[0]
        if m < SOLVE_BATCH:  # identity systems fill the batch
            Pc = torch.cat([Pc, Pc.new_zeros((SOLVE_BATCH - m, k))])
        A = torch.where(Pc[:, :, None] & Pc[:, None, :], AtA, eye)
        bc = b[c0 : c0 + SOLVE_BATCH]
        if m < SOLVE_BATCH:
            bc = torch.cat([bc, bc.new_zeros((SOLVE_BATCH - m, k))])
        out[c0 : c0 + m] = torch.linalg.solve(A, bc)[:m]
    return out


def _step(AtA, c: _Carry, tol) -> _Carry:
    """One step of the flat FNNLS state machine for every column of ``c``
    (the masking by activity is the caller's).

    ADD picks the most violated inactive coordinate (or freezes the column
    through ``done``, counting the step in ``outer``); the trial passive
    solution is committed when feasible, else the column switches to
    BACKTRACK, whose alpha steps run until feasible or the ``k + 1`` bound.
    ``outer`` counts committed and frozen outer steps only."""
    k = AtA.shape[0]
    is_add = ~c.phase
    # ADD: the most violated inactive coordinate (unused under BACKTRACK)
    w_masked = torch.where(c.P, float("-inf"), c.w)
    j = w_masked.argmax(dim=1, keepdim=True)
    stop = c.P.all(dim=1) | (w_masked.gather(1, j)[:, 0] <= tol)
    newly_done = is_add & stop
    P_add = c.P.scatter(1, j, True)
    # BACKTRACK: an alpha step toward the (infeasible) trial solution
    sel = c.P & (c.s <= tol)
    denom = c.x - c.s
    nz = denom != 0
    ratio = torch.where(sel & nz, c.x / torch.where(nz, denom, 1), float("inf"))
    alpha = ratio.min(dim=1, keepdim=True).values
    x_bt = c.x + alpha * (c.s - c.x)
    P_bt = c.P & (x_bt > tol)
    # the one shared solve
    add = is_add[:, None]
    P_next = torch.where(add, P_add, P_bt)
    x_pre = torch.where(add, c.x, x_bt)
    s_next = _masked_solve(AtA, c.atb, P_next)
    it_next = torch.where(is_add, 0, c.it + 1).to(c.it.dtype)
    feasible = ~(P_next & (s_next <= tol)).any(dim=1)
    accept = feasible | (~is_add & (it_next >= k + 1))
    x_acc = torch.where(P_next, s_next, 0)
    w_acc = c.atb - x_acc @ AtA.T
    advance = ~newly_done
    commit = advance & accept
    adv, com = advance[:, None], commit[:, None]
    return _Carry(
        x=torch.where(com, x_acc, torch.where(adv, x_pre, c.x)),
        P=torch.where(adv, P_next, c.P),
        w=torch.where(com, w_acc, c.w),
        atb=c.atb,
        outer=c.outer + (newly_done | commit).to(c.outer.dtype),
        done=c.done | newly_done,
        s=torch.where(adv, s_next, c.s),
        phase=torch.where(advance, ~accept, c.phase),
        it=torch.where(advance, torch.where(accept, 0, it_next), c.it).to(c.it.dtype),
    )


def _init_carry(AtB_cols):
    """Initial carry from the (n, k) right-hand Grams."""
    n, k = AtB_cols.shape
    dev = AtB_cols.device
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    zeros_b = torch.zeros(n, dtype=torch.bool, device=dev)
    return _Carry(
        torch.zeros_like(AtB_cols), torch.zeros((n, k), dtype=torch.bool, device=dev),
        AtB_cols, AtB_cols, zeros_i, zeros_b, torch.zeros_like(AtB_cols),
        zeros_b.clone(), zeros_i.clone(),
    )


def _active(c: _Carry, max_outer):
    return ~c.done & (c.outer < max_outer)


def _masked_step(AtA, c: _Carry, active, tol) -> _Carry:
    """One step of the active columns; the others keep their carry."""
    new = _step(AtA, c, tol)
    pick = lambda nw, od: torch.where(  # noqa: E731
        active.reshape((-1,) + (1,) * (nw.dim() - 1)), nw, od)
    return _Carry(*(pick(nw, od) for nw, od in zip(new, c)))


def _run(AtA, c, tol, max_outer, cap):
    """Masked steps while more than ``cap`` columns are active (the host
    reads the count after every step).  Returns the carry, its active mask
    and their count."""
    act = _active(c, max_outer)
    while (n_active := spans.host_read(act.sum(), "tolist")) > cap:
        c = _masked_step(AtA, c, act, tol)
        act = _active(c, max_outer)
    return c, act, n_active


def nnls_gram(AtA, AtB, *, max_outer: int | None = None,
              cascade: bool | None = None, device=config.DEFAULT_DEVICE):
    """Batched FNNLS on precomputed Grams: minimize ``||A x_j - b_j||``
    subject to ``x_j >= 0`` for every column j of B, given ``AtA = A'A``
    (k x k) and ``AtB = A'B`` (k x n).  Returns the (k x n) solution in the
    Grams' type.

    ``cascade`` selects the compaction-cascade driver (None = on when the
    column count reaches ``config.fnnls_cascade["off_cols"]``); the results
    are the same bits either way.  ``AtA`` and ``AtB`` must live on
    ``device``."""
    dev = config.resolve_device(device)
    config.check_on_device(dev, AtA=AtA, AtB=AtB)
    with config.precision_scope():
        return _nnls_gram(AtA, AtB, max_outer, cascade)


def _nnls_gram(AtA, AtB, max_outer, cascade):
    k, n = AtA.shape[0], AtB.shape[1]
    if max_outer is None:
        max_outer = 3 * k + 10
    # NonNegLeastSquares.jl's fnnls tolerance: 10*eps*||AtA||_1*k
    tol = 10 * torch.finfo(AtA.dtype).eps * AtA.abs().sum(dim=0).max() * k
    knobs = config.fnnls_cascade
    if cascade is None:
        cascade = n >= knobs["off_cols"]
    caps = []  # buffer sizes below the first: n/shrink, n/shrink^2, ...
    if cascade:
        cur = n
        while cur // knobs["shrink"] >= knobs["min"]:
            cur //= knobs["shrink"]
            caps.append(cur)
    caps.append(0)  # the last buffer runs until no column is active

    carry = _init_carry(AtB.T.contiguous())
    x_full = None
    idx = None  # columns of the buffer; level 0 is the identity
    for cap in caps:
        carry, act, n_active = _run(AtA, carry, tol, max_outer, cap)
        # columns that finished at this level keep their solutions
        if idx is None:
            x_full = carry.x
        else:
            x_full[idx] = carry.x
        if n_active == 0:
            break
        loc = act.nonzero().squeeze(1)
        carry = _Carry(*(a[loc] for a in carry))
        idx = loc if idx is None else idx[loc]
    return x_full.T


def fnnls(A, B, *, precise: bool = True, cascade: bool | None = None,
          device=config.DEFAULT_DEVICE):
    """minimize ``||A X - B||_F`` subject to ``X >= 0``, column by column.
    ``B`` is dense or sparse (a tiled store, a ``SparseCSR`` or a torch sparse
    tensor).

    ``precise=True`` runs the k x k active-set iteration in float64 on
    either device and casts the result back to A's type (the JAX package
    does so wherever x64 is on, as in its tests; this package has no global
    switch, so the rule is the argument alone).  ``A'A`` is then a float64
    product; on a store ``A'B`` is the store's float32 product, widened.
    ``cascade`` as for :func:`nnls_gram`.  ``A`` and ``B`` must live on
    ``device``."""
    dev = config.resolve_device(device)
    B = matops.as_operand(B)
    config.check_on_device(dev, A=A, B=matops.device_probe(B))
    with config.precision_scope():
        dt = A.dtype
        work = torch.float64 if precise else dt
        Aw = A.to(work)
        AtA = Aw.T @ Aw
        if matops.is_structured(B):
            AtB = matops.mtm(A.T, B).to(work)
        else:
            AtB = Aw.T @ B.to(work)
        return _nnls_gram(AtA, AtB, None, cascade).to(dt)
