"""Successive Projection Algorithm (SPA) for separable NMF (Gillis & Vavasis
2013).

The ``spa`` initialization does all the work: anchor selection, then H by
batched FNNLS (``ops/fnnls.py``).  The ``SPA`` "solver" is a statistics
pass returning ``Result(W, H, 0, True, objv)``.

Dense X: the k anchor rounds each take one column-norm reduction, an argmax
and a rank-1 deflation of the residual.  Sparse X (a tiled store or a
general one) keeps no dense residual: deflating ``j`` times leaves
``R = (I - proj span{x_a1 .. x_aj}) Xn``, so an orthonormal basis of the
chosen columns and the residual column norms
``||r_c||^2 = ||x_c||^2 - sum_i (q_i' x_c)^2`` are enough, at one product
of X with a one-hot column and one with ``q'`` a round.  The argmax stays on the card (``torch.argmax`` gives the first
maximum, as ``jnp.argmax`` does), so the rounds need no host read.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config
from ..ops import matops
from ..ops.fnnls import fnnls
from ..ops.objectives import kl_objective, mse_objective
from ..utils.numeric import projectnn
from .common import Result

__all__ = ["SPA", "spa", "separable_data"]


def _spa_anchors_k(X, k: int):
    """Column-sum-normalize, then greedily pick k anchor columns by the
    largest residual norm with rank-1 deflation.  Returns (k,) int64 on X's
    device."""
    R = X / X.sum(dim=0, keepdim=True)
    ai = torch.zeros(k, dtype=torch.int64, device=X.device)
    for j in range(k):
        a = (R * R).sum(dim=0).argmax()
        p = R.index_select(1, a.view(1))[:, 0]
        R = R - torch.outer(p, p @ R) / (p @ p)
        ai[j] = a
    return ai


def _spa_anchors_sparse(X, k: int):
    """Anchor selection on a sparse X without a dense residual (see the
    module docstring): O(k * nnz) in all.  The column sums and the column
    sums of squares are the store's products with a ones column, so they add
    in a fixed order.  Returns (k,) int64 on the store's device."""
    p, n = X.shape
    dev = matops.device_probe(X).device
    cs = matops.colsums(X)
    inv_cs = torch.where(cs != 0, 1.0 / torch.where(cs != 0, cs, 1), 0)
    vals = matops.nnz_values(X)
    cols = matops.col_indices(X).long()
    Xn = matops.scale_values(X, vals * inv_cs[cols])  # columns sum to 1
    v = matops.nnz_values(Xn)
    norms2 = matops.colsums(matops.scale_values(Xn, v * v))
    Qb = torch.zeros((p, k), dtype=norms2.dtype, device=dev)
    ai = torch.zeros(k, dtype=torch.int64, device=dev)
    tiny = torch.finfo(norms2.dtype).tiny
    for j in range(k):
        a = norms2.argmax()
        onehot = torch.zeros((n, 1), dtype=norms2.dtype, device=dev)
        onehot.index_fill_(0, a.view(1), 1)
        x_a = matops.mm(Xn, onehot)[:, 0]  # the chosen column
        r = x_a - Qb @ (Qb.T @ x_a)
        q = r / torch.linalg.vector_norm(r).clamp_min(tiny)
        proj = matops.mtm(q[None, :], Xn)[0]  # q' Xn
        norms2 = (norms2 - proj * proj).clamp_min(0)
        Qb[:, j] = q
        ai[j] = a
    return ai


def _store_columns(X, ai):
    """Columns ``ai`` of a sparse X as a dense (p, len(ai)) tensor, their
    values copied from the CSR-order arrays.  The JAX package takes them as
    the product of X with one-hot columns, exact in float32 there; on the
    card the dense blocks' product (kernel 2) splits each value into two
    TF32 parts and gives ``x * 1`` to about 1e-7, not exactly, so the
    columns are gathered instead."""
    p, n = X.shape
    uniq, inv = torch.unique(ai, return_inverse=True)
    slot = torch.full((n,), -1, dtype=torch.int64, device=ai.device)
    slot[uniq] = torch.arange(uniq.numel(), device=ai.device)
    at = slot[matops.col_indices(X).long()]
    keep = at >= 0
    rows = matops.row_indices(X).long()[keep]
    Wu = torch.zeros((p, uniq.numel()), dtype=X.dtype, device=ai.device)
    Wu[rows, at[keep]] = matops.nnz_values(X)[keep].to(X.dtype)
    return Wu[:, inv]


@config.precision_scope()
def spa(X, k: int, *, device=config.DEFAULT_DEVICE):
    """SPA initialization: returns ``(W, H)`` with ``W = X[:, anchors]`` and
    ``H = argmin_{H >= 0} ||X - W H||`` by batched FNNLS (in float64, see
    ``fnnls``).  A sparse X (a tiled store, a ``SparseCSR`` or a torch sparse
    tensor) takes the basis-tracking anchor selection (no dense residual).  ``X`` must live on ``device``."""
    dev = config.resolve_device(device)
    X = matops.as_operand(X)
    config.check_on_device(dev, X=matops.device_probe(X))
    k = int(k)
    if matops.is_sharded_dense(X):
        raise ValueError(
            "spa takes a whole dense X, or a sparse one: a dense X cut over a "
            "mesh keeps no column whole on one device; run spa on X before it "
            "is cut (nnmf(X, k, init='spa', mesh=...) does)")
    if matops.is_sparse(X):
        W = _store_columns(X, _spa_anchors_sparse(X, k))
    else:
        X = X.contiguous()
        W = X.index_select(1, _spa_anchors_k(X, k))
    H = projectnn(fnnls(W, X, device=dev))
    return W, H


def separable_data(m: int, n: int, k: int, *, generator=None,
                   dtype=torch.float32, device=config.DEFAULT_DEVICE):
    """``(W, H)`` of an exactly separable problem: ``H = [I V]`` with its
    columns permuted and V's columns summing to 1.  ``generator`` (a CPU
    ``torch.Generator``; seed 0 when not given) draws on the host, so one
    seed gives one problem whatever the device."""
    dev = config.resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    W = torch.rand((m, k), generator=generator, dtype=dtype)
    V = torch.rand((k, n - k), generator=generator, dtype=dtype)
    V = V / V.sum(dim=0, keepdim=True)
    H = torch.cat([torch.eye(k, dtype=dtype), V], dim=1)
    H = H[:, torch.randperm(n, generator=generator)]
    return W.to(dev), H.to(dev)


@dataclasses.dataclass(frozen=True)
class SPA:
    """The SPA "solver": a statistics pass over factors produced by the
    ``spa`` initialization."""

    obj: str = "mse"

    def __post_init__(self):
        if self.obj not in ("mse", "div"):
            raise ValueError("Invalid value for obj.")

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        objective = mse_objective if self.obj == "mse" else kl_objective
        return Result(W, H, 0, True, objective(X, W, H))
