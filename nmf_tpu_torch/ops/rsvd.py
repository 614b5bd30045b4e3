"""Randomized SVD (Halko, Martinsson & Tropp 2011), the singular triplets
that NNDSVD starts from.

The sketch ``Y = X @ Omega`` and the power iterations are products with X
through ``matops.mm`` / ``mtm`` (on a ``TiledCSR`` the chunk, dense and quad
kernels at ``l = k + oversample`` columns); every tall-skinny basis is a
shifted CholeskyQR3 (``ops/tsqr.py``); only the small ``(l, n)`` SVD of
``B = Q'X`` runs as one dense ``torch.linalg.svd``.  Oversampling and two
power iterations are on by default, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import config
from . import matops
from .tsqr import cholesky_qr

__all__ = ["rsvd"]


def _rsvd_from_sketch(X, omega, k: int, n_iter: int):
    """Rank-``k`` triplets of X from the Gaussian test matrix ``omega``
    ``(n, l)``, on X's device."""
    Q = cholesky_qr(matops.mm(X, omega))  # (p, l)
    Xt = matops.transpose(X)
    for _ in range(n_iter):
        Z = cholesky_qr(matops.mm(Xt, Q))
        Q = cholesky_qr(matops.mm(X, Z))
    B = matops.mtm(Q.T, X)  # (l, n)
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    return U[:, :k], s[:k], Vt[:k, :].T


def rsvd(X, k: int, *, oversample: int = 10, n_iter: int = 2, generator=None,
         device=config.DEFAULT_DEVICE):
    """Rank-k randomized SVD of X.  Returns ``(U, s, V)`` with U ``(p, k)``,
    s ``(k,)``, V ``(n, k)``.  ``X`` is a dense array or tensor (moved to
    ``device``) or a ``TiledCSR`` built on ``device``.  The test matrix is
    drawn from ``generator`` (a CPU ``torch.Generator``; seed 0 when not
    given) on the host in float64, cast to X's type and moved to the device,
    so one seed gives one sketch whatever the device and the type."""
    dev = config.resolve_device(device)
    if matops.is_sparse(X):
        config.check_on_device(dev, X=matops.device_probe(X))
        dt = matops.device_probe(X).dtype
    else:
        X = torch.as_tensor(X).to(dev)
        dt = X.dtype
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    p, n = X.shape
    l = min(int(k) + int(oversample), min(p, n))
    omega = torch.randn((n, l), generator=generator, dtype=torch.float64).to(dev, dt)
    return _rsvd_from_sketch(X, omega, int(k), int(n_iter))
