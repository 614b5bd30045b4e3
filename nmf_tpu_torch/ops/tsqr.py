"""Tall-skinny QR by shifted CholeskyQR3.

An orthonormal basis of the columns of a ``(p, l)`` panel from three passes
of

* ``G = Y'Y``        — the ``(l, l)`` Gram, exact float32 or float64 (no
                       TF32: ``rsvd`` runs in ``config.precision_scope``);
* ``R = chol(G)``    — upper Cholesky factor of the Gram plus a small shift;
* ``Q = Y @ R^-1``   — one ``(p, l) @ (l, l)`` product.

One pass loses orthogonality like ``eps * kappa(Y)^2``, so three are run
(CholeskyQR2 and one more), each Gram shifted by ``l * eps * trace(G)``
(shifted CholeskyQR, Fukaya et al. 2020): an exactly rank-deficient panel
(an NNDSVD sketch of a low-rank X has ``l > rank``) keeps a positive definite
Gram, and the later passes restore the orthonormality of the completed
basis.  Q has the column space of a Householder QR's, which is all
``rsvd`` needs.

Each pass reports through ``cholesky_ex`` whether its Gram was positive
definite; the reports are read once, after the last pass, so the three
passes run without a host synchronisation between them.
"""

from __future__ import annotations

import torch

from ..utils import spans

__all__ = ["cholesky_qr"]


def _one_pass(Y, relshift):
    l = Y.shape[1]
    eye = torch.eye(l, dtype=Y.dtype, device=Y.device)
    G = Y.T @ Y
    G = G + (relshift * torch.trace(G)) * eye
    R, info = torch.linalg.cholesky_ex(G, upper=True)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return Y @ Rinv, info


def cholesky_qr(Y, *, passes: int = 3):
    """Orthonormal basis Q ``(p, l)`` of the columns of a tall-skinny panel
    ``Y`` (the column space of ``qr(Y).Q``).  Raises
    ``torch.linalg.LinAlgError`` when a shifted Gram was not positive
    definite (a panel with NaN or inf in it)."""
    relshift = Y.shape[1] * torch.finfo(Y.dtype).eps
    Q = Y
    infos = []
    for _ in range(max(1, passes)):
        Q, info = _one_pass(Q, relshift)
        infos.append(info)
    if spans.host_read(torch.stack(infos).any(), "bool"):
        raise torch.linalg.LinAlgError(
            f"cholesky_qr: a shifted Gram was not positive definite "
            f"(cholesky_ex info per pass: {spans.host_read(torch.stack(infos), 'tolist')})"
        )
    return Q
