"""A frozen copy of how ``nmf_tpu_torch.nnmf(X, k, init=..., seed=s)`` draws
an NNDSVD start (``nndsvd``, ``nndsvda``, ``nndsvdar``), computed plainly in
float64, so that the reference starts where the program starts without
asking the program.

The draws, as ``nnmf`` makes them: a CPU ``torch.Generator`` seeded with
``s`` is split into three children (init, restarts, shuffle), and the init
child into two more (``gsvd``, ``gar``); a child is a new CPU generator
seeded with one ``torch.randint(0, 2**62)`` draw of its parent.  From
``gsvd`` the Gaussian test matrix ``(n, l)``, ``l = min(k + 10, p, n)``, in
float64, rounded to float32 as the program rounds it; for ``nndsvdar`` from
``gar`` ``r = rand(k)`` in float32.

The arithmetic, from the papers rather than from the program:

- the randomized SVD of Halko, Martinsson and Tropp (2011, Algorithms 4.4
  and 5.1): ``Q = qr(X Omega)``, two power iterations ``Q = qr(X qr(X' Q))``,
  ``B = Q' X``, ``U_B s V' = svd(B)``, ``U = Q U_B``, the first k triplets;
- NNDSVD of Boutsidis and Gallopoulos (2008): each pair ``u_j, v_j`` split
  into its positive and negative parts, the side of larger ``||x|| ||y||``
  kept (the positive side on a tie), scaled by ``sqrt(s_j m_j) / ||side||``;
  the entries off the kept side filled with 0 (``nndsvd``), ``mean(X)``
  (``nndsvda``), or ``mean(X) * 0.01 * r[j]`` (``nndsvdar``).  H is the
  kept side of ``v_j`` the same way, or zeros where the solver overwrites H
  before reading it (``zeroh``).

Where this departs from the program's order of operations: every basis is a
Householder QR (``torch.linalg.qr``), not a shifted CholeskyQR3 (whose last
pass leaves the basis's columns ``1 / sqrt(1 + l^2 eps)`` long, so that
the program's W and H come out that much smaller: 1.1e-3 at l = 138 in
float32); the products with X, the SVD and the mean are taken in float64
(the program's in float32, its mean in its own order of addition); the
start comes back in float64.  The singular vectors' signs do not matter:
flipping ``u_j`` and ``v_j`` together flips their parts and picks the same
side.  Nothing here imports the program.

``low=True`` is the control's start: the same steps in float32, every
product with X from TF32 operands (``common.Products(low=True)``).
"""

from __future__ import annotations

import torch

from portbench.reference.common import Products, Sparse, row_blocks
from portbench.reference.restarts import _children

OVERSAMPLE = 10
POWER_ITERS = 2
VARIANTS = ("nndsvd", "nndsvda", "nndsvdar")


def draws(nnmf_seed: int, n: int, k: int, l: int, init: str):
    """The test matrix ``(n, l)`` (float32 values, float64 type) and, for
    ``nndsvdar``, ``r`` (k,) (float32 values, float64 type), as ``nnmf``
    draws them from ``seed=nnmf_seed``."""
    ginit, _, _ = _children(torch.Generator().manual_seed(nnmf_seed), 3)
    gsvd, gar = _children(ginit, 2)
    omega = torch.randn((n, l), generator=gsvd, dtype=torch.float64)
    omega = omega.to(torch.float32).to(torch.float64)
    r = torch.rand(k, generator=gar, dtype=torch.float32).double() \
        if init == "nndsvdar" else None
    return omega, r


def _mm(X, D, prod: Products):
    """``X @ D`` in ``D``'s type (a dense X a block of rows at a time)."""
    if isinstance(X, Sparse):
        return X.mm(prod, X.vals, D)
    return torch.cat([prod.mm(X[b].to(D.dtype), D) for b in row_blocks(X)])


def _tmm(X, D, prod: Products):
    """``X' @ D`` in ``D``'s type."""
    if isinstance(X, Sparse):
        return X.tmm(prod, X.vals, D)
    return sum(prod.mm(X[b].to(D.dtype).T, D[b]) for b in row_blocks(X))


def rsvd(X, omega, k: int, prod: Products):
    """The first k singular triplets ``(U (p, k), s (k,), V (n, k))``, in
    ``omega``'s type."""
    Q = torch.linalg.qr(_mm(X, omega, prod)).Q
    for _ in range(POWER_ITERS):
        Q = torch.linalg.qr(_tmm(X, Q, prod)).Q
        Q = torch.linalg.qr(_mm(X, Q, prod)).Q
    B = _tmm(X, Q, prod).T  # (l, n)
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    return (Q @ Ub)[:, :k], s[:k], Vt[:k].T


def mean(X) -> torch.Tensor:
    p, n = X.shape
    if isinstance(X, Sparse):
        total = X.vals.double().sum()
    else:
        total = sum(X[b].double().sum() for b in row_blocks(X))
    return total / (p * n)


def nndsvd_factors(U, s, V, fill):
    """W ``(p, k)`` and H' ``(n, k)`` from the triplets; ``fill`` (k,) is
    the value of the entries off each component's kept side."""
    parts = lambda M: (M.clamp_min(0), (-M).clamp_min(0))  # noqa: E731
    (up, un), (vp, vn) = parts(U), parts(V)
    norm = lambda M: torch.linalg.vector_norm(M, dim=0)  # noqa: E731
    mp, mn = norm(up) * norm(vp), norm(un) * norm(vn)
    pos = mp >= mn
    scale = torch.sqrt(s * torch.where(pos, mp, mn))

    def side(Mp, Mn):
        kept = torch.where(pos, Mp, Mn)
        kn = norm(kept)
        return torch.where(kept > 0, kept * (scale / torch.where(kn > 0, kn, 1)), fill)

    return side(up, un), side(vp, vn)


def start(init: str, X, k: int, nnmf_seed: int, device, zeroh: bool = False,
          low: bool = False):
    """The program's start for ``nnmf(X, k, init=init, seed=nnmf_seed)``,
    worked out again: ``(W (p, k), H (k, n))`` on ``device``, in float64,
    or with ``low`` the control's in float32."""
    if init not in VARIANTS:
        raise ValueError(f"no reference start for init={init!r}")
    dtype = torch.float32 if low else torch.float64
    p, n = X.shape
    l = min(k + OVERSAMPLE, p, n)
    omega, r = draws(nnmf_seed, n, k, l, init)
    U, s, V = rsvd(X, omega.to(device, dtype), k, Products(low))
    if init == "nndsvd":
        fill = torch.zeros(k, dtype=dtype, device=device)
    elif init == "nndsvda":
        fill = mean(X).to(dtype).expand(k)
    else:
        fill = (mean(X) * 0.01 * r.to(device)).to(dtype)
    W, Ht = nndsvd_factors(U, s, V, fill)
    H = torch.zeros((k, n), dtype=dtype, device=device) if zeroh else Ht.T.contiguous()
    return W, H
