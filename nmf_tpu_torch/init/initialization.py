"""Factor initializers: random and NNDSVD (``std``, ``a``, ``ar``).

NNDSVD (Boutsidis & Gallopoulos) splits each singular-vector pair into its
positive and negative parts and keeps the side with more mass.  All k
components are independent, so the construction is one set of elementwise
operations over the ``(p, k)`` / ``(n, k)`` singular-vector blocks, as in the
JAX package, with no loop over components.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import matops
from ..ops.rsvd import rsvd
from ..utils.numeric import normalize1_cols

__all__ = ["randinit", "nndsvd"]

_VARIANTS = {"std": 0, "a": 1, "ar": 2}


def child_generators(generator, n):
    """``n`` independent CPU generators drawn from ``generator``."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def randinit(X_or_shape, k: int, *, normalize: bool = False, zeroh: bool = False,
             generator=None, dtype=None, device=config.DEFAULT_DEVICE):
    """Uniform random init: ``W ~ U[0,1)`` (optionally column-sum
    normalized), ``H ~ U[0,1)`` or zeros when ``zeroh``.  ``generator`` is a
    CPU ``torch.Generator`` (seed 0 when not given): the numbers are drawn on
    the host and moved to ``device``, so one seed gives one init whatever the
    device."""
    dev = config.resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if hasattr(X_or_shape, "shape"):
        p, n = X_or_shape.shape
        dtype = dtype or X_or_shape.dtype
    else:
        p, n = X_or_shape
        dtype = dtype or torch.float32
    W = torch.rand((p, k), generator=generator, dtype=dtype).to(dev)
    if normalize:
        W = normalize1_cols(W)
    if zeroh:
        H = torch.zeros((k, n), dtype=dtype, device=dev)
    else:
        H = torch.rand((k, n), generator=generator, dtype=dtype).to(dev)
    return W, H


def _nndsvd_factors(U, s, V, meanX, variant: int, inith: bool, r, dtype):
    """NNDSVD from the triplets ``U (p, k)``, ``s (k,)``, ``V (n, k)``.

    Per component j: split ``u_j, v_j`` into +/- parts, pick the side with
    larger mass ``m = ||x_side|| * ||y_side||``, scale by
    ``sqrt(s_j * m) / ||side||``; entries on the other side are filled with
    ``v0``: 0 for ``std`` (variant 0), mean(X) for ``a`` (1), and
    ``mean(X) * 0.01 * r[j]`` for ``ar`` (2), with ``r (k,)`` the caller's
    uniform draw.  Returns ``W (p, k)`` and ``H' (n, k)`` (None unless
    ``inith``)."""
    U, s, V = (torch.as_tensor(a).to(dtype) for a in (U, s, V))
    k = U.shape[1]
    zero = torch.zeros((), dtype=dtype, device=U.device)
    one = torch.ones((), dtype=dtype, device=U.device)

    xp = torch.where(U > 0, U, zero)
    xn = torch.where(U > 0, zero, -U)  # includes zeros on the negative side
    yp = torch.where(V > 0, V, zero)
    yn = torch.where(V > 0, zero, -V)
    xpnrm = torch.sqrt((xp * xp).sum(dim=0))  # (k,)
    xnnrm = torch.sqrt((xn * xn).sum(dim=0))
    ypnrm = torch.sqrt((yp * yp).sum(dim=0))
    ynnrm = torch.sqrt((yn * yn).sum(dim=0))
    mp = xpnrm * ypnrm
    mn = xnnrm * ynnrm
    choose_p = mp >= mn  # (k,)

    meanX = torch.as_tensor(meanX, dtype=dtype, device=U.device)
    if variant == 0:
        v0 = torch.zeros(k, dtype=dtype, device=U.device)
    elif variant == 1:
        v0 = meanX.expand(k)
    else:
        v0 = meanX * torch.tensor(0.01, dtype=dtype) * torch.as_tensor(r).to(
            device=U.device, dtype=dtype)

    ss = torch.sqrt(s * torch.where(choose_p, mp, mn))  # (k,)

    def build(M, Mpos, Mneg, pnrm, nnrm):
        cpos = ss / torch.where(pnrm > 0, pnrm, one)
        cneg = ss / torch.where(nnrm > 0, nnrm, one)
        pos = torch.where(M > 0, Mpos * cpos, v0)  # x * c where x > 0, else v0
        neg = torch.where(M < 0, Mneg * cneg, v0)  # -x * c where x < 0, else v0
        return torch.where(choose_p, pos, neg)

    W = build(U, xp, xn, xpnrm, xnnrm)
    Ht = build(V, yp, yn, ypnrm, ynnrm) if inith else None
    return W, Ht


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


@config.precision_scope()
def nndsvd(X, k: int, *, zeroh: bool = False, variant: str = "std",
           initdata=None, generator=None, device=config.DEFAULT_DEVICE):
    """NNDSVD initialization: ``(W (p, k), H (k, n))``.

    ``initdata`` may be a ``(U, s, V)`` tuple (V as ``n x r`` columns) or an
    object with ``U`` / ``S`` / ``V`` attributes, of arrays or tensors;
    otherwise the triplets come from ``rsvd``.  ``variant`` is one of
    ``"std"``, ``"a"``, ``"ar"``.  ``generator`` (a CPU
    ``torch.Generator``; seed 0 when not given) drives the sketch and the
    ``ar`` draw.  ``X`` and the device as for ``rsvd``."""
    dev = config.resolve_device(device)
    X = matops.as_operand(X, dev)
    if matops.is_structured(X):
        config.check_on_device(dev, X=matops.device_probe(X))
        dt = matops.device_probe(X).dtype
    else:
        X = torch.as_tensor(X).to(dev)
        dt = X.dtype
    n = X.shape[1]
    ivar = _VARIANTS.get(variant)
    if ivar is None:
        raise ValueError("Invalid value for variant")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gsvd, gar = child_generators(generator, 2)

    if initdata is None:
        U, s, V = rsvd(X, k, generator=gsvd, device=dev)
    else:
        if isinstance(initdata, tuple):
            U, s, V = initdata
        else:
            U, s, V = initdata.U, initdata.S, initdata.V
        U, s, V = (_as_tensor(a).to(dev) for a in (U, s, V))
        U, s, V = U[:, :k], s[:k], V[:, :k]

    r = torch.rand(k, generator=gar, dtype=dt) if ivar == 2 else None
    meanX = matops.mean(X)
    W, Ht = _nndsvd_factors(U, s, V, meanX, ivar, not zeroh, r, dt)
    H = torch.zeros((k, n), dtype=dt, device=dev) if zeroh else Ht.T.contiguous()
    return W, H
