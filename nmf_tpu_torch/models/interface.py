"""The ``nnmf`` front door.

Same validation rules, init and algorithm dispatch, replicate policy and
``Result`` contract as the JAX package's ``nnmf``, and the same defaults:
``init="nndsvdar"``, ``alg="greedycd"``, ``maxiter=100``,
``tol=cbrt(eps(T)/100)``, ``replicates=1``.

Ported so far: ``alg`` in ``("cd", "greedycd", "multmse", "multdiv")`` with
``init`` in ``("random", "nndsvd", "nndsvda", "nndsvdar", "custom")``, so
``nnmf(X, k)`` runs with every default.  Every other documented value
raises ``NotImplementedError`` naming the value.
"""

from __future__ import annotations

import warnings

import torch

from .. import config
from ..init.initialization import child_generators, nndsvd, randinit
from ..ops import matops
from ..utils.dtypes import default_tol
from .common import Result, solve
from .coorddesc import CoordinateDescent
from .greedycd import GreedyCD
from .multupd import MultUpdate

__all__ = ["nnmf", "solve_replicates"]

_ALGS = ("projals", "alspgrad", "multmse", "multdiv", "cd", "greedycd", "spa")
_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "spa", "custom")
_PORTED_ALGS = ("cd", "greedycd", "multmse", "multdiv")
_PORTED_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "custom")


def _check_nonneg(A, name):
    if matops.is_sparse(A):
        ok = bool(matops.all_nonneg(A))
    else:
        ok = bool((A >= 0).all())
    if not ok:
        raise ValueError(f"The elements of {name} must be non-negative.")


def nnmf(
    X,
    k: int,
    *,
    init: str = "nndsvdar",
    initdata=None,
    alg: str = "greedycd",
    maxiter: int = 100,
    tol: float | None = None,
    replicates: int = 1,
    W0=None,
    H0=None,
    update_H: bool = True,
    verbose: bool = False,
    generator: torch.Generator | None = None,
    seed: int = 0,
    trace: bool = False,
    device=config.DEFAULT_DEVICE,
) -> Result:
    """Non-negative matrix factorization: ``X (p x n) ~ W (p x k) @ H (k x n)``.

    ``X`` is a dense array or tensor (moved to ``device``) or a ``TiledCSR``
    built on ``device``.  ``generator`` (a CPU ``torch.Generator``; seeded
    from ``seed`` when not given) drives every random draw.  ``initdata``
    hands the NNDSVD inits their singular triplets (see ``nndsvd``).
    """
    dev = config.resolve_device(device)
    if matops.is_sparse(X):
        config.check_on_device(dev, X=matops.device_probe(X))
    else:
        # the dense kernels read X row-major; a strided view is copied once
        X = torch.as_tensor(X).to(dev).contiguous()
    T = X.dtype
    p, n = X.shape

    _check_nonneg(X, "X")
    if k > min(p, n):
        raise ValueError("The value of k should not exceed min(size(X)).")
    if replicates < 1:
        raise ValueError("The value of replicates must be positive.")
    if not update_H and init != "custom":
        warnings.warn("Only W will be updated.")

    if init == "custom":
        if W0 is None or H0 is None:
            raise ValueError("To use :custom initialization, set W0 and H0.")
        W0 = torch.as_tensor(W0).to(device=dev, dtype=T)
        H0 = torch.as_tensor(H0).to(device=dev, dtype=T)
        _check_nonneg(W0, "W0")
        if tuple(W0.shape) != (p, k):
            raise ValueError("Invalid size for W0.")
        _check_nonneg(H0, "H0")
        if tuple(H0.shape) != (k, n):
            raise ValueError("Invalid size for H0.")
    elif W0 is not None or H0 is not None:
        warnings.warn("Ignore W0 and H0 except for :custom initialization.")

    if init not in _INITS:
        raise ValueError("Invalid value for init.")
    if alg not in _ALGS:
        raise ValueError("Invalid algorithm.")
    if alg == "spa" and init != "spa":
        raise ValueError("Invalid value for init, use :spa instead.")
    if init not in _PORTED_INITS:
        raise NotImplementedError(
            f"init={init!r} is not ported yet; ported: {_PORTED_INITS}"
        )
    if alg not in _PORTED_ALGS:
        raise NotImplementedError(
            f"alg={alg!r} is not ported yet; ported: {_PORTED_ALGS}"
        )

    if tol is None:
        tol = default_tol(T)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    ginit, grep, gshuf = child_generators(generator, 3)

    if init == "random":
        W, H = randinit(X, k, normalize=True, generator=ginit, device=dev)
    elif init in ("nndsvd", "nndsvda", "nndsvdar"):
        variant = {"nndsvd": "std", "nndsvda": "a", "nndsvdar": "ar"}[init]
        W, H = nndsvd(X, k, variant=variant, initdata=initdata, generator=ginit,
                      device=dev)
    else:
        W, H = W0, H0

    opts = dict(maxiter=maxiter, tol=float(tol), verbose=verbose, update_H=update_H)
    if alg == "multmse":
        alginst = MultUpdate(obj="mse", **opts)
    elif alg == "multdiv":
        alginst = MultUpdate(obj="div", **opts)
    elif alg == "greedycd":
        alginst = GreedyCD(**opts)
    else:
        alginst = CoordinateDescent(generator=gshuf, **opts)
    return solve_replicates(
        alginst, X, W, H, replicates=replicates, initH=True, generator=grep,
        trace=trace, device=dev,
    )


def solve_replicates(
    alginst, X, W, H, *, replicates: int, initH: bool, generator=None,
    trace: bool = False, device=config.DEFAULT_DEVICE,
) -> Result:
    """Multi-start policy: solve once from the requested init, then
    ``replicates - 1`` solves, one after the other, from fresh normalized
    random inits, keeping the minimum-objective Result."""
    dev = config.resolve_device(device)
    k = W.shape[1]
    ret = solve(alginst, X, W, H, trace, device=dev)
    if replicates == 1:
        return ret
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for sub in child_generators(generator, replicates - 1):
        Wr, Hr = randinit(
            X, k, zeroh=not initH, normalize=True, generator=sub, device=dev
        )
        tmp = solve(alginst, X, Wr, Hr, device=dev)
        if ret.objvalue > tmp.objvalue:
            ret = tmp
    return ret
