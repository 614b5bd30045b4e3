"""The ``nnmf`` front door.

Same validation rules, init and algorithm dispatch, replicate policy and
``Result`` contract as the JAX package's ``nnmf``, and the same defaults:
``init="nndsvdar"``, ``alg="greedycd"``, ``maxiter=100``,
``tol=cbrt(eps(T)/100)``, ``replicates=1``.

Every ``alg`` (``"projals"``, ``"alspgrad"``, ``"multmse"``, ``"multdiv"``,
``"cd"``, ``"greedycd"``, ``"spa"``) and every ``init`` (``"random"``,
``"nndsvd"``, ``"nndsvda"``, ``"nndsvdar"``, ``"spa"``, ``"custom"``) of the JAX
package is dispatched as there.

``mesh`` (``parallel.mesh.make_mesh``) runs the solve over a device mesh: the
init runs on X as given, then X is cut into one block a device of the mesh
(``parallel.sharding.shard_problem``: a store a block for a sparse X, a dense
block for a dense one) and W and H go to the mesh's lead device, where the
solve runs.  On a mesh that spans several processes (one process a card)
every process calls ``nnmf`` with the whole X, or its own blocks of it,
keeps its own blocks and returns the same ``Result``.

``parallel_replicates`` runs the ``replicates - 1`` random restarts as the
lanes of one lockstep solve (``models/replicates.py``) instead of one after
the other: the same starts, and each lane stops where its own solve would.
"""

from __future__ import annotations

import warnings

import torch

from .. import config
from ..init.initialization import child_generators, nndsvd, randinit
from ..ops import matops
from ..utils.dtypes import default_tol
from .alspgrad import ALSPGrad
from .common import Result, solve
from .coorddesc import CoordinateDescent
from .greedycd import GreedyCD
from .multupd import MultUpdate
from .projals import ProjectedALS
from .replicates import solve_replicates_batched
from .spa import SPA, spa

__all__ = ["nnmf", "solve_replicates"]

_ALGS = ("projals", "alspgrad", "multmse", "multdiv", "cd", "greedycd", "spa")
_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "spa", "custom")


def _solve_device(device, mesh):
    """The device a solve runs on: ``device``, which with a mesh must be
    the mesh's lead device."""
    dev = config.resolve_device(device)
    if mesh is not None and not config.same_device(dev, mesh.lead):
        raise ValueError(
            f"device={str(dev)!r} but the mesh's lead device is {mesh.lead}: a "
            "solve on a mesh runs on its lead device; pass device=mesh.lead")
    return dev


def _check_nonneg(A, name):
    ok = bool(matops.all_nonneg(A))
    if not ok:
        raise ValueError(f"The elements of {name} must be non-negative.")


@config.precision_scope()
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
    mesh=None,
    parallel_replicates: bool = False,
) -> Result:
    """Non-negative matrix factorization: ``X (p x n) ~ W (p x k) @ H (k x n)``.

    ``X`` is a dense array or tensor or a torch sparse tensor of any layout
    (moved to ``device``; a sparse one becomes a ``SparseCSR`` once), or a
    ``TiledCSR`` or ``SparseCSR`` built on ``device``.  ``generator`` (a CPU ``torch.Generator``; seeded
    from ``seed`` when not given) drives every random draw.  ``initdata``
    hands the NNDSVD inits their singular triplets (see ``nndsvd``).
    With ``mesh``, ``device`` must be the mesh's lead device (``mesh.lead``);
    X may also be a ``ShardedTiled`` or ``ShardedDense`` built on ``mesh``.
    ``parallel_replicates`` runs the restarts as one batch
    (``solve_replicates(..., parallel=True)``).
    """
    dev = _solve_device(device, mesh)
    X = matops.as_operand(X, dev)
    if matops.is_structured(X):
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

    if tol is None:
        tol = default_tol(T)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    ginit, grep, gshuf = child_generators(generator, 3)

    # ProjectedALS overwrites H before reading it, so H needn't be initialized
    initH = alg != "projals"

    if init == "random":
        W, H = randinit(X, k, zeroh=not initH, normalize=True, generator=ginit,
                        device=dev)
    elif init in ("nndsvd", "nndsvda", "nndsvdar"):
        variant = {"nndsvd": "std", "nndsvda": "a", "nndsvdar": "ar"}[init]
        W, H = nndsvd(X, k, variant=variant, zeroh=not initH, initdata=initdata,
                      generator=ginit, device=dev)
    elif init == "spa":
        W, H = spa(X, k, device=dev)
    else:
        W, H = W0, H0

    if mesh is not None:
        from ..parallel.sharding import shard_problem

        X, W, H = shard_problem(mesh, X, W, H)

    opts = dict(maxiter=maxiter, tol=float(tol), verbose=verbose, update_H=update_H)
    if alg == "projals":
        alginst = ProjectedALS(**opts)
    elif alg == "alspgrad":
        alginst = ALSPGrad(**opts)
    elif alg == "multmse":
        alginst = MultUpdate(obj="mse", **opts)
    elif alg == "multdiv":
        alginst = MultUpdate(obj="div", **opts)
    elif alg == "greedycd":
        alginst = GreedyCD(**opts)
    elif alg == "spa":
        alginst = SPA(obj="mse")
    else:
        alginst = CoordinateDescent(generator=gshuf, **opts)
    return solve_replicates(
        alginst, X, W, H, replicates=replicates, initH=initH, generator=grep,
        trace=trace, device=dev, mesh=mesh, parallel=parallel_replicates,
    )


@config.precision_scope()
def solve_replicates(
    alginst, X, W, H, *, replicates: int, initH: bool, generator=None,
    trace: bool = False, device=config.DEFAULT_DEVICE, mesh=None,
    parallel: bool = False,
) -> Result:
    """Multi-start policy: solve once from the requested init, then
    ``replicates - 1`` solves from fresh normalized random inits, keeping the
    minimum-objective Result.  With ``mesh``, each restart's init is drawn as
    without one and placed on ``mesh.lead``.

    ``parallel=True`` runs the restarts as the lanes of one lockstep solve
    (``models/replicates.py``) from the starts the sequential loop draws;
    its best replaces the first solve only when its objective is strictly
    lower.  A solver with no iterative path (SPA) takes the sequential
    loop."""
    dev = _solve_device(device, mesh)
    X = matops.as_operand(X)
    k = W.shape[1]
    ret = solve(alginst, X, W, H, trace, device=dev)
    if replicates == 1:
        return ret
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if parallel:
        best = solve_replicates_batched(
            alginst, X, k, replicates - 1, initH=initH, generator=generator,
            device=dev, mesh=mesh)
        if best is not None:
            return best if best.objvalue < ret.objvalue else ret
    for sub in child_generators(generator, replicates - 1):
        Wr, Hr = randinit(
            X, k, zeroh=not initH, normalize=True, generator=sub, device=dev
        )
        if mesh is not None:
            from ..parallel.sharding import shard_problem

            _, Wr, Hr = shard_problem(mesh, X, Wr, Hr)
        tmp = solve(alginst, X, Wr, Hr, device=dev)
        if ret.objvalue > tmp.objvalue:
            ret = tmp
    return ret
