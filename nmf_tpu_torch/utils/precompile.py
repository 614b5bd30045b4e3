"""Warm-up: every (alg, init) pair once on a tiny problem.

The reference precompiles the (alg x init) grid on an 8 x 6 random matrix
when its package is built; the JAX package's ``warmup`` runs that grid to
fill its compile cache.  Here the grid loads the CUDA kernels first (built
with ``nvcc`` at their first use, ``ops/cuda/build.py``) and then runs each
solver's code paths once, so that the first solve of a session pays for
neither.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config

__all__ = ["warmup"]

_ALGS = ("multmse", "multdiv", "projals", "alspgrad", "cd", "greedycd")
_INITS = ("random", "nndsvd", "nndsvda", "nndsvdar", "spa")


@config.precision_scope()
def warmup(dtype=torch.float32, algs=_ALGS, inits=_INITS, k: int = 4,
           device=config.DEFAULT_DEVICE) -> int:
    """Run every (alg, init) pair on an 8 x 6 random matrix with
    ``maxiter=2``, then ``nnmf(X, k, alg="spa", init="spa")``, on
    ``device``; on a card the kernels are loaded first.  Returns the number
    of solves (31 with the defaults)."""
    from ..models.interface import nnmf

    dev = config.resolve_device(device)
    if dev.type == "cuda":
        from ..ops.cuda import build

        build.load_kernels()
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.random((8, 6))).to(device=dev, dtype=dtype)
    for alg in algs:
        for init in inits:
            nnmf(X, k, alg=alg, init=init, maxiter=2, device=dev)
    nnmf(X, k, alg="spa", init="spa", device=dev)
    return len(algs) * len(inits) + 1
