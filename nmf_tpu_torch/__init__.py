"""nmf_tpu_torch — the PyTorch/CUDA build of the nmf_tpu NMF framework.

A second package beside the JAX package ``nmf_tpu``, with the same module
layout and public names, written for one NVIDIA Hopper card: plain tensor
code is PyTorch, and the sparse products, the multiplicative updates' fused
steps and the dense objectives run hand-written CUDA kernels (``csrc/``).  It
imports ``torch`` and ``numpy`` only.

Ported so far: the ``nnmf`` front door for Fast-HALS coordinate descent
(``alg="cd"``), greedy coordinate descent (``alg="greedycd"``, the default)
and the multiplicative updates (``alg="multmse"``, ``alg="multdiv"``) with
random, custom or NNDSVD initialization (``init="nndsvdar"``, the default,
over a randomized SVD), on dense tensors and on the tiled sparse store
(``ops.sparse_format.build_tiled``): ``nnmf(X, k)`` runs with every default.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from . import config
from .init.initialization import nndsvd, randinit
from .models.common import Result, Trace, nmf_checksize, solve, stop_condition
from .models.coorddesc import CoordinateDescent
from .models.greedycd import GreedyCD
from .models.interface import nnmf, solve_replicates
from .models.multupd import MultUpdate
from .ops.linalg import pdrsolve, pdsolve
from .ops.objectives import gkldiv, kl_objective, mse_objective, sqL2dist
from .ops.rsvd import rsvd
from .utils.numeric import adddiag, normalize1, normalize1_cols, projectnn

__version__ = "0.1.0"

__all__ = [
    "nnmf",
    "Result",
    "Trace",
    "solve",
    "solve_replicates",
    "stop_condition",
    "nmf_checksize",
    "CoordinateDescent",
    "GreedyCD",
    "MultUpdate",
    "randinit",
    "nndsvd",
    "rsvd",
    "pdsolve",
    "pdrsolve",
    "mse_objective",
    "kl_objective",
    "gkldiv",
    "sqL2dist",
    "adddiag",
    "normalize1",
    "normalize1_cols",
    "projectnn",
    "config",
]
