"""nmf_tpu_torch — the PyTorch/CUDA build of the nmf_tpu NMF framework.

A second package beside the JAX package ``nmf_tpu``, with the same module
layout and public names, written for one NVIDIA Hopper card: plain tensor
code is PyTorch, and the sparse products, the multiplicative updates' fused
steps and the dense objectives run hand-written CUDA kernels (``csrc/``).  It
imports ``torch`` and ``numpy`` (and ``scipy`` to read Matrix Market files)
only.

Ported so far: the ``nnmf`` front door with all seven algorithms
(multiplicative updates for MSE and KL, projected ALS, ALS projected
gradient, Fast-HALS coordinate descent, greedy coordinate descent, SPA with
batched FNNLS) and every initializer (random, NNDSVD, NNDSVDa, NNDSVDar over
a randomized SVD, SPA, custom), on dense tensors, on the tiled sparse store
(``ops.sparse_format.build_tiled``) and on a torch sparse tensor of any
layout (``ops.sparse_format.SparseCSR``; ``io.loader.load_mtx`` reads Matrix
Market files); ``solve_checkpointed`` snapshots a solve and resumes it bit
for bit.  ``nnmf(X, k, mesh=...)`` runs X over a device mesh
(``parallel.mesh.make_mesh``; a 2 x 2 mesh may stand on one card): a sparse
X is cut into one store a block (``ops.sparse_shard.shard_tiled``), a dense
one into dense blocks (``ops.dense_shard.shard_dense``), both placed by
``parallel.sharding.shard_problem``, each block running the same kernels,
and W and H stay on the mesh's lead device.  ``nnmf(...,
parallel_replicates=True)`` runs the random restarts as the lanes of one
lockstep solve (``models.replicates``).  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from . import config, parallel
from .init.initialization import nndsvd, randinit
from .models.alspgrad import ALSPGrad, alspgrad_updateh, alspgrad_updatew
from .models.checkpoint import solve_checkpointed
from .models.common import Result, Trace, nmf_checksize, solve, stop_condition
from .models.coorddesc import CoordinateDescent
from .models.greedycd import GreedyCD
from .models.interface import nnmf, solve_replicates
from .models.multupd import MultUpdate
from .models.projals import ProjectedALS
from .models.spa import SPA, separable_data, spa
from .ops.fnnls import fnnls, nnls_gram
from .ops.linalg import pdrsolve, pdsolve
from .ops.objectives import gkldiv, kl_objective, mse_objective, sqL2dist
from .ops.dense_shard import ShardedDense, shard_dense
from .ops.rsvd import rsvd
from .ops.sparse_shard import ShardedTiled, shard_tiled
from .parallel.mesh import Mesh, make_mesh
from .parallel.sharding import shard_problem
from .utils.numeric import adddiag, normalize1, normalize1_cols, projectnn

__version__ = "0.1.0"

__all__ = [
    "nnmf",
    "Result",
    "Trace",
    "solve",
    "solve_checkpointed",
    "solve_replicates",
    "stop_condition",
    "nmf_checksize",
    "MultUpdate",
    "ProjectedALS",
    "ALSPGrad",
    "CoordinateDescent",
    "GreedyCD",
    "SPA",
    "alspgrad_updateh",
    "alspgrad_updatew",
    "spa",
    "separable_data",
    "fnnls",
    "nnls_gram",
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
    "parallel",
    "Mesh",
    "make_mesh",
    "shard_problem",
    "ShardedTiled",
    "shard_tiled",
    "ShardedDense",
    "shard_dense",
]
