"""Placing the NMF problem on a mesh.

One layout serves every solver: X is cut into a 2-D grid of blocks, one
block a device of the mesh: the stores of a ``ShardedTiled``
(``ops/sparse_shard.py``) for a sparse X, the dense blocks of a
``ShardedDense`` (``ops/dense_shard.py``) for a dense one.  W and H stay
whole on the mesh's lead device, where the products' sums, the k x k Grams,
the objectives and the stop tests are computed; on a mesh that spans several
processes each process holds only its own blocks, and W and H whole on its
own lead, every process taking the same steps on the same bits.  The solvers reach X only
through ``ops/matops.py`` and ``ops/objectives.py``, which send either grid
to its sharded products, so no solver knows of the mesh.
"""

from __future__ import annotations

from .mesh import Mesh

__all__ = ["shard_problem"]


def _numpy(t):
    return t.cpu().numpy()


def shard_problem(mesh: Mesh, X, W, H):
    """``(X, W, H)`` placed on ``mesh``: a sparse X (a ``TiledCSR``, a
    ``SparseCSR`` or a torch sparse tensor) is rebuilt as a ``ShardedTiled``
    over the mesh, a ``TiledCSR`` with its own store options; a dense X is
    cut into a ``ShardedDense``; a prebuilt ``ShardedTiled`` or
    ``ShardedDense`` passes through (its mesh must match).  With several
    processes each passes the whole X and keeps only its own blocks.  W and
    H move to ``mesh.lead``."""
    from ..ops import matops
    from ..ops.dense_shard import shard_dense
    from ..ops.sparse_shard import shard_tiled

    X = matops.as_operand(X)
    if matops.is_sharded_tiled(X) or matops.is_sharded_dense(X):
        if X.mesh != mesh:
            raise ValueError(
                f"X is a {type(X).__name__} built for a different mesh; "
                "rebuild it for this mesh or pass its own mesh to nnmf.")
    elif matops.is_tiled(X):
        if X.row_idx is None:
            raise ValueError(
                "sharding a TiledCSR needs its CSR-order arrays, but this one "
                "was slim()-med; rebuild with build_tiled")
        kw = {}
        if X.build_opts is not None:
            st, layout, group, dense, quad, qseg, coo = X.build_opts
            kw = dict(stripe_tiles=st, layout=layout, group=group,
                      dense_tile_nnz=dense, quad_tail_nnz=quad, quad_seg=qseg,
                      coo_tail_nnz=coo,
                      order="degree" if X.row_perm is not None else "natural")
        X = shard_tiled(_numpy(X.row_idx), _numpy(X.col_idx), _numpy(X.values),
                        X.shape, mesh, **kw)
    elif matops.is_general(X):
        X = shard_tiled(_numpy(X.row_idx), _numpy(X.col_idx), _numpy(X.values),
                        X.shape, mesh)
    else:
        X = shard_dense(X, mesh)
    return X, W.to(mesh.lead), H.to(mesh.lead)
