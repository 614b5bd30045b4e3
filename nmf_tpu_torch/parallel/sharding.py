"""Placing the NMF problem on a mesh.

One layout serves every solver: X is cut into the 2-D grid of blocks of a
``ShardedTiled`` (``ops/sparse_shard.py``), one block a device of the mesh;
W and H stay whole on the mesh's lead device, where the products' sums, the
k x k Grams, the objectives and the stop tests are computed.  The solvers
reach X only through ``ops/matops.py``, which sends a ``ShardedTiled`` to the
sharded products, so no solver knows of the mesh.
"""

from __future__ import annotations

from .mesh import Mesh

__all__ = ["shard_problem"]


def _numpy(t):
    return t.cpu().numpy()


def shard_problem(mesh: Mesh, X, W, H):
    """``(X, W, H)`` placed on ``mesh``: a sparse X (a ``TiledCSR``, a
    ``SparseCSR`` or a torch sparse tensor) is rebuilt as a ``ShardedTiled``
    over the mesh, a ``TiledCSR`` with its own store options; a prebuilt
    ``ShardedTiled`` passes through (its mesh must match).  W and H move to
    ``mesh.lead``.  A dense X on a mesh is not ported yet."""
    from ..ops import matops
    from ..ops.sparse_shard import shard_tiled

    X = matops.as_operand(X)
    if matops.is_sharded_tiled(X):
        if X.mesh != mesh:
            raise ValueError(
                "X is a ShardedTiled built for a different mesh; rebuild it "
                "with shard_tiled(..., mesh) or pass its own mesh to nnmf.")
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
        raise NotImplementedError(
            "a dense X on a mesh is ROADMAP.md queue 1 item 6d; pass a sparse X "
            "(a TiledCSR, a SparseCSR, a torch sparse tensor or a ShardedTiled) "
            "or no mesh")
    return X, W.to(mesh.lead), H.to(mesh.lead)
