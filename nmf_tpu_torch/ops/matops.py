"""Matrix-product seam over dense tensors, the tiled sparse store, a
general sparse X and the sharded store.

Every solver routes its X-products and X-reductions through these functions,
so any X supported here works in every solver: a dense ``torch.Tensor``, a
``TiledCSR`` or a ``SparseCSR`` (``ops/sparse_format.py``), whose products
and sampled product run the hand-written kernels of ``ops/cuda/sparse.py``
on the card, a ``ShardedTiled`` (``ops/sparse_shard.py``), a grid of
stores over a device mesh whose blocks run the same kernels, or a
``ShardedDense`` (``ops/dense_shard.py``), a grid of dense blocks whose
blocks run the dense kernels.  A torch sparse tensor of any layout becomes a
``SparseCSR`` at the front door (``as_operand``), once.
"""

from __future__ import annotations

import torch

from . import dense_shard as dshard
from . import sparse_shard as shard
from .sparse_format import SparseCSR, TiledCSR

__all__ = [
    "as_operand",
    "is_sparse",
    "is_general",
    "is_tiled",
    "is_sharded_tiled",
    "is_sharded_dense",
    "is_structured",
    "contiguous",
    "col_indices",
    "row_indices",
    "mm",
    "mtm",
    "wtq",
    "qht",
    "sddmm",
    "scale_values",
    "sq_norm",
    "total_sum",
    "colsums",
    "rowsums",
    "nnz_values",
    "nnz_sum",
    "all_nonneg",
    "transpose",
    "mean",
    "device_probe",
    "is_dense_f32_on_card",
]


def is_tiled(X) -> bool:
    return isinstance(X, TiledCSR)


def is_general(X) -> bool:
    """True for a general sparse X (``SparseCSR``)."""
    return isinstance(X, SparseCSR)


def is_sharded_tiled(X) -> bool:
    """True for the sharded store (``ShardedTiled``)."""
    return isinstance(X, shard.ShardedTiled)


def is_sharded_dense(X) -> bool:
    """True for a dense X cut over a mesh (``ShardedDense``)."""
    return isinstance(X, dshard.ShardedDense)


def is_sparse(X) -> bool:
    return is_tiled(X) or is_general(X) or is_sharded_tiled(X)


def is_structured(X) -> bool:
    """True for every X that is no plain tensor: a sparse X or a
    ``ShardedDense``."""
    return is_sparse(X) or is_sharded_dense(X)


def contiguous(X):
    """A plain tensor made row-major (the dense kernels read X so; a strided
    view is copied once); any other X as it is."""
    return X if is_structured(X) else X.contiguous()


def as_operand(X, device=None):
    """X as the solvers take it: a torch sparse tensor of any layout becomes
    a ``SparseCSR`` (moved to ``device`` first when one is given); anything
    else comes back as it is."""
    if isinstance(X, torch.Tensor) and X.layout != torch.strided:
        if device is not None:
            X = X.to(device)
        return SparseCSR.from_torch_sparse(X)
    return X


def device_probe(X):
    """A tensor that lives where X lives (X itself when dense; the lead
    block's values for the sharded store, whose products land on the lead
    device)."""
    if is_sharded_tiled(X):
        return X.owned()[0][2].fwd.vals
    if is_sharded_dense(X):
        return X.owned()[0][2]
    if is_tiled(X):
        return X.fwd.vals
    return X.fwd.val if is_general(X) else X


def is_dense_f32_on_card(X) -> bool:
    """True for the X the dense kernels (``ops/cuda/mu.py``,
    ``ops/cuda/objectives.py``) take: a dense float32 tensor on the card, or
    a ``ShardedDense`` of such blocks (which takes them a block at a
    time)."""
    if is_sparse(X):
        return False
    probe = device_probe(X)
    return probe.is_cuda and probe.dtype == torch.float32


def mm(X, D):
    """``X @ D`` for dense or sparse X (dense result)."""
    if is_tiled(X):
        from .cuda.sparse import tiled_mm

        return tiled_mm(X, D).to(D.dtype)
    if is_general(X):
        from .cuda.sparse import csr_mm

        return csr_mm(X.fwd, D)
    if is_sharded_tiled(X):
        return shard.sharded_mm(X, D).to(D.dtype)
    if is_sharded_dense(X):
        return dshard.dense_mm(X, D)
    return X @ D


def mtm(D, X):
    """``D @ X`` with D dense (used as ``W.T @ X``; dense result)."""
    if is_tiled(X):
        from .cuda.sparse import tiled_mtm

        return tiled_mtm(X, D.T).T.to(D.dtype)
    if is_general(X):
        from .cuda.sparse import csr_mm

        # (X' D')' on X's transposed orientation: no transpose of X
        return csr_mm(X.bwd, D.T).T
    if is_sharded_tiled(X):
        return shard.sharded_mtm(X, D.T).T.to(D.dtype)
    if is_sharded_dense(X):
        return dshard.dense_mtm(D, X)
    return D @ X


def wtq(X, W, H, delta):
    """``W' (X / (W H + delta))`` for a dense X, the quotient never formed
    whole: kernel 8 on the card (its plain version on the CPU), a block at a
    time on a ``ShardedDense``."""
    if is_sharded_dense(X):
        return dshard.dense_wtq(X, W, H, delta)
    from .cuda.mu import wtq as wtq_kernel

    return wtq_kernel(X, W, H, delta)


def qht(X, W, H, delta):
    """``(X / (W H + delta)) H'`` for a dense X, as ``wtq`` (kernel 9)."""
    if is_sharded_dense(X):
        return dshard.dense_qht(X, W, H, delta)
    from .cuda.mu import qht as qht_kernel

    return qht_kernel(X, W, H, delta)


def _slim_guard(X, attr, op):
    """Clear error for CSR-order access on a slimmed TiledCSR (slim() drops
    values/row_idx/col_idx and the refresh maps)."""
    val = getattr(X, attr)
    if val is None:
        raise ValueError(
            f"{op} needs the CSR-order arrays, but this TiledCSR was "
            "slim()-med; rebuild with build_tiled for per-nnz access"
        )
    return val


def sddmm(W, H, X):
    """Values of ``(W @ H)`` sampled at X's nonzero positions, aligned with
    ``nnz_values(X)`` (sparse X only).  A store on the card goes through
    ``tiled_sddmm`` and its chunk kernel; a store on the CPU and a general X
    take the gather-gather-reduce form."""
    if is_general(X):
        from .cuda.sparse import csr_sample

        return csr_sample(X.fwd, W, H)
    if is_sharded_tiled(X):
        return shard.sharded_sddmm(X, W, H)
    if not is_tiled(X):
        raise TypeError("sddmm needs a sparse X")
    ri = _slim_guard(X, "row_idx", "sddmm").long()
    if X.device.type == "cuda":
        from .cuda.sparse import tiled_sddmm

        return tiled_sddmm(X, W, H)
    return (W[ri, :] * H[:, X.col_idx.long()].T).sum(dim=1)


def scale_values(X, new_values):
    """Sparse X with the same pattern but new values."""
    if not is_sparse(X):
        raise TypeError("scale_values needs a sparse X")
    if is_sharded_tiled(X):
        return shard.sharded_scale_values(X, new_values)
    return X.with_values(new_values)


def nnz_values(X):
    if not is_sparse(X):
        raise TypeError("nnz_values needs a sparse X")
    if is_sharded_tiled(X):
        return shard.sharded_nnz_values(X)
    return _slim_guard(X, "values", "nnz_values")


def nnz_sum(X, v):
    """``v.sum()`` of a vector in the nnz vector's order; on a sharded store
    the blocks' float64 sums added in block order across its processes
    (``sharded_nnz_sum``), so one process and several give the same bits."""
    if is_sharded_tiled(X):
        return shard.sharded_nnz_sum(X, v)
    return v.sum()


def sq_norm(X):
    """``sum(X**2)``."""
    if is_sparse(X):
        if X.stats is not None:
            return X.stats[1]
        v = nnz_values(X)
        return nnz_sum(X, v * v)
    if is_sharded_dense(X):
        return dshard.dense_reduce(X, lambda b: (b * b).sum())
    return (X * X).sum()


def total_sum(X):
    if is_sparse(X):
        return X.stats[0] if X.stats is not None else nnz_sum(X, nnz_values(X))
    if is_sharded_dense(X):
        return dshard.dense_reduce(X, torch.sum)
    return X.sum()


def mean(X):
    return total_sum(X) / (X.shape[0] * X.shape[1])


def _row_sums_of_store(X):
    """(p,) row sums of a sparse X as its product with a ones column: the
    products (kernels 1-3 and the band on the card) add in a fixed order, so
    the sums repeat bit for bit, and a slimmed store sums too."""
    probe = device_probe(X)
    ones = torch.ones((X.shape[1], 1), dtype=probe.dtype, device=probe.device)
    return mm(X, ones)[:, 0]


def colsums(X):
    """(n,) column sums."""
    if is_sparse(X):
        return _row_sums_of_store(X.transpose())
    return X.sum(dim=0)


def rowsums(X):
    """(p,) row sums."""
    if is_sparse(X):
        return _row_sums_of_store(X)
    return X.sum(dim=1)


def all_nonneg(X):
    if is_sparse(X):
        if X.stats is not None:
            return X.stats[2] >= 0
        return (nnz_values(X) >= 0).all()
    if is_sharded_dense(X):
        return dshard.dense_all_nonneg(X)
    return (X >= 0).all()


def transpose(X):
    if is_structured(X):
        return X.transpose()
    return X.T


def col_indices(X):
    """Column index of each stored value, aligned with ``nnz_values(X)``
    (sparse only)."""
    if not is_sparse(X):
        raise TypeError("col_indices needs a sparse X")
    if is_sharded_tiled(X):
        return shard.sharded_col_ids(X)
    return _slim_guard(X, "col_idx", "col_indices")


def row_indices(X):
    """Row index of each stored value, aligned with ``nnz_values(X)``
    (sparse only)."""
    if not is_sparse(X):
        raise TypeError("row_indices needs a sparse X")
    if is_sharded_tiled(X):
        return shard.sharded_row_ids(X)
    return _slim_guard(X, "row_idx", "row_indices")
