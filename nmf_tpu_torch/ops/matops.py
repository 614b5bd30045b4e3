"""Matrix-product seam over dense tensors and the tiled sparse store.

Every solver routes its X-products and X-reductions through these functions,
so any X supported here works in every solver: a dense ``torch.Tensor`` or a
``TiledCSR`` (``ops/sparse_format.py``), whose products and sampled product
run the hand-written kernels of ``ops/cuda/sparse.py`` on the card.
"""

from __future__ import annotations

import torch

from .sparse_format import TiledCSR

__all__ = [
    "is_sparse",
    "is_tiled",
    "col_indices",
    "mm",
    "mtm",
    "sddmm",
    "scale_values",
    "sq_norm",
    "total_sum",
    "colsums",
    "rowsums",
    "nnz_values",
    "all_nonneg",
    "transpose",
    "mean",
    "device_probe",
    "is_dense_f32_on_card",
]


def is_tiled(X) -> bool:
    return isinstance(X, TiledCSR)


def is_sparse(X) -> bool:
    return is_tiled(X)


def device_probe(X):
    """A tensor that lives where X lives (X itself when dense)."""
    return X.fwd.vals if is_tiled(X) else X


def is_dense_f32_on_card(X) -> bool:
    """True for the X the dense kernels (``ops/cuda/mu.py``,
    ``ops/cuda/objectives.py``) take: a dense float32 tensor on the card."""
    return not is_tiled(X) and X.is_cuda and X.dtype == torch.float32


def mm(X, D):
    """``X @ D`` for dense or sparse X (dense result)."""
    if is_tiled(X):
        from .cuda.sparse import tiled_mm

        return tiled_mm(X, D).to(D.dtype)
    return X @ D


def mtm(D, X):
    """``D @ X`` with D dense (used as ``W.T @ X``; dense result)."""
    if is_tiled(X):
        from .cuda.sparse import tiled_mtm

        return tiled_mtm(X, D.T).T.to(D.dtype)
    return D @ X


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
    ``tiled_sddmm`` and its chunk kernel; a store on the CPU takes the
    gather-gather-reduce form."""
    if not is_tiled(X):
        raise TypeError("sddmm needs a sparse X")
    ri = _slim_guard(X, "row_idx", "sddmm").long()
    if X.device.type == "cuda":
        from .cuda.sparse import tiled_sddmm

        return tiled_sddmm(X, W, H)
    return (W[ri, :] * H[:, X.col_idx.long()].T).sum(dim=1)


def scale_values(X, new_values):
    """Sparse X with the same pattern but new values."""
    if not is_tiled(X):
        raise TypeError("scale_values needs a sparse X")
    return X.with_values(new_values)


def nnz_values(X):
    if not is_tiled(X):
        raise TypeError("nnz_values needs a sparse X")
    return _slim_guard(X, "values", "nnz_values")


def sq_norm(X):
    """``sum(X**2)``."""
    if is_tiled(X):
        if X.stats is not None:
            return X.stats[1]
        v = nnz_values(X)
        return (v * v).sum()
    return (X * X).sum()


def total_sum(X):
    if is_tiled(X):
        return X.stats[0] if X.stats is not None else nnz_values(X).sum()
    return X.sum()


def mean(X):
    return total_sum(X) / (X.shape[0] * X.shape[1])


def colsums(X):
    """(n,) column sums."""
    if is_tiled(X):
        ci = _slim_guard(X, "col_idx", "colsums").long()
        return X.values.new_zeros(X.shape[1]).index_add_(0, ci, X.values)
    return X.sum(dim=0)


def rowsums(X):
    """(p,) row sums."""
    if is_tiled(X):
        ri = _slim_guard(X, "row_idx", "rowsums").long()
        return X.values.new_zeros(X.shape[0]).index_add_(0, ri, X.values)
    return X.sum(dim=1)


def all_nonneg(X):
    if is_tiled(X):
        if X.stats is not None:
            return X.stats[2] >= 0
        return (nnz_values(X) >= 0).all()
    return (X >= 0).all()


def transpose(X):
    if is_tiled(X):
        return X.transpose()
    return X.T


def col_indices(X):
    """Column index of each stored value, aligned with ``nnz_values(X)``
    (sparse only)."""
    if not is_tiled(X):
        raise TypeError("col_indices needs a sparse X")
    return _slim_guard(X, "col_idx", "col_indices")
