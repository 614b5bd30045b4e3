"""Matrix Market loading and the host binner helpers of ``build_tiled``, in
numpy.

``load_mtx`` parses a Matrix Market coordinate file into COO arrays through
scipy, ``coo_to_csr`` sorts and sums duplicates, and ``to_bcoo`` hands the
result to the solvers as a coalesced torch sparse tensor on the device (the
JAX package's function of the same name makes a BCOO).  There is one route,
scipy's: no native library is built or loaded.

``ops/sparse_format.py`` bins a COO matrix into its tiled store on the host;
the other helpers are the array passes it is written in terms of.  Each is a
handful of vectorised numpy operations over the nonzeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config

__all__ = [
    "COO", "CSR", "load_mtx", "coo_to_csr", "to_bcoo",
    "stable_argsort", "gather3", "gather3k", "dense_scatter",
    "tile_key", "chunk_fill", "class_extract",
]


class COO(NamedTuple):
    rows: int
    cols: int
    row_idx: np.ndarray
    col_idx: np.ndarray
    values: np.ndarray


class CSR(NamedTuple):
    rows: int
    cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray


def load_mtx(path: str) -> COO:
    """Parse a Matrix Market coordinate file into COO arrays (int32
    indices, float32 values; duplicates are kept)."""
    return _load_mtx_numpy(path)


def _load_mtx_numpy(path: str) -> COO:
    import scipy.io

    m = scipy.io.mmread(str(path))
    if not hasattr(m, "tocoo"):
        raise ValueError(f"Unsupported MatrixMarket format (not coordinate): {path}")
    m = m.tocoo()
    return COO(
        m.shape[0],
        m.shape[1],
        m.row.astype(np.int32),
        m.col.astype(np.int32),
        m.data.astype(np.float32),
    )


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR, each row's columns sorted and duplicates summed."""
    import scipy.sparse

    m = scipy.sparse.coo_matrix(
        (coo.values, (coo.row_idx, coo.col_idx)), shape=(coo.rows, coo.cols)
    ).tocsr()
    m.sum_duplicates()
    return CSR(
        coo.rows,
        coo.cols,
        m.indptr.astype(np.int64),
        m.indices.astype(np.int32),
        m.data.astype(np.float32),
    )


def to_bcoo(x, dtype=torch.float32, device=config.DEFAULT_DEVICE):
    """COO or CSR arrays -> a coalesced ``torch.sparse_coo_tensor`` of
    ``dtype`` on ``device`` (sorted row-major, duplicates summed), as
    ``nnmf`` and the solvers take it."""
    dev = config.resolve_device(device)
    if not isinstance(x, CSR):
        x = coo_to_csr(x)
    rows = np.repeat(np.arange(x.rows, dtype=np.int64),
                     np.diff(x.indptr).astype(np.int64))
    idx = torch.from_numpy(np.stack([rows, x.indices.astype(np.int64)]))
    vals = torch.from_numpy(np.ascontiguousarray(x.data)).to(dtype)
    X = torch.sparse_coo_tensor(idx, vals, (x.rows, x.cols),
                                is_coalesced=True, check_invariants=False)
    return X.to(dev)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of an int64 key array."""
    return np.argsort(np.ascontiguousarray(keys, np.int64), kind="stable")


def gather3(order, r, c, v):
    """``(r[order], c[order], v[order])``."""
    return r[order], c[order], v[order]


def gather3k(order, r, c, v, k):
    """``(r[order], c[order], v[order], k[order])``."""
    return r[order], c[order], v[order], k[order]


def dense_scatter(dvals: np.ndarray, blk, lcol, lrow, v):
    """``dvals[blk, lcol, lrow] = v`` (unique positions)."""
    dvals[blk, lcol, lrow] = v


def tile_key(rows, cols, n_colpanels: int, stripe_tiles: int):
    """Fused tile key ``((r//128)//st * ncp + c//128)*st + (r//128)%st``:
    sorting by it orders nonzeros by (stripe, col panel, row panel in
    stripe)."""
    rp = rows // 128
    return (
        (rp // stripe_tiles).astype(np.int64) * n_colpanels + cols // 128
    ) * stripe_tiles + rp % stripe_tiles


def chunk_fill(t_first, counts, base, s_rows, s_cols, s_vals, cwidth,
               coords, vals):
    """Per-tile chunk-slot assignment plus the coords/vals fill over the
    tile-sorted residual; returns the flat slot id per nonzero.  ``coords``
    and ``vals`` are the flat ``(nchunks*128,)`` chunk-store arrays, modified
    in place."""
    nnz = len(s_rows)
    pos = np.arange(nnz, dtype=np.int64) - np.repeat(t_first, counts)
    slot = (np.repeat(base, counts) + pos // 128) * 128 + pos % 128
    coords[slot] = ((s_cols % cwidth) << 7 | (s_rows % 128)).astype(np.int32)
    vals[slot] = s_vals
    return slot


def class_extract(t_first, counts, dst, a_rows, a_cols, a_vals, order):
    """Copy each tile's contiguous run of the sorted arrays to its class's
    region (``dst[t]`` = destination offset of tile t), carrying the CSR ids
    (``order``) along."""
    n = len(a_rows)
    ro = np.empty(n, np.int32)
    co = np.empty(n, np.int32)
    vo = np.empty(n, np.float32)
    oo = np.empty(n, np.int64)
    d = np.repeat(dst, counts) + (
        np.arange(n, dtype=np.int64) - np.repeat(t_first, counts)
    )
    ro[d] = a_rows
    co[d] = a_cols
    vo[d] = a_vals
    oo[d] = order
    return ro, co, vo, oo
