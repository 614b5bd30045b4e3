"""Host binner helpers of ``build_tiled``, in numpy.

``ops/sparse_format.py`` bins a COO matrix into its tiled store on the host;
these are the array passes it is written in terms of.  Each is a handful of
vectorised numpy operations over the nonzeros.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "stable_argsort", "gather3", "gather3k", "dense_scatter",
    "tile_key", "chunk_fill", "class_extract",
]


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
