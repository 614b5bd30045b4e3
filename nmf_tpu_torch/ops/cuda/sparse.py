"""Sparse-dense products over the tiled store: ``X @ D`` and ``X' @ D``.

One product is the sum of three parts, one per store class
(``ops/sparse_format.py``):

* ``chunk_matmul`` — the narrow-chunk kernel (``csrc/chunk_matmul.cu``);
* ``dense_matmul`` — the dense-tile kernel (``csrc/dense_matmul.cu``);
* ``coo_matmul``  — the COO band, plain PyTorch: gather, scale and
  ``index_add_`` over pieces of the band, so the ``(n_coo, k)`` product never
  exists whole.

Each kernel has a plain PyTorch version beside it that does the same
arithmetic over the same store arrays.  A wrapper takes the plain version
only for tensors that live on the CPU; for CUDA tensors it launches its
kernel or raises.  ``chunk_matmul.launches`` / ``dense_matmul.launches`` count
kernel launches, and nothing else.

Everything is float32 with D row-major ``(n, k)``: one gathered row of D is
``4k`` contiguous bytes.  Both kernels give one thread block sole ownership
of a 128-row output panel and sum in an order fixed by the store, so their
results are the same from run to run.  The COO band's ``index_add_`` uses
atomics on the card: its float sums can differ in the last bits between runs.
"""

from __future__ import annotations

import torch

from ..sparse_format import DENSE_GROUP, TILE, TiledCSR, TiledSideC

__all__ = [
    "chunk_matmul", "chunk_matmul_plain", "dense_matmul", "dense_matmul_plain",
    "coo_matmul", "tiled_matmul_t", "tiled_mm", "tiled_mtm",
    "launch_counts", "reset_launch_counts",
]

# the chunk kernel keeps a (128, k) float panel in shared memory, beside 1 KB
# of staged slots; a block may use 232,448 bytes
MAX_K = (232448 - 2048) // (TILE * 4)
# slots / blocks / band entries handled at once by the plain versions and the
# COO band: bounds the (piece, k) temporaries to 128 MB at k = 128
_PIECE = 1 << 18


def _check_operand(side: TiledSideC, D) -> int:
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    if D.dim() != 2 or D.shape[0] != side.cols:
        raise ValueError(
            f"D must be ({side.cols}, k), got {tuple(D.shape)}"
        )
    if not D.is_contiguous():
        raise ValueError("D must be contiguous (row-major)")
    if D.device != side.vals.device:
        raise ValueError(
            f"D lives on {D.device}, the store on {side.vals.device}"
        )
    return D.shape[1]


def _launch(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


def _n_rowpanels(side: TiledSideC) -> int:
    return -(-side.rows // TILE)


# ---------------------------------------------------------------------------
# chunk store


def chunk_matmul_plain(side: TiledSideC, D):
    """Plain version of ``chunk_matmul``: per piece of the chunk store,
    gather D rows at each slot's column, scale by the slot's value,
    ``index_add_`` into the slot's output row.  Padding slots (value 0 at
    local coordinate 0) add zero."""
    k = D.shape[1]
    pps = side.panels_per_stripe
    out = D.new_zeros((side.n_stripes * pps * TILE, k))
    step = max(_PIECE // TILE, 1)
    nchunks = side.coords.shape[0]
    for c0 in range(0, nchunks, step):
        ids = torch.arange(c0, min(c0 + step, nchunks), device=D.device)
        win = ids // side.group
        co = side.coords[ids].long()
        cols = side.win_panel[win].long()[:, None] * TILE + (co >> 7)
        panel = side.win_stripe[win].long() * pps + side.chunk_rp[ids].long()
        rows = panel[:, None] * TILE + (co & (TILE - 1))
        contrib = side.vals[ids].reshape(-1, 1) * D[cols.reshape(-1)]
        out.index_add_(0, rows.reshape(-1), contrib)
    return out[: side.rows]


def chunk_matmul(side: TiledSideC, D):
    """``X_chunks @ D`` (rows, k) for one orientation's chunk store."""
    k = _check_operand(side, D)
    if not D.is_cuda:
        return chunk_matmul_plain(side, D)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}] for the chunk kernel, got {k}")
    from .build import load_kernels

    out = torch.empty((side.rows, k), dtype=torch.float32, device=D.device)
    _launch(
        load_kernels().nmf_chunk_matmul,
        side.panel_ptr.data_ptr(), side.panel_chunks.data_ptr(),
        side.win_panel.data_ptr(), side.coords.data_ptr(),
        side.vals.data_ptr(), D.data_ptr(), out.data_ptr(),
        _n_rowpanels(side), side.group, side.rows, k,
    )
    chunk_matmul.launches += 1
    return out


chunk_matmul.launches = 0


# ---------------------------------------------------------------------------
# dense store


def dense_matmul_plain(side: TiledSideC, D, out=None):
    """Plain version of ``dense_matmul``: per piece of the dense store, one
    batched ``block' @ D_panel`` product, ``index_add_`` into the output
    panels.  Zero-padding blocks add zero."""
    k = D.shape[1]
    pps = side.panels_per_stripe
    n_panels = side.n_stripes * pps
    acc = D.new_zeros((n_panels, TILE, k))
    Dp = D.new_zeros((side.n_colpanels * TILE, k))
    Dp[: side.cols] = D
    Dp = Dp.reshape(side.n_colpanels, TILE, k)
    step = max(_PIECE // TILE, 1)
    for b0 in range(0, side.n_dblocks, step):
        ids = torch.arange(b0, min(b0 + step, side.n_dblocks), device=D.device)
        win = ids // DENSE_GROUP
        panel = side.dblk_stripe[win].long() * pps + side.dblk_rp[ids].long()
        contrib = torch.bmm(
            side.dvals[ids].transpose(1, 2), Dp[side.dblk_panel[win].long()]
        )
        acc.index_add_(0, panel, contrib)
    res = acc.reshape(-1, k)[: side.rows]
    if out is None:
        return res
    return out.add_(res)


def dense_matmul(side: TiledSideC, D, out=None):
    """``out += X_dense @ D`` (rows, k) for one orientation's dense store;
    ``out`` starts from zeros when not given.  Returns ``out``."""
    k = _check_operand(side, D)
    if out is not None and (
        out.dtype != torch.float32 or tuple(out.shape) != (side.rows, k)
        or not out.is_contiguous() or out.device != D.device
    ):
        raise ValueError(
            f"out must be a contiguous float32 ({side.rows}, {k}) tensor on "
            f"{D.device}"
        )
    if not D.is_cuda:
        return dense_matmul_plain(side, D, out)
    from .build import load_kernels

    if out is None:
        out = torch.zeros((side.rows, k), dtype=torch.float32, device=D.device)
    _launch(
        load_kernels().nmf_dense_matmul,
        side.dpanel_ptr.data_ptr(), side.dpanel_blocks.data_ptr(),
        side.dblk_panel.data_ptr(), side.dvals.data_ptr(), D.data_ptr(),
        out.data_ptr(), _n_rowpanels(side), DENSE_GROUP, side.rows, side.cols, k,
    )
    dense_matmul.launches += 1
    return out


dense_matmul.launches = 0


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name."""
    return {
        "chunk_matmul": chunk_matmul.launches,
        "dense_matmul": dense_matmul.launches,
    }


def reset_launch_counts() -> None:
    chunk_matmul.launches = 0
    dense_matmul.launches = 0


# ---------------------------------------------------------------------------
# COO band and the whole product


def coo_matmul(side: TiledSideC, D, out):
    """``out += X_band @ D``: gather, scale, ``index_add_``, one piece of the
    band at a time."""
    for e0 in range(0, side.n_coo, _PIECE):
        sl = slice(e0, min(e0 + _PIECE, side.n_coo))
        contrib = side.coo_vals[sl, None] * D[side.coo_cols[sl].long()]
        out.index_add_(0, side.coo_rows[sl].long(), contrib)
    return out


def tiled_matmul_t(side: TiledSideC, D):
    """``X @ D`` for one tiling orientation, in the tiling's coordinates;
    returns (rows, k) float32."""
    D = D.to(torch.float32).contiguous()
    out = chunk_matmul(side, D)
    if side.n_dblocks:
        out = dense_matmul(side, D, out)
    if side.n_coo:
        out = coo_matmul(side, D, out)
    return out


def tiled_mm(X: TiledCSR, D):
    """``X @ D`` (p x k).  Degree-ordered tilings gather D's rows into the
    renumbered coordinates and scatter the output back."""
    if X.col_perm is not None:
        D = D.index_select(0, X.col_perm.long())
    out = tiled_matmul_t(X.fwd, D)
    if X.row_rank is not None:
        out = out.index_select(0, X.row_rank.long())
    return out


def tiled_mtm(X: TiledCSR, D):
    """``X.T @ D`` (n x k)."""
    if X.row_perm is not None:
        D = D.index_select(0, X.row_perm.long())
    out = tiled_matmul_t(X.bwd, D)
    if X.col_rank is not None:
        out = out.index_select(0, X.col_rank.long())
    return out
