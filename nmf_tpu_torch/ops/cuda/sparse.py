"""Products over the tiled store: ``X @ D``, ``X' @ D`` and ``W @ H`` sampled
at X's pattern.

One sparse-dense product is the sum of four parts, one per store class
(``ops/sparse_format.py``):

* ``chunk_matmul`` — the narrow-chunk kernel (``csrc/chunk_matmul.cu``);
* ``dense_matmul`` — the dense-tile kernel (``csrc/dense_matmul.cu``);
* ``quad_matmul``  — the quad-tail kernel (``csrc/quad_matmul.cu``);
* ``coo_matmul``  — the COO band kernel (``csrc/coo_matmul.cu``): each
  row's band entries summed in band order, then added to the output once,
  as the reference's sorted ``segment_sum``.

The sampled product ``tiled_sddmm`` has the same four parts:
``chunk_sddmm`` (``csrc/chunk_sddmm.cu``), ``dense_sample`` (a batched
product per piece of the dense store), ``quad_sddmm``
(``csrc/quad_sddmm.cu``) and ``coo_sample`` (gather, gather, reduce over
pieces of the band).

A general sparse X (``SparseCSR``): ``csr_matmul`` runs the general-CSR
kernel (``csrc/csr_matmul.cu``) over each orientation's rows cut into pieces,
a split row's partial sums added in piece order by a second pass, and
``csr_sample`` the band's gather, gather, reduce over all of X.

Each kernel has a plain PyTorch version beside it that does the same
arithmetic over the same store arrays.  A wrapper takes the plain version
only for tensors that live on the CPU; for CUDA tensors it launches its
kernel or raises.  ``build.launch_counts()`` counts kernel launches, and
nothing else; while ``utils.spans`` records, each launch is also counted in
the innermost span.

On the card everything is float32 (a general X on the CPU keeps its dtype),
with D row-major ``(n, k)``: one gathered row of D is
``4k`` contiguous bytes.  The chunk, dense and quad kernels give one thread
block a *piece* of a 128-row output panel (the store's pieces,
``sparse_format``): a panel of one piece is written straight to the output,
the pieces of a split panel write partial panels to a scratch tensor that
the wrapper allocates and a second pass adds them in piece order.  The band
kernel gives one warp a row, the general-CSR kernel one warp a piece of a
row.  All of them sum in an order fixed by the store and
use no atomics, so their results are the same from run to run.
"""

from __future__ import annotations

import torch

from ..sparse_format import (
    DENSE_GROUP,
    QUAD_GROUP,
    TILE,
    CSRSide,
    TiledCSR,
    TiledSideC,
)
from .build import SMEM_PER_BLOCK, launch

__all__ = [
    "chunk_matmul", "chunk_matmul_plain", "dense_matmul", "dense_matmul_plain",
    "quad_rows_cols", "quad_matmul", "quad_matmul_plain", "coo_matmul",
    "coo_matmul_plain",
    "tiled_matmul_t", "tiled_mm", "tiled_mtm", "chunk_sddmm", "chunk_sddmm_plain",
    "dense_sample", "quad_sddmm", "quad_sddmm_plain", "coo_sample",
    "tiled_sddmm", "sddmm_lanes", "csr_matmul", "csr_matmul_plain", "csr_launch",
    "csr_mm", "csr_sample",
]

# the chunk and quad kernels keep a (128, k) float panel in shared memory
MAX_K = SMEM_PER_BLOCK // (TILE * 4)
# floats of a slot's dot product one lane of the sddmm kernels takes at
# most (``sddmm_lanes``): four 16-byte gathers of H a lane; 8 lanes a slot at
# k = 128 ran faster than 2, 4 or 16 (``tools/time_sddmm_variants.py``)
SDDMM_LANE_FLOATS = 16
# the largest k whose W panel the sddmm kernels stage in shared memory
# (``SD_STAGE_K`` of csrc/sddmm_piece.cuh); above it they gather W's rows
SDDMM_STAGE_K = 192
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


def _check_out(side: TiledSideC, D, out, k) -> None:
    if out is not None and (
        out.dtype != torch.float32 or tuple(out.shape) != (side.rows, k)
        or not out.is_contiguous() or out.device != D.device
    ):
        raise ValueError(
            f"out must be a contiguous float32 ({side.rows}, {k}) tensor on "
            f"{D.device}"
        )


def _check_aligned(k, *tensors) -> None:
    """For an even k the chunk and quad kernels move two floats at a time:
    D and out must start on an 8-byte boundary.  Checked on every device, so
    that a call that runs here also runs on the card."""
    for A in tensors:
        if A is not None and k % 2 == 0 and A.data_ptr() % 8:
            raise ValueError(
                "for an even k, D and out must start on an 8-byte boundary "
                "(a view at an odd offset of a float32 tensor does not)"
            )


def _parts(n_parts, k, device):
    """Scratch for the partial panels of the split panels."""
    return torch.empty((n_parts, TILE, k), dtype=torch.float32, device=device)


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
        cols = side.win_panel[win].long()[:, None] * (TILE * side.span) + (co >> 7)
        panel = side.win_stripe[win].long() * pps + side.chunk_rp[ids].long()
        rows = panel[:, None] * TILE + (co & (TILE - 1))
        contrib = side.vals[ids].reshape(-1, 1) * D[cols.reshape(-1)]
        out.index_add_(0, rows.reshape(-1), contrib)
    return out[: side.rows]


def chunk_matmul(side: TiledSideC, D):
    """``X_chunks @ D`` (rows, k) for one orientation's chunk store."""
    k = _check_operand(side, D)
    _check_aligned(k, D)
    if not D.is_cuda:
        return chunk_matmul_plain(side, D)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}] for the chunk kernel, got {k}")
    out = torch.empty((side.rows, k), dtype=torch.float32, device=D.device)
    parts = _parts(side.n_parts, k, D.device)
    launch(
        "chunk_matmul",
        side.piece_ptr, side.piece_panel, side.piece_part, side.split_ptr,
        side.split_panel, side.panel_chunks, side.chunk_nreal, side.win_panel,
        side.coords, side.vals, D, out, parts, side.piece_panel.numel(),
        side.split_panel.numel(), side.group, side.span, side.rows, k,
    )
    return out


# ---------------------------------------------------------------------------
# dense store


def _dense_products(side: TiledSideC, D, blocks):
    """``block' @ D_panel`` for the dense blocks ``blocks`` (int64 ids),
    ``(len(blocks), 128, k)``."""
    k = D.shape[1]
    Dp = _pad_rows(D, side.n_colpanels * side.span * TILE).reshape(-1, TILE, k)
    return torch.bmm(side.dvals[blocks].to(D.dtype).transpose(1, 2),
                     Dp[side.dblk_panel[blocks // DENSE_GROUP].long()])


def dense_matmul_plain(side: TiledSideC, D, out=None):
    """Plain version of ``dense_matmul``, the kernel's sum: per piece of the
    dense store, the pieces' blocks' ``block' @ D_panel`` products in block
    order; a split panel's pieces then in piece order; the panel added onto
    ``out`` once.  The products are made ``_PIECE / 128`` blocks at a
    time."""
    k = D.shape[1]
    n_panels = side.n_stripes * side.panels_per_stripe
    acc = D.new_zeros((n_panels, TILE, k))
    if side.n_dblocks:
        blocks = side.dpanel_blocks.long()
        n_pieces = side.dpiece_panel.numel()
        piece_of = torch.repeat_interleave(
            torch.arange(n_pieces, device=D.device), side.dpiece_ptr.diff().long())
        sums = D.new_zeros((n_pieces, TILE, k))
        step = max(_PIECE // TILE, 1)
        for b0 in range(0, blocks.numel(), step):
            sl = slice(b0, b0 + step)
            sums.index_add_(0, piece_of[sl], _dense_products(side, D, blocks[sl]))
        acc.index_add_(0, side.dpiece_panel.long(), sums)
    res = acc.reshape(-1, k)[: side.rows]
    if out is None:
        return res
    return out.add_(res)


def dense_matmul(side: TiledSideC, D, out=None):
    """``out += X_dense @ D`` (rows, k) for one orientation's dense store;
    ``out`` starts from zeros when not given.  Returns ``out``."""
    k = _check_operand(side, D)
    _check_out(side, D, out, k)
    if not D.is_cuda:
        return dense_matmul_plain(side, D, out)
    if not side.dvals.is_contiguous() or side.dvals.data_ptr() % 16:
        raise ValueError("the dense kernel takes contiguous blocks on a 16-byte boundary")
    if out is None:
        out = torch.zeros((side.rows, k), dtype=torch.float32, device=D.device)
    if not side.n_dblocks:
        return out
    parts = _parts(side.n_dparts, k, D.device)
    launch(
        "dense_matmul",
        side.dpiece_ptr, side.dpiece_panel, side.dpiece_part, side.dsplit_ptr,
        side.dsplit_panel, side.dpanel_blocks, side.dblk_panel, side.dvals, D,
        out, parts, side.dpiece_panel.numel(), side.dsplit_panel.numel(),
        DENSE_GROUP, side.rows, side.cols, k,
    )
    return out


# ---------------------------------------------------------------------------
# quad store


def quad_rows_cols(side: TiledSideC, c0, c1, device):
    """Global (row, col) of every slot of quad chunks ``c0:c1``, each
    ``(c1 - c0, 128)`` int64: the row panel comes from the slot's
    sub-segment, the col panel from the chunk's window."""
    nper = TILE // side.quad_seg
    win = torch.arange(c0, c1, device=device) // QUAD_GROUP
    rp = side.q_rp[c0 * nper : c1 * nper].long().repeat_interleave(side.quad_seg)
    panel = (side.qwin_stripe[win].long() * side.panels_per_stripe)[:, None] \
        + rp.reshape(-1, TILE)
    rows = panel * TILE + side.qlrows[c0:c1].long()
    cols = side.qwin_panel[win].long()[:, None] * TILE + side.qlcols[c0:c1].long()
    return rows, cols


def quad_matmul_plain(side: TiledSideC, D, out=None):
    """Plain version of ``quad_matmul``: per piece of the quad store, gather
    D rows at each slot's column, scale by the slot's value, ``index_add_``
    into the slot's output row.  Padding slots (value 0 at local coordinate
    0 of row panel 0) add zero."""
    k = D.shape[1]
    acc = D.new_zeros((side.n_stripes * side.panels_per_stripe * TILE, k))
    step = max(_PIECE // TILE, 1)
    for c0 in range(0, side.n_qchunks, step):
        c1 = min(c0 + step, side.n_qchunks)
        rows, cols = quad_rows_cols(side, c0, c1, D.device)
        contrib = side.qvals[c0:c1].reshape(-1, 1) * D[cols.reshape(-1)]
        acc.index_add_(0, rows.reshape(-1), contrib)
    res = acc[: side.rows]
    if out is None:
        return res
    return out.add_(res)


def quad_matmul(side: TiledSideC, D, out=None):
    """``out += X_quad @ D`` (rows, k) for one orientation's quad store;
    ``out`` starts from zeros when not given.  Returns ``out``."""
    k = _check_operand(side, D)
    _check_out(side, D, out, k)
    _check_aligned(k, D, out)
    if not D.is_cuda:
        return quad_matmul_plain(side, D, out)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}] for the quad kernel, got {k}")
    if out is None:
        out = torch.zeros((side.rows, k), dtype=torch.float32, device=D.device)
    parts = _parts(side.n_qparts, k, D.device)
    launch(
        "quad_matmul",
        side.qpiece_ptr, side.qpiece_panel, side.qpiece_part, side.qsplit_ptr,
        side.qsplit_panel, side.qpanel_segs, side.qseg_nreal, side.qwin_panel,
        side.qlrows, side.qlcols, side.qvals, D, out, parts,
        side.qpiece_panel.numel(), side.qsplit_panel.numel(), QUAD_GROUP,
        side.quad_seg, side.rows, k,
    )
    return out


# ---------------------------------------------------------------------------
# COO band and the whole product


def _rows_summed(rows, cols, vals, D, acc):
    """``acc[rows[e]] += vals[e] * D[cols[e]]`` over the entries in their
    order (gather, scale, ``index_add_``, one piece of the entries at a time,
    so the ``(entries, k)`` products never exist whole).  Returns ``acc``."""
    for e0 in range(0, rows.numel(), _PIECE):
        sl = slice(e0, e0 + _PIECE)
        acc.index_add_(0, rows[sl].long(), vals[sl, None] * D[cols[sl].long()])
    return acc


def coo_matmul_plain(side: TiledSideC, D, out):
    """Plain version of ``coo_matmul``, the reference's order: the band
    summed into zeros row by row in band order, then added onto ``out``
    once."""
    return out.add_(_rows_summed(side.coo_rows, side.coo_cols, side.coo_vals, D,
                                 torch.zeros_like(out)))


def coo_matmul(side: TiledSideC, D, out):
    """``out += X_band @ D``: each row's band entries summed in band order,
    then added to the row of ``out`` once.  Returns ``out``."""
    if out is None:
        raise ValueError("the band product adds into out: pass it")
    k = _check_operand(side, D)
    _check_out(side, D, out, k)
    if not D.is_cuda:
        return coo_matmul_plain(side, D, out)
    if side.n_coo:
        launch("coo_matmul", side.coo_ptr, side.coo_cols, side.coo_vals, D, out,
               side.rows, k)
    return out


def _tiled_matmul_slab(side: TiledSideC, D):
    out = chunk_matmul(side, D)
    if side.n_dblocks:
        out = dense_matmul(side, D, out)
    if side.n_qchunks:
        out = quad_matmul(side, D, out)
    if side.n_coo:
        out = coo_matmul(side, D, out)
    return out


def tiled_matmul_t(side: TiledSideC, D):
    """``X @ D`` for one tiling orientation, in the tiling's coordinates;
    returns (rows, k) float32.  Any k: a D wider than ``MAX_K`` is cut into
    column slabs of at most ``MAX_K`` and the whole chain (chunks, dense
    blocks, quad chunks, band) runs per slab.  Every kernel computes each
    output column on its own (a thread owns its columns, and the pieces of a
    split panel are added element by element), so the slabs give the bits
    one launch over all of D would give."""
    return _in_slabs(lambda d: _tiled_matmul_slab(side, d),
                     D.to(torch.float32).contiguous())


def _in_slabs(product, D):
    """``product(D)``, with a D wider than ``MAX_K`` cut into column slabs of
    at most ``MAX_K`` and the results set side by side."""
    k = D.shape[1]
    if k <= MAX_K:
        return product(D)
    return torch.cat([product(D[:, c0 : c0 + MAX_K].contiguous())
                      for c0 in range(0, k, MAX_K)], dim=1)


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


# ---------------------------------------------------------------------------
# the sampled product: (W @ H) at X's pattern


def _check_factors(side: TiledSideC, W, Ht) -> int:
    for name, A, rows in (("W", W, side.rows), ("Ht", Ht, side.cols)):
        if A.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {A.dtype}")
        if A.dim() != 2 or A.shape[0] != rows:
            raise ValueError(f"{name} must be ({rows}, k), got {tuple(A.shape)}")
        if not A.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
        if A.device != side.coords.device:
            raise ValueError(
                f"{name} lives on {A.device}, the store on {side.coords.device}"
            )
    if W.shape[1] != Ht.shape[1] or W.shape[1] < 1:
        raise ValueError(
            f"W and Ht must share k >= 1, got {tuple(W.shape)}, {tuple(Ht.shape)}"
        )
    if side.inv is None or side.perm is None or (
        side.n_qchunks and side.qinv is None
    ):
        raise ValueError(
            "the sampled product needs the refresh maps, but this TiledCSR "
            "was slim()-med; rebuild with build_tiled"
        )
    return W.shape[1]


def _check_flat_out(out, nslots, W) -> None:
    if out is not None and (
        out.dtype != torch.float32 or tuple(out.shape) != (nslots,)
        or not out.is_contiguous() or out.device != W.device
    ):
        raise ValueError(
            f"out must be a contiguous float32 ({nslots},) tensor on {W.device}"
        )


def _pad_rows(A, rows):
    """A with zero rows appended up to ``rows``."""
    if A.shape[0] == rows:
        return A
    out = A.new_zeros((rows, A.shape[1]))
    out[: A.shape[0]] = A
    return out


def chunk_sddmm_plain(side: TiledSideC, W, Ht, out=None):
    """Plain version of ``chunk_sddmm``: per piece of the chunk store, gather
    the W row and the H column of every slot and reduce over k.  Padding
    slots give 0."""
    pps = side.panels_per_stripe
    nchunks = side.coords.shape[0]
    nnz = side.perm.shape[0]
    if out is None:
        out = W.new_empty(nchunks * TILE)
    Wp = _pad_rows(W, side.n_stripes * pps * TILE)
    Hp = _pad_rows(Ht, side.n_colpanels * side.span * TILE)
    step = max(_PIECE // TILE, 1)
    for c0 in range(0, nchunks, step):
        c1 = min(c0 + step, nchunks)
        ids = torch.arange(c0, c1, device=W.device)
        win = ids // side.group
        co = side.coords[c0:c1].long()
        cols = side.win_panel[win].long()[:, None] * (TILE * side.span) + (co >> 7)
        panel = side.win_stripe[win].long() * pps + side.chunk_rp[c0:c1].long()
        rows = panel[:, None] * TILE + (co & (TILE - 1))
        real = (side.inv[c0 * TILE : c1 * TILE] < nnz).reshape(-1, TILE)
        real &= (rows < side.rows) & (cols < side.cols)
        got = (Wp[rows.reshape(-1)] * Hp[cols.reshape(-1)]).sum(dim=1)
        out[c0 * TILE : c1 * TILE] = got * real.reshape(-1)
    return out


def sddmm_lanes(k) -> int:
    """Lanes of a warp that sample one slot in the sddmm kernels: the
    least power of two that leaves a lane at most ``SDDMM_LANE_FLOATS`` of
    the ``k`` products, at most a warp (8 at k = 128)."""
    g = 1
    while g < 32 and SDDMM_LANE_FLOATS * g < k:
        g *= 2
    return g


def chunk_sddmm(side: TiledSideC, W, Ht, out=None):
    """``(W @ Ht')`` at every slot of one orientation's chunk store, flat
    ``(n_chunks * 128,)`` in slot order; 0 at padding slots.  ``W`` is
    ``(rows, k)`` and ``Ht`` is ``(cols, k)``, both row-major, in the
    tiling's coordinates.  ``out``, when given, receives the result.  The
    kernel walks the store's pieces (a thread block a piece, the piece's
    row panel of W in shared memory) and each chunk's real slots only
    (``chunk_nreal``); the blocks past the pieces zero the chunks without
    entries."""
    k = _check_factors(side, W, Ht)
    nslots = side.coords.shape[0] * TILE
    _check_flat_out(out, nslots, W)
    if not W.is_cuda:
        return chunk_sddmm_plain(side, W, Ht, out)
    if side.inv.dtype != torch.int32:
        raise TypeError("the chunk sddmm kernel takes an int32 refresh map")
    if out is None:
        out = torch.empty(nslots, dtype=torch.float32, device=W.device)
    launch(
        "chunk_sddmm",
        side.piece_ptr, side.piece_panel, side.panel_chunks, side.chunk_nreal,
        side.win_panel, side.coords, side.inv, W, Ht, out,
        side.piece_panel.numel(), side.coords.shape[0], side.group, side.span,
        side.rows, side.cols, k, side.perm.shape[0], sddmm_lanes(k),
    )
    return out


def dense_sample(side: TiledSideC, W, Ht, out=None):
    """``(W @ Ht')`` over every slot of the dense store, flat in the store's
    (block, col, row) order: one batched product per piece of blocks.
    Zero-padding blocks give samples that no ``perm`` entry points at."""
    k = W.shape[1]
    pps = side.panels_per_stripe
    if out is None:
        out = W.new_empty(side.n_dblocks * TILE * TILE)
    Wp = _pad_rows(W, side.n_stripes * pps * TILE).reshape(-1, TILE, k)
    Hp = _pad_rows(Ht, side.n_colpanels * side.span * TILE).reshape(-1, TILE, k)
    step = max(_PIECE // TILE, 1)
    for b0 in range(0, side.n_dblocks, step):
        b1 = min(b0 + step, side.n_dblocks)
        win = torch.arange(b0, b1, device=W.device) // DENSE_GROUP
        panel = side.dblk_stripe[win].long() * pps + side.dblk_rp[b0:b1].long()
        torch.bmm(
            Hp[side.dblk_panel[win].long()], Wp[panel].transpose(1, 2),
            out=out[b0 * TILE * TILE : b1 * TILE * TILE].view(-1, TILE, TILE),
        )
    return out


def quad_sddmm_plain(side: TiledSideC, W, Ht, out=None):
    """Plain version of ``quad_sddmm``: per piece of the quad store, gather
    the W row (through the slot's sub-segment's row panel) and the H column
    of every slot and reduce over k.  Padding slots give 0."""
    nnz = side.perm.shape[0]
    if out is None:
        out = W.new_empty(side.n_qchunks * TILE)
    Wp = _pad_rows(W, side.n_stripes * side.panels_per_stripe * TILE)
    Hp = _pad_rows(Ht, side.n_colpanels * TILE)
    step = max(_PIECE // TILE, 1)
    for c0 in range(0, side.n_qchunks, step):
        c1 = min(c0 + step, side.n_qchunks)
        rows, cols = quad_rows_cols(side, c0, c1, W.device)
        real = (side.qinv[c0 * TILE : c1 * TILE] < nnz).reshape(-1, TILE)
        real &= (rows < side.rows) & (cols < side.cols)
        got = (Wp[rows.reshape(-1)] * Hp[cols.reshape(-1)]).sum(dim=1)
        out[c0 * TILE : c1 * TILE] = got * real.reshape(-1)
    return out


def quad_sddmm(side: TiledSideC, W, Ht, out=None):
    """``(W @ Ht')`` at every slot of one orientation's quad store, flat
    ``(n_qchunks * 128,)`` in slot order; 0 at padding slots.  Operands as
    for ``chunk_sddmm``, and the kernel walks the same way: over the quad
    pieces (a block a piece, its row panel of W in shared memory), each
    sub-segment's real slots only (``qseg_nreal``); the blocks past the
    pieces zero the sub-segments without entries."""
    k = _check_factors(side, W, Ht)
    nslots = side.n_qchunks * TILE
    _check_flat_out(out, nslots, W)
    if not W.is_cuda:
        return quad_sddmm_plain(side, W, Ht, out)
    if side.qinv.dtype != torch.int32:
        raise TypeError("the quad sddmm kernel takes an int32 refresh map")
    if out is None:
        out = torch.empty(nslots, dtype=torch.float32, device=W.device)
    launch(
        "quad_sddmm",
        side.qpiece_ptr, side.qpiece_panel, side.qpanel_segs, side.qseg_nreal,
        side.qwin_panel, side.qlrows, side.qlcols, side.qinv, W, Ht, out,
        side.qpiece_panel.numel(), side.n_qchunks, QUAD_GROUP, side.quad_seg,
        side.rows, side.cols, k, side.perm.shape[0], sddmm_lanes(k),
    )
    return out


def coo_sample(side: TiledSideC, W, Ht, out=None):
    """``(W @ Ht')`` at every entry of the COO band: gather, gather, reduce,
    one piece of the band at a time."""
    if out is None:
        out = W.new_empty(side.n_coo)
    return _sampled(side.coo_rows, side.coo_cols, W, Ht, out)


def _sampled(rows, cols, W, Ht, out):
    """``out[e] = W[rows[e]] . Ht[cols[e]]``: gather, gather, reduce, one
    piece of the entries at a time.  Returns ``out``."""
    for e0 in range(0, rows.numel(), _PIECE):
        sl = slice(e0, e0 + _PIECE)
        out[sl] = (W[rows[sl].long()] * Ht[cols[sl].long()]).sum(dim=1)
    return out


def tiled_sddmm(X: TiledCSR, W, H):
    """Values of ``(W @ H)`` at X's nonzeros, ``(nnz,)`` in CSR order, in
    W's dtype (computed in float32).  The forward side's slots are sampled
    class by class into one flat vector (chunks, dense blocks, quad chunks,
    band) that ``perm`` gathers into CSR order.  Degree-ordered tilings
    gather W's rows and H's columns into the renumbered coordinates first."""
    side = X.fwd
    if X.row_perm is not None:
        W = W.index_select(0, X.row_perm.long())
    if X.col_perm is not None:
        H = H.index_select(1, X.col_perm.long())
    W32 = W.to(torch.float32).contiguous()
    Ht = H.to(torch.float32).T.contiguous()
    n_chunk = side.coords.shape[0] * TILE
    q0 = n_chunk + side.n_dblocks * TILE * TILE
    c0 = q0 + side.n_qchunks * TILE
    flat = torch.empty(c0 + side.n_coo, dtype=torch.float32, device=W32.device)
    chunk_sddmm(side, W32, Ht, flat[:n_chunk])
    if side.n_dblocks:
        dense_sample(side, W32, Ht, flat[n_chunk:q0])
    if side.n_qchunks:
        quad_sddmm(side, W32, Ht, flat[q0:c0])
    if side.n_coo:
        coo_sample(side, W32, Ht, flat[c0:])
    return flat[side.perm.long()].to(W.dtype)


# ---------------------------------------------------------------------------
# a general sparse X (``SparseCSR``): the general-CSR kernel over its pieces


def _check_csr(side: CSRSide, D, name="D") -> int:
    if D.dim() != 2 or D.shape[0] != side.cols:
        raise ValueError(f"{name} must be ({side.cols}, k), got {tuple(D.shape)}")
    if D.device != side.val.device:
        raise ValueError(f"{name} lives on {D.device}, X on {side.val.device}")
    if D.is_cuda and not (side.val.dtype == D.dtype == torch.float32):
        raise TypeError(
            "the card's sparse products are float32: X holds "
            f"{side.val.dtype} and {name} {D.dtype}; convert X with "
            ".to(torch.float32) (or run on the CPU)")
    return D.shape[1]


def csr_matmul_plain(side: CSRSide, D):
    """Plain version of ``csr_matmul``, in the kernel's order: each piece's
    entries summed into zeros in CSR order (``_rows_summed`` over the
    pieces); a row of one piece is its piece's sum (an empty row zeros); a
    row of several is ``((p0 + p1) + p2) + ...`` over its pieces' sums in
    piece order."""
    k = D.shape[1]
    n_pieces = side.piece_row.numel()
    piece_of = torch.repeat_interleave(
        torch.arange(n_pieces, device=D.device), side.piece_ptr.diff().long(),
        output_size=side.val.numel())
    sums = _rows_summed(piece_of, side.col, side.val, D, D.new_zeros((n_pieces, k)))
    first = torch.ones(n_pieces, dtype=torch.bool, device=D.device)
    first[1:] = side.piece_row[1:] != side.piece_row[:-1]
    out = sums[first]  # every row has a piece: one a row, in row order
    if side.split_row.numel():
        parts = sums[side.piece_part >= 0]  # in slot order, the pieces' order
        start = side.split_ptr[:-1].long()
        count = side.split_ptr.diff().long()
        acc = parts[start]
        for q in range(1, int(count.max())):
            live = count > q
            acc[live] += parts[start[live] + q]
        out[side.split_row.long()] = acc
    return out


# the general-CSR kernel reads the pieces' columns and values with
# evict-first loads (faster at ttt4 in 13 of 16 readings, by up to 7 %) and
# gathers all of D's columns in one pass (slabs that fit the L2 lost 5-94 %;
# PERF.md, ``chip_smoke.py`` phase kernels_general_csr)
CSR_STREAM_LOADS = True


def csr_launch(side: CSRSide, D, slab, stream_loads):
    """One launch of the general-CSR kernel (``csrc/csr_matmul.cu``) over
    the pieces of ``side``: ``X @ D`` (rows, k) float32, every row written
    once (``torch.empty``); the split rows' partial sums in a scratch of
    ``n_parts`` rows.  ``slab``: columns of D a pass gathers (k, or a
    multiple of 4); ``stream_loads``: evict-first loads of the pieces'
    columns and values.  Neither changes a bit; ``csr_matmul`` passes k and
    ``CSR_STREAM_LOADS``, a measurement may pass others."""
    k = D.shape[1]
    for name, t in (("piece_ptr", side.piece_ptr), ("col", side.col)):
        if t.dtype != torch.int32 or t.device != D.device:
            raise TypeError(f"the general-CSR kernel takes int32 {name} on {D.device}")
    out = torch.empty((side.rows, k), dtype=torch.float32, device=D.device)
    parts = torch.empty((side.n_parts, k), dtype=torch.float32, device=D.device)
    if side.rows:
        launch("csr_matmul", side.piece_ptr, side.piece_row, side.piece_part,
               side.split_ptr, side.split_row, side.col, side.val, D, out, parts,
               side.piece_row.numel(), side.split_row.numel(), k, slab,
               int(stream_loads))
    return out


def csr_matmul(side: CSRSide, D):
    """``X @ D`` (rows, k) for one orientation of a general sparse X, in
    X's dtype.  On the card this is the general-CSR kernel
    (``csrc/csr_matmul.cu``): a warp a piece of a row, each piece summed in
    CSR order and a split row's pieces added in piece order, so the sums
    repeat bit for bit; it takes float32 only."""
    k = _check_csr(side, D)
    if not D.is_cuda:
        return csr_matmul_plain(side, D)
    if not D.is_contiguous():
        raise ValueError("D must be contiguous (row-major)")
    return csr_launch(side, D, k, CSR_STREAM_LOADS)


def csr_mm(side: CSRSide, D):
    """``X @ D`` for any k: D in X's dtype, cut into column slabs of at most
    ``MAX_K`` as ``tiled_matmul_t`` cuts it; the result in D's dtype."""
    return _in_slabs(lambda d: csr_matmul(side, d),
                     D.to(side.val.dtype).contiguous()).to(D.dtype)


def csr_sample(side: CSRSide, W, H):
    """Values of ``W @ H`` at X's entries, ``(nnz,)`` in CSR order: the
    band's gather, gather, reduce (``coo_sample``) over all of X, one piece
    at a time.  On the card float32 only, as the products."""
    Ht = H.T.contiguous()
    _check_csr(side, Ht, "H'")
    if W.dim() != 2 or W.shape != (side.rows, Ht.shape[1]) or W.dtype != Ht.dtype \
            or W.device != Ht.device:
        raise ValueError(
            f"W must be ({side.rows}, {Ht.shape[1]}) of H's dtype and device, "
            f"got {tuple(W.shape)} {W.dtype} on {W.device}")
    return _sampled(side.row, side.col, W, Ht, W.new_empty(side.val.numel()))
