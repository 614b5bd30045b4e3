"""Tiled sparse store for the sparse-dense products.

The matrix is cut into (128-row x 128-col) tiles, grouped into row *stripes*.
Tiles fall into four classes by their nonzero count:

* **dense store** — tiles with at least ``dense_tile_nnz`` nonzeros are kept
  as plain 128x128 blocks in (col, row) layout;
* **chunk store** — other tiles have their nonzeros padded into 128-slot
  chunks holding ``(local_col << 7 | local_row, value)``; chunks are stored
  flat, grouped by (stripe, col panel), each group padded to a multiple of
  ``group`` chunks (a *window*).  With ``tail_span > 1`` a chunk tile is
  ``tail_span`` col panels wide and ``local_col`` runs to ``tail_span * 128``;
* **quad store** — tiles with at most ``quad_tail_nnz`` nonzeros share a
  chunk: ``128 / quad_seg`` tiles of one (stripe, col panel), each in its own
  ``quad_seg``-slot sub-segment with its own row panel;
* **COO band** — tiles with at most ``coo_tail_nnz`` nonzeros skip the tile
  machinery and are kept as row-sorted COO triples.

Both orientations are prebuilt (for ``X @ D`` and ``X' @ D``), plus CSR-order
COO arrays and permutations mapping CSR-order values into each orientation's
slots, so a value refresh (``with_values``) is a gather and a scatter.

The built arrays equal those of the JAX package's ``build_tiled`` on the same
input, with two differences that belong to the card: ``chunk_rp``,
``dblk_rp`` and ``q_rp`` hold one int32 per chunk / block / sub-segment (no
byte packing), and each side carries a *row-panel index* — for every 128-row
output panel the list of chunks, of dense blocks and of quad sub-segments
that add into it — which is what lets one thread block own one output panel,
and the *pieces* that cut the chunk and quad lists into runs of at most
``PIECE_ENTRIES`` entries (the dense block lists into runs of at most
``DENSE_PIECE_BLOCKS`` blocks), so that the work of a heavy panel is shared
by several thread blocks and added in a fixed order; and a row pointer over
the band (``coo_ptr``), so that each row's band entries are summed in band
order.

The binning is numpy on the host; the built arrays are tensors on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..io.loader import (
    chunk_fill,
    class_extract,
    dense_scatter,
    gather3,
    gather3k,
    stable_argsort,
    tile_key,
)

TILE = 128  # row-panel height == col-panel width == chunk capacity
DENSE_GROUP = 8  # dense-tile blocks per window (same stripe and col panel)
QUAD_GROUP = 8  # quad chunks per window (same stripe and col panel)

__all__ = [
    "TILE",
    "DENSE_GROUP",
    "QUAD_GROUP",
    "TiledSideC",
    "TiledCSR",
    "build_tiled",
]

_REFRESH_MAPS = ("perm", "inv", "qinv", "dense_nnz", "dense_slot", "coo_nnz")
# entries (stored nonzeros) one piece of a panel's work list holds at most;
# at least TILE, so that every chunk fits one piece
PIECE_ENTRIES = 2048
_PIECES = ("piece_ptr", "piece_panel", "piece_part", "split_ptr", "split_panel",
           "n_parts")
_QPIECES = ("qpiece_ptr", "qpiece_panel", "qpiece_part", "qsplit_ptr",
            "qsplit_panel", "n_qparts")
# dense blocks one piece of a panel's block list holds at most (the sweep
# behind the value: PERF.md, ``tools/time_sparse_kernels.py``)
DENSE_PIECE_BLOCKS = 16
_DPIECES = ("dpiece_ptr", "dpiece_panel", "dpiece_part", "dsplit_ptr",
            "dsplit_panel", "n_dparts")
# what ``row_panel_index`` derives from the stored arrays
INDEX_FIELDS = ("panel_ptr", "panel_chunks", "dpanel_ptr", "dpanel_blocks",
                "qpanel_ptr", "qpanel_segs", "chunk_nreal", "qseg_nreal",
                "coo_ptr", *_PIECES, *_QPIECES, *_DPIECES)


@dataclasses.dataclass(frozen=True)
class TiledSideC:
    """One orientation of the store: only *nonempty* tiles carry chunks.

    ``win_stripe`` / ``win_panel`` (and the ``dblk_*`` / ``qwin_*`` twins)
    carry a final sentinel entry (-1 / 0), and stripes without any tile own
    one all-padding window: both are kept so the arrays compare equal with
    the JAX package's; the kernels here walk the row-panel index and never
    look at them."""

    coords: torch.Tensor  # (nwin*group, TILE) int32: ``lcol << 7 | lrow``
    vals: torch.Tensor  # (nwin*group, TILE) float32
    chunk_rp: torch.Tensor  # (nwin*group,) int32: row panel in stripe, per chunk
    win_panel: torch.Tensor  # (nwin+1,) int32 col panel per window
    win_stripe: torch.Tensor  # (nwin+1,) int32 stripe per window (-1 sentinel)
    perm: torch.Tensor | None  # (nnz,) int64: CSR-order entry -> flat slot
    n_stripes: int = 1
    n_colpanels: int = 1
    n_windows: int = 1
    group: int = 8
    panels_per_stripe: int = 1
    rows: int = 0
    cols: int = 0
    # (nchunks*TILE,) CSR-order nnz index per chunk slot (padding slots point
    # one past the end): value refreshes are a gather
    inv: torch.Tensor | None = None
    # dense store: ``dvals[b]`` is block b in (col, row) layout
    dvals: torch.Tensor | None = None  # (ndblk, TILE, TILE) float32
    dblk_panel: torch.Tensor | None = None  # (nwin_d+1,) int32
    dblk_stripe: torch.Tensor | None = None  # (nwin_d+1,) int32, -1 sentinel
    dblk_rp: torch.Tensor | None = None  # (ndblk,) int32, per block
    n_dblocks: int = 0  # padded block count (DENSE_GROUP-multiple)
    # chunk tiles span this many consecutive 128-col panels; a slot's local
    # column is in [0, span*128) and n_colpanels counts the WIDE panels
    span: int = 1
    # quad store: chunk q holds TILE // quad_seg tiles of one (stripe, col
    # panel), tile s in slots [s*quad_seg, (s+1)*quad_seg) of row q
    qvals: torch.Tensor | None = None  # (nq, TILE) float32
    qlrows: torch.Tensor | None = None  # (nq, TILE) int32 row in the panel
    qlcols: torch.Tensor | None = None  # (nq, TILE) int32 col in the panel
    q_rp: torch.Tensor | None = None  # (nq * TILE // quad_seg,) int32, per sub-segment
    qwin_panel: torch.Tensor | None = None  # (nwin_q+1,) int32
    qwin_stripe: torch.Tensor | None = None  # (nwin_q+1,) int32, -1 sentinel
    n_qchunks: int = 0  # padded chunk count (QUAD_GROUP-multiple)
    quad_seg: int = 32  # slots per sub-segment: 32 or 16
    # (nq*TILE,) CSR-order nnz index per quad slot (see inv)
    qinv: torch.Tensor | None = None
    # dense-store refresh: dvals.flat[dense_slot] = new[dense_nnz]
    dense_nnz: torch.Tensor | None = None
    dense_slot: torch.Tensor | None = None
    # COO band, in tiling (renumbered) coordinates, sorted by this side's row
    coo_rows: torch.Tensor | None = None  # (n_coo,) int32
    coo_cols: torch.Tensor | None = None  # (n_coo,) int32
    coo_vals: torch.Tensor | None = None  # (n_coo,) float32
    coo_nnz: torch.Tensor | None = None  # CSR-order nnz id per band entry
    n_coo: int = 0
    # row pointer over the band: row r's entries are
    # ``coo_ptr[r]:coo_ptr[r+1]`` (the band is sorted by row)
    coo_ptr: torch.Tensor | None = None  # (rows + 1,) int32
    # row-panel index: chunks ``panel_chunks[panel_ptr[r]:panel_ptr[r+1]]``
    # add into global row panel r (= stripe * panels_per_stripe + chunk_rp);
    # all-padding chunks are left out.  ``dpanel_*`` is the same over the
    # dense blocks, ``qpanel_*`` over the quad sub-segments (sub-segment
    # ``q * (TILE // quad_seg) + s`` is tile s of quad chunk q).
    panel_ptr: torch.Tensor | None = None  # (n_stripes*pps + 1,) int32
    panel_chunks: torch.Tensor | None = None  # (n real chunks,) int32
    dpanel_ptr: torch.Tensor | None = None  # (n_stripes*pps + 1,) int32
    dpanel_blocks: torch.Tensor | None = None  # (n real blocks,) int32
    qpanel_ptr: torch.Tensor | None = None  # (n_stripes*pps + 1,) int32
    qpanel_segs: torch.Tensor | None = None  # (n real sub-segments,) int32
    # pieces: each panel's list cut into runs of consecutive chunks holding at
    # most ``PIECE_ENTRIES`` entries together, one thread block a piece.
    # Piece p adds ``panel_chunks[piece_ptr[p]:piece_ptr[p+1]]`` into row panel
    # ``piece_panel[p]``; a panel of the output without chunks keeps one empty
    # piece (its rows are written as zeros).  A panel of several pieces is *split*: piece
    # p writes a partial panel to row ``piece_part[p]`` of a scratch tensor
    # (-1: the panel's only piece, written straight to the output), and the
    # partials of split panel ``split_panel[s]`` are rows
    # ``split_ptr[s]:split_ptr[s+1]``, added in piece order.  ``q*`` is the
    # same over the quad sub-segments, where a panel without any gets no piece.
    chunk_nreal: torch.Tensor | None = None  # (nchunks,) int32 entries, at the front
    piece_ptr: torch.Tensor | None = None  # (n_pieces + 1,) int32
    piece_panel: torch.Tensor | None = None  # (n_pieces,) int32
    piece_part: torch.Tensor | None = None  # (n_pieces,) int32
    split_ptr: torch.Tensor | None = None  # (n_split + 1,) int32
    split_panel: torch.Tensor | None = None  # (n_split,) int32
    n_parts: int = 0  # pieces of split panels (rows of the scratch)
    qseg_nreal: torch.Tensor | None = None  # (nq * TILE // quad_seg,) int32
    qpiece_ptr: torch.Tensor | None = None
    qpiece_panel: torch.Tensor | None = None
    qpiece_part: torch.Tensor | None = None
    qsplit_ptr: torch.Tensor | None = None
    qsplit_panel: torch.Tensor | None = None
    n_qparts: int = 0
    # ``d*`` is the same over the dense blocks, each block counting one, at
    # most ``DENSE_PIECE_BLOCKS`` a piece; a panel without blocks gets no piece
    dpiece_ptr: torch.Tensor | None = None
    dpiece_panel: torch.Tensor | None = None
    dpiece_part: torch.Tensor | None = None
    dsplit_ptr: torch.Tensor | None = None
    dsplit_panel: torch.Tensor | None = None
    n_dparts: int = 0


@dataclasses.dataclass(frozen=True)
class TiledCSR:
    """Both orientations + CSR-order COO arrays."""

    fwd: TiledSideC  # X tiling (p x n)
    bwd: TiledSideC  # X' tiling (n x p)
    row_idx: torch.Tensor | None  # (nnz,) int32, CSR order, ORIGINAL coords
    col_idx: torch.Tensor | None  # (nnz,) int32
    values: torch.Tensor | None  # (nnz,)
    # degree-sort renumbering (None = natural order): the tilings are built
    # in renumbered coordinates so head rows/cols pack into dense tiles;
    # ``*_perm[sorted] = original``, ``*_rank[original] = sorted``
    row_perm: torch.Tensor | None = None
    row_rank: torch.Tensor | None = None
    col_perm: torch.Tensor | None = None
    col_rank: torch.Tensor | None = None
    shape: tuple[int, int] = (0, 0)
    # (stripe_tiles, layout, group, dense_tile_nnz, quad_tail_nnz, quad_seg,
    # coo_tail_nnz) the matrix was built with
    build_opts: tuple | None = None
    # (sum, sum of squares, min) of the values: sq_norm/total_sum/all_nonneg
    # run without touching the (nnz,) values array, which ``slim()`` drops
    stats: torch.Tensor | None = None

    @property
    def dtype(self):
        return self.fwd.vals.dtype

    @property
    def device(self):
        return self.fwd.vals.device

    @property
    def nnz(self):
        return self.values.shape[0]

    @property
    def ndim(self):
        return 2

    def slim(self):
        """Device-light view for MSE-family solves: drops the CSR-order
        refresh maps and the COO arrays, none of which the products or the
        Gram-identity objective touch, keeping the kernel operands, the
        degree permutations and ``stats``.  ``with_values`` raises on a
        slimmed instance."""
        strip = dict.fromkeys(_REFRESH_MAPS)
        return dataclasses.replace(
            self,
            fwd=dataclasses.replace(self.fwd, **strip),
            bwd=dataclasses.replace(self.bwd, **strip),
            row_idx=None,
            col_idx=None,
            values=None,
        )

    def with_values(self, new_values):
        """Same pattern, new values (CSR order): refreshes both orientations.
        The chunk and quad regions are inverse-perm gathers (padding slots
        fill with 0), the dense store an O(nnz_dense) scatter."""

        def refresh(side):
            if side.inv is None or (side.n_dblocks and side.dense_nnz is None) or (
                side.n_coo and side.coo_nnz is None
            ) or (side.n_qchunks and side.qinv is None):
                raise ValueError(
                    "with_values needs the refresh maps, but this TiledCSR "
                    "was slim()-med; rebuild with build_tiled"
                )
            v32 = new_values.to(torch.float32)
            filled = torch.cat([v32, v32.new_zeros(1)])
            kw = {"vals": filled[side.inv.long()].reshape(side.vals.shape)}
            if side.n_dblocks:
                flat = v32.new_zeros(side.dvals.numel())
                flat[side.dense_slot.long()] = v32[side.dense_nnz.long()]
                kw["dvals"] = flat.reshape(side.dvals.shape)
            if side.n_qchunks:
                kw["qvals"] = filled[side.qinv.long()].reshape(side.qvals.shape)
            if side.n_coo:
                kw["coo_vals"] = v32[side.coo_nnz.long()]
            return dataclasses.replace(side, **kw)

        v32 = new_values.to(torch.float32)
        return dataclasses.replace(
            self,
            fwd=refresh(self.fwd),
            bwd=refresh(self.bwd),
            values=new_values,
            stats=torch.stack([v32.sum(), (v32 * v32).sum(), v32.min()]),
        )

    def transpose(self):
        return dataclasses.replace(
            self,
            fwd=self.bwd,
            bwd=self.fwd,
            row_idx=self.col_idx,
            col_idx=self.row_idx,
            row_perm=self.col_perm,
            row_rank=self.col_rank,
            col_perm=self.row_perm,
            col_rank=self.row_rank,
            shape=(self.shape[1], self.shape[0]),
        )


def _uniq_sorted(a, counts=False, index=False, inverse=False):
    """np.unique for an already-sorted key array: one O(n) neighbour-diff
    scan instead of a re-sort.  Returns (uniq, [first_index], [counts],
    [inverse]) per the flags."""
    n = len(a)
    if n == 0:
        z = np.zeros(0, np.int64)
        out = [a] + [z] * (index + counts + inverse)
        return tuple(out) if len(out) > 1 else a
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(a[1:], a[:-1], out=change[1:])
    first = np.flatnonzero(change)
    out = [a[first]]
    if index:
        out.append(first)
    if counts:
        out.append(np.diff(np.append(first, n)))
    if inverse:
        out.append(np.cumsum(change) - 1)
    return tuple(out) if len(out) > 1 else out[0]


def _by_panel(panel_of_item, real, n_panels):
    """CSR-style index of the ``real`` items by their global row panel:
    ``(ptr, items)`` with items of one panel in increasing item order, so the
    order of summation inside a panel is fixed by the store."""
    items = np.flatnonzero(real)
    pan = panel_of_item[items]
    o = np.argsort(pan, kind="stable")
    ptr = np.zeros(n_panels + 1, np.int64)
    np.cumsum(np.bincount(pan, minlength=n_panels), out=ptr[1:])
    return ptr.astype(np.int32), items[o].astype(np.int32)


def _front_count(real):
    """Per row of the (items, slots) mask ``real``: one past its last real
    slot (0 when it has none).  The binner packs an item's entries at its
    front, so this is the item's count of entries."""
    last = real.shape[1] - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(1), last, 0).astype(np.int32)


def _cut_pieces(ptr, items, nreal, cap, keep_empty, names):
    """Cut each panel's list ``items[ptr[r]:ptr[r+1]]`` into pieces: runs of
    consecutive items holding at most ``cap`` entries together (``nreal``
    per item), cut greedily in list order, so a panel of at most ``cap``
    entries is one piece.  The first ``keep_empty`` panels get one empty
    piece when they have no items.  Returns the six piece fields under
    ``names``."""
    counts = nreal[items]
    if len(counts) and cap < counts.max():
        raise ValueError(
            f"a piece must hold the largest item's {counts.max()} entries, "
            f"got a cap of {cap}")
    cum = np.zeros(len(items) + 1, np.int64)
    np.cumsum(counts, out=cum[1:])
    starts, panels = [], []
    for r in range(len(ptr) - 1):
        b, e = int(ptr[r]), int(ptr[r + 1])
        if b == e and r < keep_empty:
            starts.append(b)
            panels.append(r)
        while b < e:
            starts.append(b)
            panels.append(r)
            # past the last item that keeps the piece within the cap
            b = min(int(np.searchsorted(cum, cum[b] + cap, side="right")) - 1, e)
    piece_ptr = np.append(np.asarray(starts, np.int64), len(items)).astype(np.int32)
    piece_panel = np.asarray(panels, np.int32)
    n_of = np.bincount(piece_panel, minlength=len(ptr) - 1)
    split = n_of[piece_panel] > 1
    piece_part = np.full(len(panels), -1, np.int32)
    piece_part[split] = np.arange(int(split.sum()), dtype=np.int32)
    split_panel = np.flatnonzero(n_of > 1).astype(np.int32)
    split_ptr = np.zeros(len(split_panel) + 1, np.int32)
    np.cumsum(n_of[split_panel], out=split_ptr[1:])
    return dict(zip(names, (piece_ptr, piece_panel, piece_part, split_ptr,
                            split_panel, int(split.sum()))))


def row_panel_index(f):
    """The row-panel index of one side from its stored arrays (numpy, in a
    dict keyed like ``TiledSideC``), with each item's count of entries, the
    pieces of at most ``PIECE_ENTRIES`` entries (``DENSE_PIECE_BLOCKS`` dense
    blocks) and the band's row pointer.  A chunk, block or quad
    sub-segment takes part when it holds any entry of the pattern — read off
    the refresh maps where the side has them, else off the stored values,
    where an all-zero chunk, block or sub-segment adds nothing either way.
    That leaves out the sub-segments nothing was packed into, whose row panel
    reads 0."""
    pps, group = f["panels_per_stripe"], f["group"]
    n_panels = f["n_stripes"] * pps
    nchunks = f["coords"].shape[0]
    stripe = np.repeat(f["win_stripe"][:-1].astype(np.int64), group)
    panel = stripe * pps + f["chunk_rp"]
    if f.get("inv") is not None and f.get("perm") is not None:
        # padding slots point one past the last CSR-order entry
        slots = f["inv"].reshape(nchunks, TILE) != len(f["perm"])
    else:
        slots = (f["vals"] != 0) | (f["coords"] != 0)
    nreal = _front_count(slots)
    out = dict(zip(("panel_ptr", "panel_chunks"), _by_panel(panel, nreal > 0, n_panels)))
    out["chunk_nreal"] = nreal
    out.update(_cut_pieces(out["panel_ptr"], out["panel_chunks"], nreal, PIECE_ENTRIES,
                           -(-f["rows"] // TILE), _PIECES))
    if f["n_dblocks"]:
        dstripe = np.repeat(f["dblk_stripe"][:-1].astype(np.int64), DENSE_GROUP)
        dpanel = dstripe * pps + f["dblk_rp"]
        if f.get("dense_slot") is not None:
            dreal = np.zeros(f["n_dblocks"], bool)
            dreal[f["dense_slot"] // (TILE * TILE)] = True
        else:
            dreal = (f["dvals"] != 0).any((1, 2))
        out.update(
            zip(("dpanel_ptr", "dpanel_blocks"), _by_panel(dpanel, dreal, n_panels))
        )
        out.update(_cut_pieces(out["dpanel_ptr"], out["dpanel_blocks"],
                               np.ones(f["n_dblocks"], np.int64),
                               DENSE_PIECE_BLOCKS, 0, _DPIECES))
    if f.get("n_coo"):
        out["coo_ptr"] = np.zeros(f["rows"] + 1, np.int32)
        np.cumsum(np.bincount(f["coo_rows"], minlength=f["rows"]),
                  out=out["coo_ptr"][1:])
    if f.get("n_qchunks"):
        seg = f["quad_seg"]
        nper = TILE // seg
        qstripe = np.repeat(f["qwin_stripe"][:-1].astype(np.int64), QUAD_GROUP * nper)
        qpanel = qstripe * pps + f["q_rp"]
        if f.get("qinv") is not None and f.get("perm") is not None:
            qslots = f["qinv"].reshape(-1, seg) != len(f["perm"])
        else:
            qslots = (f["qvals"].reshape(-1, seg) != 0) | (
                (f["qlrows"] | f["qlcols"]).reshape(-1, seg) != 0)
        qnreal = _front_count(qslots)
        out.update(
            zip(("qpanel_ptr", "qpanel_segs"), _by_panel(qpanel, qnreal > 0, n_panels))
        )
        out["qseg_nreal"] = qnreal
        out.update(_cut_pieces(out["qpanel_ptr"], out["qpanel_segs"], qnreal,
                               PIECE_ENTRIES, 0, _QPIECES))
    return out


def recut_pieces(side: TiledSideC, cap=None, qcap=None, dcap=None) -> TiledSideC:
    """``side`` with its chunk pieces cut again at ``cap`` entries, its quad
    pieces at ``qcap`` entries and its dense pieces at ``dcap`` blocks (None
    keeps them).  A small cap splits most panels: the tests and the card's
    checks use it to run the pass that adds partial panels."""
    host = lambda t: t.cpu().numpy()
    kw = {}
    if cap is not None:
        kw.update(_cut_pieces(host(side.panel_ptr), host(side.panel_chunks),
                              host(side.chunk_nreal), cap, -(-side.rows // TILE),
                              _PIECES))
    if qcap is not None and side.qpanel_ptr is not None:
        kw.update(_cut_pieces(host(side.qpanel_ptr), host(side.qpanel_segs),
                              host(side.qseg_nreal), qcap, 0, _QPIECES))
    if dcap is not None and side.dpanel_ptr is not None:
        kw.update(_cut_pieces(host(side.dpanel_ptr), host(side.dpanel_blocks),
                              np.ones(side.n_dblocks, np.int64), dcap, 0, _DPIECES))
    dev = side.coords.device
    return dataclasses.replace(side, **{
        name: to_tensor(v, dev) if isinstance(v, np.ndarray) else v
        for name, v in kw.items()
    })


def _build_side_compact(rows, cols, vals, p, n, stripe_tiles, group,
                        dense_thresh=None, tail_span=1, quad_tail_nnz=None,
                        quad_seg=32, coo_tail_nnz=None):
    """Bin (row, col, val) into the store for one orientation; returns a dict
    of numpy arrays and ints keyed like ``TiledSideC``.

    ``dense_thresh``: tiles with at least this many nonzeros are stored as
    dense 128x128 blocks instead of chunks.  ``tail_span``: chunk tiles span
    this many consecutive 128-col panels (ultra-sparse residuals would
    otherwise spend a whole 128-slot chunk per 128x128 tile).
    ``quad_tail_nnz``: tiles with at most this many nonzeros (<= ``quad_seg``)
    are packed ``128 // quad_seg`` per chunk as fixed sub-segments (same
    stripe and col panel, one row panel per sub-segment); not together with
    ``tail_span > 1``.  ``coo_tail_nnz``: tiles with at most this many
    nonzeros go to the COO band."""
    if tail_span not in (1, 2, 4, 8, 16):
        raise ValueError("tail_span must be one of 1, 2, 4, 8, 16")
    if quad_seg not in (16, 32):
        raise ValueError("quad_seg must be 16 or 32")
    if quad_tail_nnz is not None:
        if tail_span != 1:
            raise ValueError("quad_tail_nnz requires tail_span == 1")
        if not (1 <= quad_tail_nnz <= quad_seg):
            raise ValueError(f"quad_tail_nnz must be in [1, {quad_seg}]")
    if coo_tail_nnz is not None:
        if coo_tail_nnz < 1:
            raise ValueError("coo_tail_nnz must be >= 1")
        if dense_thresh and coo_tail_nnz >= dense_thresh:
            raise ValueError("coo_tail_nnz must be < dense_tile_nnz")
    if group % 8:
        raise ValueError(f"group must be a multiple of 8, got {group}")
    n_rowpanels = -(-p // TILE)
    n_colpanels = -(-n // TILE)
    stripe_tiles = min(stripe_tiles, n_rowpanels)
    if stripe_tiles > 256:
        # kept from the JAX package (its row panels are byte-packed) so both
        # packages accept the same inputs
        raise ValueError(
            f"stripe_tiles (clamped to {stripe_tiles}) must be <= 256"
        )
    n_stripes = -(-n_rowpanels // stripe_tiles)

    # stable argsort of the fused tile key == lexsort((rps, cp, stripe))
    key = tile_key(rows, cols, n_colpanels, stripe_tiles)
    order = stable_argsort(key)
    a_rows, a_cols, a_vals, akey = gather3k(order, rows, cols, vals, key)

    tiles_all, counts_all = _uniq_sorted(akey, counts=True)
    if dense_thresh and len(tiles_all):
        tile_dense = counts_all >= dense_thresh
    else:
        tile_dense = np.zeros(len(tiles_all), bool)
    if coo_tail_nnz and len(tiles_all):
        tile_coo = (~tile_dense) & (counts_all <= coo_tail_nnz)
    else:
        tile_coo = np.zeros(len(tiles_all), bool)
    if quad_tail_nnz and len(tiles_all):
        tile_quad = (~tile_dense) & (~tile_coo) & (counts_all <= quad_tail_nnz)
    else:
        tile_quad = np.zeros(len(tiles_all), bool)

    # ---- class partition: tiles are contiguous runs of the sorted arrays,
    # so one pass copies each tile's run into its class's contiguous region
    # (dense | chunk | quad | COO), carrying the CSR ids (``order``) along
    t_first_all = np.cumsum(counts_all) - counts_all
    cls = np.ones(len(tiles_all), np.int8)  # 1 = chunk store
    cls[tile_dense] = 0
    cls[tile_quad] = 2
    cls[tile_coo] = 3
    dst = np.empty(len(tiles_all), np.int64)
    sizes = []
    dbase = 0
    for cclass in range(4):
        m = cls == cclass
        cc = counts_all[m]
        dst[m] = dbase + np.cumsum(cc) - cc
        sizes.append(int(cc.sum()))
        dbase += sizes[-1]
    ar_p, ac_p, av_p, ids_p = class_extract(
        t_first_all, counts_all, dst, a_rows, a_cols, a_vals, order
    )
    nd_nnz, nr_nnz, nq_nnz, nc_nnz = sizes
    b_r = nd_nnz
    b_q = b_r + nr_nnz
    b_c = b_q + nq_nnz
    s_rows, s_cols, s_vals = ar_p[b_r:b_q], ac_p[b_r:b_q], av_p[b_r:b_q]
    ids_res = ids_p[b_r:b_q]

    span = tail_span
    cwidth = TILE * span
    n_cpanels = -(-n // cwidth)
    if span > 1:
        # re-sort the chunk partition by the coarse (stripe, wide panel, row
        # panel) key
        s_ccp = s_cols // cwidth
        s_st = (s_rows // TILE) // stripe_tiles
        s_rp2 = (s_rows // TILE) % stripe_tiles
        o_s = np.lexsort((s_rp2, s_ccp, s_st))
        s_rows, s_cols, s_vals = s_rows[o_s], s_cols[o_s], s_vals[o_s]
        ids_res = ids_res[o_s]
        tkey = (
            (s_st[o_s].astype(np.int64) * n_cpanels + s_ccp[o_s]) * stripe_tiles
            + s_rp2[o_s]
        )
        tiles, t_first, counts = _uniq_sorted(tkey, index=True, counts=True)
    else:
        # the chunk partition is still tile-sorted, so the per-tile ranges
        # come straight from the classification
        rmask = cls == 1
        tiles = tiles_all[rmask]
        counts = counts_all[rmask]
        t_first = np.cumsum(counts) - counts
    nchunks_tile = -(-counts // TILE)
    gkey_tile = tiles // stripe_tiles  # (stripe * n_cpanels + wide col panel)

    if len(tiles):
        g_uniq, g_first = _uniq_sorted(gkey_tile, index=True)
        chunks_per_group = np.add.reduceat(nchunks_tile, g_first)
    else:
        g_uniq = np.zeros(0, np.int64)
        chunks_per_group = np.zeros(0, np.int64)
    padded_per_group = -(-chunks_per_group // group) * group

    # stripes without any chunk own one all-padding window at col panel 0
    # (the JAX package's kernel flushes every stripe; kept for equal arrays)
    missing = np.setdiff1d(np.arange(n_stripes, dtype=np.int64), g_uniq // n_cpanels)
    if len(missing):
        g_uniq = np.concatenate([g_uniq, missing * n_cpanels])
        padded_per_group = np.concatenate(
            [padded_per_group, np.full(len(missing), group, np.int64)]
        )
        o2 = np.argsort(g_uniq, kind="stable")
        g_uniq, padded_per_group = g_uniq[o2], padded_per_group[o2]

    group_base = np.concatenate([[0], np.cumsum(padded_per_group)])[:-1]
    total_chunks = int(padded_per_group.sum()) if len(padded_per_group) else group
    if not len(padded_per_group):  # fully empty matrix, single dummy window
        g_uniq = np.zeros(1, np.int64)
        padded_per_group = np.full(1, group, np.int64)
        group_base = np.zeros(1, np.int64)
    n_windows = total_chunks // group

    coords = np.zeros((total_chunks, TILE), np.int32)
    out_vals = np.zeros((total_chunks, TILE), np.float32)
    chunk_rp = np.zeros(total_chunks, np.int32)

    if len(tiles):
        # tile -> global chunk base: group base + exclusive cumsum within group
        cs = np.cumsum(nchunks_tile) - nchunks_tile
        _, gf, ginv = _uniq_sorted(gkey_tile, index=True, inverse=True)
        within = cs - cs[gf][ginv]
        grp_of_tile = np.searchsorted(g_uniq, gkey_tile)
        tile_chunk_base = group_base[grp_of_tile] + within

        res_slots = chunk_fill(
            t_first, counts, tile_chunk_base, s_rows, s_cols, s_vals,
            cwidth, coords.reshape(-1), out_vals.reshape(-1),
        )

        # row panel of every (non-padding) chunk
        tot = int(nchunks_tile.sum())
        expand = np.arange(tot) - np.repeat(cs, nchunks_tile)
        all_chunk_idx = np.repeat(tile_chunk_base, nchunks_tile) + expand
        chunk_rp[all_chunk_idx] = np.repeat(tiles % stripe_tiles, nchunks_tile).astype(
            np.int32
        )
    else:
        res_slots = np.zeros(0, np.int64)
    nchunk_slots = total_chunks * TILE

    # ---- dense store: blocks grouped DENSE_GROUP per window (same stripe
    # and col panel; groups zero-padded)
    d_tiles = tiles_all[tile_dense]
    if len(d_tiles):
        DG = DENSE_GROUP
        gkey_d = d_tiles // stripe_tiles  # (stripe * n_colpanels + cp)
        gd_uniq, gd_counts = _uniq_sorted(gkey_d, counts=True)
        padded_d = -(-gd_counts // DG) * DG
        miss_d = np.setdiff1d(
            np.arange(n_stripes, dtype=np.int64), gd_uniq // n_colpanels
        )
        if len(miss_d):
            gd_uniq = np.concatenate([gd_uniq, miss_d * n_colpanels])
            padded_d = np.concatenate([padded_d, np.full(len(miss_d), DG, np.int64)])
            od = np.argsort(gd_uniq, kind="stable")
            gd_uniq, padded_d = gd_uniq[od], padded_d[od]
        base_d = np.concatenate([[0], np.cumsum(padded_d)])[:-1]
        ndblk = int(padded_d.sum())

        # block position of each real dense tile: group base + rank within
        # group (tiles are key-sorted, so rank = index - group's first index)
        grp_of_tile_d = np.searchsorted(gd_uniq, gkey_d)
        first_of_grp = np.searchsorted(gkey_d, gd_uniq)
        within = np.arange(len(d_tiles)) - first_of_grp[grp_of_tile_d]
        blk_pos = base_d[grp_of_tile_d] + within

        dvals = np.zeros((ndblk, TILE, TILE), np.float32)
        b_of_nnz = np.repeat(blk_pos, counts_all[tile_dense])
        dlrow = (ar_p[:b_r] % TILE).astype(np.int64)
        dlcol = (ac_p[:b_r] % TILE).astype(np.int64)
        # (col, row) layout: out_panel += block' @ D_panel
        dense_scatter(dvals, b_of_nnz, dlcol, dlrow, av_p[:b_r])

        dblk_rp = np.zeros(ndblk, np.int32)
        dblk_rp[blk_pos] = d_tiles % stripe_tiles
        win_per_d = (padded_d // DG).astype(np.int64)
        dblk_stripe = np.append(
            np.repeat((gd_uniq // n_colpanels).astype(np.int32), win_per_d), -1
        ).astype(np.int32)
        dblk_panel = np.append(
            np.repeat((gd_uniq % n_colpanels).astype(np.int32), win_per_d), 0
        ).astype(np.int32)
        dense_local = b_of_nnz * TILE * TILE + dlcol * TILE + dlrow
    else:
        ndblk = 0
        dvals = dblk_stripe = dblk_panel = dblk_rp = None
        dense_local = None

    # ---- quad store: TILE // quad_seg small tiles per chunk, chunks grouped
    # QUAD_GROUP per window (same stripe and col panel; groups zero-padded)
    q_tiles = tiles_all[tile_quad]
    nper = TILE // quad_seg
    if len(q_tiles):
        QG = QUAD_GROUP
        gq_key = q_tiles // stripe_tiles  # (stripe * n_colpanels + cp)
        gq_uniq, gq_tilecounts = _uniq_sorted(gq_key, counts=True)
        chunks_per_gq = -(-gq_tilecounts // nper)
        padded_q = -(-chunks_per_gq // QG) * QG
        miss_q = np.setdiff1d(
            np.arange(n_stripes, dtype=np.int64), gq_uniq // n_colpanels
        )
        if len(miss_q):
            gq_uniq = np.concatenate([gq_uniq, miss_q * n_colpanels])
            padded_q = np.concatenate([padded_q, np.full(len(miss_q), QG, np.int64)])
            oq = np.argsort(gq_uniq, kind="stable")
            gq_uniq, padded_q = gq_uniq[oq], padded_q[oq]
        base_q = np.concatenate([[0], np.cumsum(padded_q)])[:-1]
        nq = int(padded_q.sum())

        grp_of_tile_q = np.searchsorted(gq_uniq, gq_key)
        first_of_grp_q = np.searchsorted(gq_key, gq_uniq)
        within_t = np.arange(len(q_tiles)) - first_of_grp_q[grp_of_tile_q]
        chunk_of_tile = base_q[grp_of_tile_q] + within_t // nper
        seg_of_tile = within_t % nper

        qlrows = np.zeros((nq, TILE), np.int32)
        qlcols = np.zeros((nq, TILE), np.int32)
        qvals = np.zeros((nq, TILE), np.float32)
        # sub-segments nothing is packed into keep row panel 0
        q_rp = np.zeros(nq * nper, np.int32)
        q_rp[chunk_of_tile * nper + seg_of_tile] = q_tiles % stripe_tiles
        win_per_q = (padded_q // QG).astype(np.int64)
        qwin_stripe = np.append(
            np.repeat((gq_uniq // n_colpanels).astype(np.int32), win_per_q), -1
        ).astype(np.int32)
        qwin_panel = np.append(
            np.repeat((gq_uniq % n_colpanels).astype(np.int32), win_per_q), 0
        ).astype(np.int32)

        # per-nnz placement from the quad partition (tile-sorted, tiles
        # contiguous: ranges come from the classification counts)
        counts_q = counts_all[tile_quad]
        tf_q = np.cumsum(counts_q) - counts_q
        tile_of_nnz_q = np.repeat(np.arange(len(q_tiles)), counts_q)
        pos_q = np.arange(nq_nnz, dtype=np.int64) - np.repeat(tf_q, counts_q)
        qslot = (
            chunk_of_tile[tile_of_nnz_q] * TILE
            + seg_of_tile[tile_of_nnz_q] * quad_seg
            + pos_q
        )
        qlrows.reshape(-1)[qslot] = (ar_p[b_q:b_c] % TILE).astype(np.int32)
        qlcols.reshape(-1)[qslot] = (ac_p[b_q:b_c] % TILE).astype(np.int32)
        qvals.reshape(-1)[qslot] = av_p[b_q:b_c]
    else:
        nq = 0
        qvals = qlrows = qlcols = q_rp = qwin_panel = qwin_stripe = None
        qslot = None

    # ---- COO band (tiles <= coo_tail_nnz), sorted by this side's row
    n_coo = nc_nnz
    if n_coo:
        c_rows = ar_p[b_c:]
        c_cols = ac_p[b_c:]
        oc = stable_argsort(c_rows.astype(np.int64) * n + c_cols)
        coo_rows = c_rows[oc].astype(np.int32)
        coo_cols = c_cols[oc].astype(np.int32)
        coo_vals = av_p[b_c:][oc].astype(np.float32)
        pos = np.empty(n_coo, np.int64)
        pos[oc] = np.arange(n_coo)
    else:
        coo_rows = coo_cols = coo_vals = None
        pos = None

    # perm + per-region refresh maps straight from the class partition; the
    # flat slot order is chunk slots, dense blocks, quad slots, band
    nnz_total = len(akey)
    idt = np.int32 if nnz_total < 2**31 - 1 else np.int64
    qbase = nchunk_slots + ndblk * TILE * TILE
    cobase = qbase + nq * TILE
    perm = np.empty(nnz_total, np.int64)
    inv = np.full(nchunk_slots, nnz_total, idt)
    if nr_nnz:
        perm[ids_res] = res_slots
        inv[res_slots] = ids_res.astype(idt, copy=False)
    if ndblk and nd_nnz:
        perm[ids_p[:b_r]] = nchunk_slots + dense_local
    if ndblk:
        dense_nnz = ids_p[:b_r].astype(idt, copy=False)
        sdt = np.int32 if ndblk * TILE * TILE < 2**31 - 1 else np.int64
        dense_slot = dense_local.astype(sdt)
    else:
        dense_nnz = dense_slot = None
    if nq:
        qinv = np.full(nq * TILE, nnz_total, idt)
        perm[ids_p[b_q:b_c]] = qbase + qslot
        qinv[qslot] = ids_p[b_q:b_c].astype(idt, copy=False)
    else:
        qinv = None
    if n_coo:
        perm[ids_p[b_c:]] = cobase + pos
        coo_ids = ids_p[b_c:][oc].astype(idt, copy=False)
    else:
        coo_ids = None

    win_per_group = (padded_per_group // group).astype(np.int64)
    win_stripe = np.repeat((g_uniq // n_cpanels).astype(np.int32), win_per_group)
    win_panel = np.repeat((g_uniq % n_cpanels).astype(np.int32), win_per_group)
    win_stripe = np.append(win_stripe, -1).astype(np.int32)
    win_panel = np.append(win_panel, 0).astype(np.int32)

    f = dict(
        coords=coords, vals=out_vals, chunk_rp=chunk_rp, win_panel=win_panel,
        win_stripe=win_stripe, perm=perm, n_stripes=n_stripes,
        n_colpanels=n_cpanels, n_windows=n_windows, group=group,
        panels_per_stripe=stripe_tiles, rows=p, cols=n, inv=inv, dvals=dvals,
        dblk_panel=dblk_panel, dblk_stripe=dblk_stripe, dblk_rp=dblk_rp,
        n_dblocks=ndblk, span=span, qvals=qvals, qlrows=qlrows, qlcols=qlcols,
        q_rp=q_rp, qwin_panel=qwin_panel, qwin_stripe=qwin_stripe,
        n_qchunks=nq, quad_seg=quad_seg, qinv=qinv, dense_nnz=dense_nnz,
        dense_slot=dense_slot, coo_rows=coo_rows, coo_cols=coo_cols,
        coo_vals=coo_vals, coo_nnz=coo_ids, n_coo=n_coo,
    )
    f.update(row_panel_index(f))
    return f


def to_tensor(a, device):
    """A numpy array (or None) as a tensor on ``device``."""
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch refuses to alias read-only memory
        a = a.copy()
    return torch.from_numpy(a).to(device)


def side_from_numpy(f, device) -> TiledSideC:
    """``TiledSideC`` on ``device`` from a dict of numpy arrays and ints."""
    return TiledSideC(**{
        name: to_tensor(v, device) if isinstance(v, np.ndarray) else v
        for name, v in f.items()
    })


def build_tiled(
    rows, cols, vals, shape, *, stripe_tiles: int = 32, layout: str = "compact",
    group: int = 16, order: str = "degree", dense_tile_nnz: int | None = None,
    tail_span: int = 1, quad_tail_nnz: int | None = None, quad_seg: int = 32,
    coo_tail_nnz: int | None = None, device=config.DEFAULT_DEVICE,
) -> TiledCSR:
    """Build both tiling orientations from COO data (deduped) on ``device``.

    ``stripe_tiles`` row panels make one stripe and ``group`` chunks one
    window: both only shape the stored arrays (they are what the JAX
    package's ``build_tiled`` takes, and the stores compare equal).

    ``order="degree"`` renumbers rows and columns by descending degree before
    binning, so power-law data packs its head into dense tiles instead of
    scattering tail nonzeros one per 128-slot chunk; the products gather and
    scatter factor rows through the stored permutations.
    ``order="natural"`` keeps original coordinates.

    ``tail_span`` widens the chunk tiles to that many col panels,
    ``quad_tail_nnz`` packs tiles with at most that many nonzeros
    ``128 // quad_seg`` to a chunk, ``coo_tail_nnz`` sends tiles with at most
    that many nonzeros to the COO band (see ``_build_side_compact``).
    """
    if layout != "compact":
        raise ValueError(f"layout={layout!r} is not supported: use 'compact'")
    dev = config.resolve_device(device)
    p, n = shape
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    # == lexsort((cols, rows))
    so = stable_argsort(rows.astype(np.int64) * n + cols)
    rows, cols, vals = gather3(so, rows, cols, vals)

    row_perm = row_rank = col_perm = col_rank = None
    rows_t, cols_t = rows, cols
    if order == "degree":
        rdeg = np.bincount(rows, minlength=p)
        cdeg = np.bincount(cols, minlength=n)
        row_perm = np.argsort(-rdeg, kind="stable").astype(np.int32)
        col_perm = np.argsort(-cdeg, kind="stable").astype(np.int32)
        row_rank = np.empty(p, np.int32)
        row_rank[row_perm] = np.arange(p, dtype=np.int32)
        col_rank = np.empty(n, np.int32)
        col_rank[col_perm] = np.arange(n, dtype=np.int32)
        rows_t = row_rank[rows]
        cols_t = col_rank[cols]

    fwd = _build_side_compact(
        rows_t, cols_t, vals, p, n, stripe_tiles, group, dense_tile_nnz,
        tail_span, quad_tail_nnz, quad_seg, coo_tail_nnz,
    )
    bwd = _build_side_compact(
        cols_t, rows_t, vals, n, p, stripe_tiles, group, dense_tile_nnz,
        tail_span, quad_tail_nnz, quad_seg, coo_tail_nnz,
    )
    stats = np.asarray(
        [
            vals.sum(dtype=np.float64),
            (vals.astype(np.float64) ** 2).sum(),
            vals.min() if len(vals) else 0.0,
        ],
        np.float32,
    )
    dv = lambda a: to_tensor(a, dev)
    return TiledCSR(
        side_from_numpy(fwd, dev),
        side_from_numpy(bwd, dev),
        dv(rows),
        dv(cols),
        dv(vals),
        dv(row_perm),
        dv(row_rank),
        dv(col_perm),
        dv(col_rank),
        (p, n),
        (stripe_tiles, layout, group, dense_tile_nnz, quad_tail_nnz, quad_seg,
         coo_tail_nnz),
        stats=dv(stats),
    )
