"""Sharded tiled store: the multi-device path for a sparse X.

2-D decomposition over a mesh (``parallel/mesh.py``): block (i, j) of the
grid holds the nonzeros whose row falls in row block i and whose column falls
in column block j, as a ``TiledCSR`` of its own on ``mesh.devices[i, j]``.
Every block is ``local_p x local_n`` (p / R and n / C rounded up to whole
tiles) and in natural order inside; with ``order="degree"`` its coordinates
are already renumbered by descending degree over the whole block row (and
block column), so that the partials of one mesh row speak one row order.
On a mesh that spans several processes each process builds and holds only
the blocks of its own cells (None stands for the others).

* ``X @ D``: block column j of D (zero rows past n) is gathered through
  ``col_perm[j]`` and moved to the blocks' devices; every block runs the
  single-store product (``ops/cuda/sparse.py`` ``tiled_mm``: kernels 1-3 and
  the band on the card); every block's partial reaches every process
  (``parallel/exchange.py`` ``gather_cells``) and row i's partials are added
  on the lead device in j order, a fixed order, so the products repeat bit
  for bit and every process holds the same sum; it is gathered back through
  ``row_rank[i]``.
* ``X' @ D`` is the same over ``transpose()``, which is free.
* The *nnz vector* is this process's blocks' CSR-order values, block after
  block (block row major); ``sharded_sddmm``, ``sharded_nnz_values``,
  ``sharded_row_ids``, ``sharded_col_ids`` and ``sharded_scale_values`` all
  speak it, as the single store's functions speak its CSR order.  A sum
  over it (``sharded_nnz_sum``, the ``stats``) adds the blocks' float64
  sums in block order across the processes, so one process and several give
  the same bits.

W and H stay whole on the lead device (``mesh.lead``) of every process: what
the grid spreads over the cards is X, the memory that grows with the data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.loader import gather3, stable_argsort
from ..parallel.exchange import agree_min, agree_sum, gather_cells
from ..parallel.mesh import Mesh
from .cuda.sparse import tiled_mm
from .sparse_format import TILE, TiledCSR, _build_side_compact, side_from_numpy, to_tensor

__all__ = [
    "ShardedTiled",
    "shard_tiled",
    "sharded_mm",
    "sharded_mtm",
    "sharded_sddmm",
    "sharded_scale_values",
    "sharded_nnz_values",
    "sharded_nnz_sum",
    "sharded_row_ids",
    "sharded_col_ids",
    "sharded_colsums",
    "sharded_rowsums",
    "sharded_load_stats",
]


@dataclasses.dataclass(frozen=True)
class ShardedTiled:
    """An R x C grid of ``TiledCSR`` blocks, block (i, j) on its device.

    ``blocks[i][j]`` is None where another process owns the cell;
    ``ranks[i, j]`` is the owner (the mesh's ``ranks``, transposed with the
    grid).  ``stats`` = (sum, sum of squares, min) of all the values, on the
    lead device.  ``*_perm[i][renumbered] = original local id`` and
    ``*_rank[i][original] = renumbered`` per block row (``row_*``, (R,
    local_p)) and block column (``col_*``, (C, local_n)), int64 on the lead
    device; all None in natural order.  ``block_nnz[i][j]`` is the number of
    stored entries of block (i, j), the whole table on every process;
    ``build_opts`` are the store options every block was built with (as
    ``TiledCSR.build_opts``)."""

    blocks: tuple  # R tuples of C TiledCSR (None where not owned)
    stats: torch.Tensor
    shape: tuple[int, int]
    mesh: Mesh
    block_nnz: tuple
    ranks: np.ndarray
    build_opts: tuple | None = None
    row_perm: torch.Tensor | None = None
    row_rank: torch.Tensor | None = None
    col_perm: torch.Tensor | None = None
    col_rank: torch.Tensor | None = None

    def owned(self):
        """(i, j, block) of this process's blocks, block row major."""
        return [(i, j, b) for i, row in enumerate(self.blocks)
                for j, b in enumerate(row) if b is not None]

    @property
    def dtype(self):
        return self.owned()[0][2].dtype

    @property
    def nnz(self):
        return sum(sum(row) for row in self.block_nnz)

    @property
    def local_shape(self) -> tuple[int, int]:
        return self.owned()[0][2].shape

    def transpose(self):
        """X' without a copy: the grid and every block transposed, the row
        and column permutations swapped."""
        return dataclasses.replace(
            self,
            blocks=tuple(zip(*(tuple(None if b is None else b.transpose() for b in row)
                               for row in self.blocks))),
            block_nnz=tuple(zip(*self.block_nnz)),
            ranks=self.ranks.T,
            shape=(self.shape[1], self.shape[0]),
            row_perm=self.col_perm, row_rank=self.col_rank,
            col_perm=self.row_perm, col_rank=self.row_rank,
        )


def _block_perms(deg, count, size):
    """Per block of ``size`` ids: the ids by descending degree (stable) and
    its inverse, each (count, size)."""
    perm = np.stack([np.argsort(-deg[b * size:(b + 1) * size], kind="stable")
                     for b in range(count)]).astype(np.int32)
    rank = np.empty_like(perm)
    for b in range(count):
        rank[b, perm[b]] = np.arange(size, dtype=np.int32)
    return perm, rank


def _stats_in_block_order(sums, sqs, mins):
    """(sum, sum of squares, min) of all the values from the blocks' own,
    each an (R * C,) float64 array in block order: the sums added one block
    after the other, an empty X's min 0."""
    total = sq = 0.0
    for s, q in zip(sums.tolist(), sqs.tolist()):
        total += s
        sq += q
    low = float(mins.min())
    return np.asarray([total, sq, low if np.isfinite(low) else 0.0], np.float32)


def shard_tiled(
    rows, cols, vals, shape, mesh: Mesh, *, stripe_tiles: int = 32,
    local: bool = False, layout: str = "compact", group: int = 16,
    dense_tile_nnz: int | None = None, quad_tail_nnz: int | None = None,
    quad_seg: int = 32, order: str = "degree",
    coo_tail_nnz: int | None = None,
) -> ShardedTiled:
    """Build the 2-D sharded store from COO data (deduped) for ``mesh``,
    each of this process's blocks on its device.

    The store options are ``build_tiled``'s, applied to every block:
    ``dense_tile_nnz``, ``quad_tail_nnz`` and ``coo_tail_nnz`` enable the
    hybrid dense-tile, quad-tail and band classes.  ``order="degree"``
    (default) renumbers each block row's local rows (and block column's local
    columns) by descending degree over the whole block row (column), so that
    power-law heads pack into dense tiles as the single store's degree sort
    packs them and every block of a mesh row agrees on the row order;
    ``order="natural"`` keeps the original coordinates.  Each block's entries
    keep X's CSR order (by original row, then column).

    ``local=False`` (default): every process passes the whole COO and keeps
    its share.  ``local=True``: each process passes only the entries of its
    own blocks (e.g. its shard of an input file) and it raises on every
    process when an entry falls in another process's block; with one process
    it builds the ``local=False`` store.  Across processes the degrees are
    summed, and the block counts and the stats gathered, as the JAX package
    agrees them; blocks keep their own sizes, so there is no padding to
    agree on."""
    if layout != "compact":
        raise ValueError(f"layout={layout!r} is not supported: use 'compact'")
    if order not in ("degree", "natural"):
        raise ValueError("order must be 'degree' or 'natural'")
    p, n = shape
    R, C = mesh.devices.shape
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float32)
    # each block a whole number of tiles: ceil(p / R) rounded up to TILE
    local_p = -(-(-(-p // R)) // TILE) * TILE
    local_n = -(-(-(-n // C)) // TILE) * TILE
    own = mesh.ranks == mesh.rank
    mine = own[rows // local_p, cols // local_n]
    if local:
        # agreed first, so that every process raises and none waits
        if not agree_min(np.asarray([int(mine.all())]), mesh)[0]:
            raise ValueError(
                "local=True: some entries fall in blocks owned by other "
                "processes; pass each process only its own entries")
    perms = {}
    if order == "degree":
        deg = np.concatenate([np.bincount(rows, minlength=local_p * R),
                              np.bincount(cols, minlength=local_n * C)])
        if local:
            deg = agree_sum(deg, mesh)
        row_perm, row_rank = _block_perms(deg[:local_p * R], R, local_p)
        col_perm, col_rank = _block_perms(deg[local_p * R:], C, local_n)
        perms = {name: torch.from_numpy(a.astype(np.int64)).to(mesh.lead)
                 for name, a in (("row_perm", row_perm), ("row_rank", row_rank),
                                 ("col_perm", col_perm), ("col_rank", col_rank))}
    if not mine.all():
        rows, cols, vals = rows[mine], cols[mine], vals[mine]
    # CSR order, as build_tiled takes it (== lexsort((cols, rows)))
    rows, cols, vals = gather3(stable_argsort(rows.astype(np.int64) * n + cols),
                               rows, cols, vals)

    # the entries block by block (block row major), CSR order kept in each
    blk = (rows // local_p).astype(np.int64) * C + cols // local_n
    by_block = stable_argsort(blk)
    start = np.concatenate([[0], np.cumsum(np.bincount(blk, minlength=R * C))])
    opts = (stripe_tiles, layout, group, dense_tile_nnz, quad_tail_nnz, quad_seg,
            coo_tail_nnz)
    # per block: entries, sum, sum of squares (float64) and min
    counts = np.zeros(R * C, np.int64)
    sums, sqs = np.zeros(R * C), np.zeros(R * C)
    mins = np.full(R * C, np.inf)
    grid = []
    for i in range(R):
        row = []
        for j in range(C):
            if not own[i, j]:
                row.append(None)
                continue
            sel = by_block[start[i * C + j]:start[i * C + j + 1]]
            lr = rows[sel] - np.int32(i * local_p)
            lc = cols[sel] - np.int32(j * local_n)
            if order == "degree":
                lr, lc = row_rank[i][lr], col_rank[j][lc]
            v = vals[sel]
            b = i * C + j
            counts[b] = len(v)
            if len(v):
                sums[b] = v.sum(dtype=np.float64)
                sqs[b] = (v.astype(np.float64) ** 2).sum()
                mins[b] = v.min()
            dev = mesh.devices[i, j]
            side = lambda r, c, rr, cc: side_from_numpy(_build_side_compact(  # noqa: E731
                r, c, v, rr, cc, stripe_tiles, group, dense_tile_nnz, 1,
                quad_tail_nnz, quad_seg, coo_tail_nnz), dev)
            row.append(TiledCSR(
                side(lr, lc, local_p, local_n), side(lc, lr, local_n, local_p),
                to_tensor(lr, dev), to_tensor(lc, dev), to_tensor(v, dev),
                shape=(local_p, local_n), build_opts=opts))
        grid.append(tuple(row))
    # each block is owned by one process: the others add zeros
    sums, sqs, counts = np.split(agree_sum(np.concatenate([sums, sqs, counts]), mesh), 3)
    stats = _stats_in_block_order(sums, sqs, agree_min(mins, mesh))
    block_nnz = tuple(tuple(int(c) for c in counts[i * C:(i + 1) * C]) for i in range(R))
    return ShardedTiled(tuple(grid), to_tensor(stats, mesh.lead), (p, n), mesh,
                        block_nnz, mesh.ranks, opts, **perms)


def _cut_rows(A, count, size, perm):
    """A's rows cut into ``count`` pieces of ``size`` rows (zero rows past
    its end); piece b gathered through ``perm[b]`` when there is a perm."""
    Ap = A.new_zeros((count * size, A.shape[1]))
    Ap[:A.shape[0]] = A
    return [Ap[b * size:(b + 1) * size] if perm is None
            else Ap[b * size:(b + 1) * size].index_select(0, perm[b])
            for b in range(count)]


class _Moved:
    """Each piece moved once to each device that asks for it."""

    def __init__(self, pieces):
        self.pieces = pieces
        self.on = {}

    def __call__(self, b, dev):
        if (b, dev) not in self.on:
            self.on[b, dev] = self.pieces[b].to(dev)
        return self.on[b, dev]


def sharded_mm(X: ShardedTiled, D):
    """``X @ D`` -> (p, k) float32 on the lead device.  Every block's product
    is enqueued before the first partial is moved, so that blocks on
    distinct cards run at once; row i's partials are added in j order."""
    lead = X.mesh.lead
    local_p, local_n = X.local_shape
    cols = _Moved(_cut_rows(D.to(device=lead, dtype=torch.float32), len(X.blocks[0]),
                            local_n, X.col_perm))
    parts = [[None if b is None else tiled_mm(b, cols(j, b.device))
              for j, b in enumerate(row)] for row in X.blocks]
    shapes = [[(local_p, D.shape[1])] * len(row) for row in X.blocks]
    out = []
    for i, row in enumerate(gather_cells(parts, X.ranks, shapes, lead)):
        acc = row[0].to(lead)
        for part in row[1:]:
            acc = acc + part.to(lead)
        out.append(acc if X.row_rank is None else acc.index_select(0, X.row_rank[i]))
    return torch.cat(out)[:X.shape[0]]


def sharded_mtm(X: ShardedTiled, D):
    """``X' @ D`` -> (n, k) float32 on the lead device."""
    return sharded_mm(X.transpose(), D)


def sharded_sddmm(X: ShardedTiled, W, H):
    """Values of ``(W @ H)`` at this process's nonzeros, the nnz vector's
    order, in W's dtype on the lead device.  Each block samples its own W
    rows and H columns (gathered into its renumbered order) through the
    single store's sampled product (kernels 4 and 5 and the band's sampling
    on the card)."""
    from . import matops

    lead = X.mesh.lead
    local_p, local_n = X.local_shape
    w = _Moved(_cut_rows(W.to(lead), len(X.blocks), local_p, X.row_perm))
    ht = _Moved(_cut_rows(H.to(lead).T, len(X.blocks[0]), local_n, X.col_perm))
    parts = [matops.sddmm(w(i, b.device), ht(j, b.device).T, b) for i, j, b in X.owned()]
    return torch.cat([part.to(lead) for part in parts])


def sharded_nnz_values(X: ShardedTiled):
    """The nnz vector: this process's blocks' CSR-order values, block row
    major."""
    return torch.cat([b.values.to(X.mesh.lead) for _, _, b in X.owned()])


def _block_sums(X: ShardedTiled, values, reducers):
    """Each block's piece of the nnz-vector-ordered ``values`` through
    ``reducers`` (each a 0-d float64 of the piece), gathered: R lists of C
    ``(len(reducers),)`` float64 tensors, every block's on every process."""
    R, C = len(X.blocks), len(X.blocks[0])
    lead = X.mesh.lead
    pieces = iter(torch.split(values, [X.block_nnz[i][j] for i, j, _ in X.owned()]))
    parts = [[None] * C for _ in range(R)]
    for i, j, _ in X.owned():
        v = next(pieces)
        parts[i][j] = torch.stack([f(v) for f in reducers]).to(lead)
    return gather_cells(parts, X.ranks, [[(len(reducers),)] * C] * R, lead)


def _sum64(v):
    return v.sum(dtype=torch.float64)


def _sq64(v):
    v = v.to(torch.float64)
    return (v * v).sum()


def _min64(v):
    return v.min().to(torch.float64) if v.numel() else v.new_full((), np.inf, dtype=torch.float64)


def sharded_nnz_sum(X: ShardedTiled, values):
    """``values.sum()`` over every process's nnz vector, in a fixed order:
    each block's float64 sum, added in block order, rounded once to the
    values' dtype (a 0-d tensor on the lead device)."""
    acc = None
    for row in _block_sums(X, values, (_sum64,)):
        for s in row:
            acc = s[0] if acc is None else acc + s[0]
    return acc.to(values.dtype)


def _ids(X, which):
    """Original global row (``which="row"``) or column id of every entry,
    in the nnz vector's order."""
    lead = X.mesh.lead
    perm = X.row_perm if which == "row" else X.col_perm
    size = X.local_shape[0 if which == "row" else 1]
    out = []
    for i, j, b in X.owned():
        g = i if which == "row" else j
        local = (b.row_idx if which == "row" else b.col_idx).to(lead).long()
        if perm is not None:
            local = perm[g][local]
        out.append(local + g * size)
    return torch.cat(out)


def sharded_row_ids(X: ShardedTiled):
    """Original row of every entry of the nnz vector (int64, lead device)."""
    return _ids(X, "row")


def sharded_col_ids(X: ShardedTiled):
    """Original column of every entry of the nnz vector (int64, lead device)."""
    return _ids(X, "col")


def sharded_scale_values(X: ShardedTiled, new_values) -> ShardedTiled:
    """Same pattern, new values (the nnz vector's order): each block's share
    refreshes both of its orientations; ``stats`` are recomputed from the
    blocks' own, added in block order."""
    pieces = iter(torch.split(new_values, [X.block_nnz[i][j] for i, j, _ in X.owned()]))
    blocks = tuple(tuple(None if b is None else b.with_values(next(pieces).to(b.device))
                         for b in row) for row in X.blocks)
    grid = [s for row in _block_sums(X, new_values.to(torch.float32),
                                     (_sum64, _sq64, _min64)) for s in row]
    total, sq, low = grid[0][0], grid[0][1], grid[0][2]
    for s in grid[1:]:
        total, sq, low = total + s[0], sq + s[1], torch.minimum(low, s[2])
    low = torch.where(torch.isfinite(low), low, torch.zeros_like(low))
    return dataclasses.replace(
        X, blocks=blocks, stats=torch.stack([total, sq, low]).to(torch.float32))


def sharded_colsums(X: ShardedTiled):
    """(n,) column sums: the product of X' with a ones column."""
    return sharded_mtm(X, torch.ones((X.shape[0], 1), device=X.mesh.lead))[:, 0]


def sharded_rowsums(X: ShardedTiled):
    """(p,) row sums: the product of X with a ones column."""
    return sharded_mm(X, torch.ones((X.shape[1], 1), device=X.mesh.lead))[:, 0]


def sharded_load_stats(X: ShardedTiled) -> dict:
    """Per-block load report: each store class's nonzero values
    (``chunk_nnz``, ``dense_nnz``, ``quad_nnz``, ``coo_nnz``; a class
    appears when some block holds it), their sum ``total_nnz``, the exact
    stored entries ``pattern_nnz`` (which counts stored zeros too), the
    slots each block's kernels walk (``slots``) and ``total_nnz``'s
    ``imbalance_max_over_mean``: on a mesh of cards the slowest block sets
    the pace.  Every count is an (R, C) int64 array, counted block by block,
    the whole table on every process."""
    shape = X.ranks.shape
    # name: (the class's values, how many it stores)
    classes = {"chunk_nnz": ("vals", lambda s: 1),
               "dense_nnz": ("dvals", lambda s: s.n_dblocks),
               "quad_nnz": ("qvals", lambda s: s.n_qchunks),
               "coo_nnz": ("coo_vals", lambda s: s.n_coo)}
    # per class: (its nonzero values, how many it stores); then the slots
    table = np.zeros((2 * len(classes) + 1, *shape), np.int64)
    for i, j, b in X.owned():
        s = b.fwd
        for c, (field, stored) in enumerate(classes.values()):
            if stored(s):
                table[2 * c, i, j] = int((getattr(s, field) != 0).sum())
                table[2 * c + 1, i, j] = stored(s)
        table[-1, i, j] = (s.vals.numel() + s.n_dblocks * TILE * TILE
                           + s.n_qchunks * TILE + s.n_coo)
    table = agree_sum(table, X.mesh)
    out = {name: table[2 * c] for c, name in enumerate(classes)
           if table[2 * c + 1].any()}
    out["slots"] = table[-1]
    total = sum(v for k, v in out.items() if k.endswith("_nnz"))
    out["total_nnz"] = total
    out["pattern_nnz"] = np.asarray(X.block_nnz, np.int64)
    mean = float(total.mean())
    out["imbalance_max_over_mean"] = float(total.max()) / mean if mean else 1.0
    return out
