"""Sharded dense X: the multi-device path for a dense X.

The JAX package places a dense X with ``jax.device_put(X, P(ROWS, COLS))``
and lets GSPMD cut the work; it has no module of its own to mirror here.
A ``ShardedDense`` is that placement written out: an R x C grid of
contiguous row-major blocks, block (i, j) on ``mesh.devices[i, j]``, the
rows cut into runs of ``ceil(p / R)`` and the columns into runs of
``ceil(n / C)``, as ``P(ROWS, COLS)`` cuts them (the last run may be
shorter), with no padding stored.  On a mesh that spans several processes
each process keeps only the blocks of its own cells.

* ``X @ D``: row block i is ``sum_j X_ij @ D_j``, each block's product on
  its device, every block's partial brought to every process's lead device
  (``parallel/exchange.py`` ``gather_cells``) and added there in j order;
  ``D @ X`` likewise over i for column block j.  A fixed order, so the
  products repeat bit for bit and every process holds the same sum; a
  (1, 1) mesh is the whole X's one product.
* The divergence sweep's ``W' Q`` and ``Q H'`` (kernels 8 and 9 on the card)
  run a block at a time with the W row block and H column block the block
  needs, ``W' Q`` summed over i and ``Q H'`` over j; the objectives (kernel
  6) add the blocks' sums in float64 in block order.  On the CPU each block
  takes the plain version.
* ``transpose()`` is free: the grid and every block transposed as views.

W and H stay whole on the lead device (``mesh.lead``) of every process, as
on the sparse mesh (``ops/sparse_shard.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.exchange import agree_min, gather_cells
from ..parallel.mesh import Mesh

__all__ = [
    "ShardedDense",
    "shard_dense",
    "dense_mm",
    "dense_mtm",
    "dense_wtq",
    "dense_qht",
    "dense_objective",
    "dense_reduce",
    "dense_all_nonneg",
]


@dataclasses.dataclass(frozen=True)
class ShardedDense:
    """An R x C grid of dense blocks, block (i, j) on its device.

    ``row_cuts`` (R + 1 entries) and ``col_cuts`` (C + 1) are where the
    blocks' rows and columns start and end in X; block (i, j) holds
    ``X[row_cuts[i]:row_cuts[i + 1], col_cuts[j]:col_cuts[j + 1]]``, or is
    None where another process owns the cell (``ranks[i, j]``, the mesh's
    ``ranks`` transposed with the grid)."""

    blocks: tuple  # R tuples of C tensors (None where not owned)
    shape: tuple[int, int]
    mesh: Mesh
    row_cuts: tuple
    col_cuts: tuple
    ranks: np.ndarray

    def owned(self):
        """(i, j, block) of this process's blocks, block row major."""
        return [(i, j, b) for i, row in enumerate(self.blocks)
                for j, b in enumerate(row) if b is not None]

    @property
    def dtype(self):
        return self.owned()[0][2].dtype

    def transpose(self):
        """X' without a copy: the grid transposed and every block a
        transposed view (the kernels, which read a block row-major, run on
        X as it was placed)."""
        return dataclasses.replace(
            self,
            blocks=tuple(zip(*(tuple(None if b is None else b.T for b in row)
                               for row in self.blocks))),
            shape=(self.shape[1], self.shape[0]),
            row_cuts=self.col_cuts, col_cuts=self.row_cuts, ranks=self.ranks.T,
        )


def _cuts(size: int, parts: int) -> tuple:
    run = -(-size // parts)
    return tuple(min(b * run, size) for b in range(parts + 1))


def shard_dense(X, mesh: Mesh) -> ShardedDense:
    """Cut the dense ``X`` into ``mesh``'s grid, each of this process's
    blocks copied row-major to its device (a block that already is one, as
    on a (1, 1) mesh on X's device, is X's own memory)."""
    X = torch.as_tensor(X)
    if X.dim() != 2:
        raise ValueError(f"shard_dense takes a matrix, got shape {tuple(X.shape)}")
    R, C = mesh.devices.shape
    rc, cc = _cuts(X.shape[0], R), _cuts(X.shape[1], C)
    blocks = tuple(
        tuple(X[rc[i]:rc[i + 1], cc[j]:cc[j + 1]].to(mesh.devices[i, j]).contiguous()
              if mesh.ranks[i, j] == mesh.rank else None for j in range(C))
        for i in range(R))
    return ShardedDense(blocks, tuple(X.shape), mesh, rc, cc, mesh.ranks)


class _Pieces:
    """A factor cut at ``cuts`` along ``dim``, each piece moved once to each
    device that asks for it."""

    def __init__(self, A, cuts, dim):
        self.A, self.cuts, self.dim = A, cuts, dim
        self.on = {}

    def __call__(self, b, dev):
        if (b, dev) not in self.on:
            piece = self.A.narrow(self.dim, self.cuts[b], self.cuts[b + 1] - self.cuts[b])
            self.on[b, dev] = piece.to(dev)
        return self.on[b, dev]


def _sum_in_order(parts, lead):
    """The partials moved to ``lead`` and added one after the other."""
    acc = parts[0].to(lead)
    for part in parts[1:]:
        acc = acc + part.to(lead)
    return acc


def _gathered(X: ShardedDense, parts, shape_of):
    """``parts`` (R lists of C, None where not owned) with every block's
    partial on every process; ``shape_of(i, j)`` is block (i, j)'s."""
    shapes = [[shape_of(i, j) for j in range(len(row))] for i, row in enumerate(parts)]
    return gather_cells(parts, X.ranks, shapes, X.mesh.lead)


def _rows(X, i):
    return X.row_cuts[i + 1] - X.row_cuts[i]


def _cols(X, j):
    return X.col_cuts[j + 1] - X.col_cuts[j]


def dense_mm(X: ShardedDense, D):
    """``X @ D`` -> (p, k) on the lead device.  Every block's product is
    enqueued before a partial is moved; row i's partials are added in j
    order."""
    lead = X.mesh.lead
    d = _Pieces(D.to(lead), X.col_cuts, 0)
    parts = [[None if b is None else b @ d(j, b.device) for j, b in enumerate(row)]
             for row in X.blocks]
    parts = _gathered(X, parts, lambda i, j: (_rows(X, i), D.shape[1]))
    return torch.cat([_sum_in_order(row, lead) for row in parts])


def dense_mtm(D, X: ShardedDense):
    """``D @ X`` -> (k, n) on the lead device; column j's partials are
    added in i order."""
    lead = X.mesh.lead
    d = _Pieces(D.to(lead), X.row_cuts, 1)
    parts = [[None if b is None else d(i, b.device) @ b for j, b in enumerate(row)]
             for i, row in enumerate(X.blocks)]
    parts = _gathered(X, parts, lambda i, j: (D.shape[0], _cols(X, j)))
    return torch.cat([_sum_in_order(col, lead) for col in zip(*parts)], dim=1)


def _factor_pieces(X, W, H):
    lead = X.mesh.lead
    return _Pieces(W.to(lead), X.row_cuts, 0), _Pieces(H.to(lead), X.col_cuts, 1)


def dense_wtq(X: ShardedDense, W, H, delta):
    """``W' (X / (W H + delta))`` -> (k, n) on the lead device: each block's
    ``wtq`` (kernel 8 on the card) with its W rows and H columns, column
    block j's partials added in i order."""
    from .cuda.mu import wtq

    lead = X.mesh.lead
    w, h = _factor_pieces(X, W, H)
    parts = [[None if b is None
              else wtq(b, w(i, b.device), h(j, b.device), delta) if b.numel()
              else b.new_zeros((W.shape[1], b.shape[1])) for j, b in enumerate(row)]
             for i, row in enumerate(X.blocks)]
    parts = _gathered(X, parts, lambda i, j: (W.shape[1], _cols(X, j)))
    return torch.cat([_sum_in_order(col, lead) for col in zip(*parts)], dim=1)


def dense_qht(X: ShardedDense, W, H, delta):
    """``(X / (W H + delta)) H'`` -> (p, k) on the lead device: each block's
    ``qht`` (kernel 9 on the card), row block i's partials added in j
    order."""
    from .cuda.mu import qht

    lead = X.mesh.lead
    w, h = _factor_pieces(X, W, H)
    parts = [[None if b is None
              else qht(b, w(i, b.device), h(j, b.device), delta) if b.numel()
              else b.new_zeros((b.shape[0], W.shape[1])) for j, b in enumerate(row)]
             for i, row in enumerate(X.blocks)]
    parts = _gathered(X, parts, lambda i, j: (_rows(X, i), W.shape[1]))
    return torch.cat([_sum_in_order(row, lead) for row in parts])


def _in_block_order(X, values):
    """A 0-d tensor on the lead device: ``values(i, j, block)`` (a 0-d) of
    every block, gathered from every process, added in float64 in block
    order (block row major) and rounded once to X's type; an empty block
    adds nothing."""
    lead = X.mesh.lead
    parts = [[None if b is None
              else values(i, j, b).to(device=lead, dtype=torch.float64) if b.numel()
              else torch.zeros((), dtype=torch.float64, device=lead)
              for j, b in enumerate(row)] for i, row in enumerate(X.blocks)]
    acc = torch.zeros((), dtype=torch.float64, device=lead)
    for row in _gathered(X, parts, lambda i, j: ()):
        for v in row:
            acc = acc + v.to(lead)
    return acc.to(X.dtype)


def dense_objective(X: ShardedDense, W, H, objective):
    """``objective`` (``mse_objective`` or ``kl_objective`` of
    ``ops/objectives.py``: kernel 6 on a large float32 block on the card)
    summed over the blocks, each with its W rows and H columns."""
    w, h = _factor_pieces(X, W, H)
    return _in_block_order(X, lambda i, j, b: objective(b, w(i, b.device), h(j, b.device)))


def dense_reduce(X: ShardedDense, fn):
    """``fn`` of each block (a 0-d sum) added as ``_in_block_order`` adds."""
    return _in_block_order(X, lambda i, j, b: fn(b))


def dense_all_nonneg(X: ShardedDense) -> bool:
    """Whether every block, on every process, is non-negative."""
    mine = all(bool((b >= 0).all()) for _, _, b in X.owned())
    return bool(agree_min(np.asarray([int(mine)]), X.mesh)[0])
