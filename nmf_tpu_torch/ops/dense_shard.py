"""Sharded dense X: the multi-device path for a dense X.

The JAX package places a dense X with ``jax.device_put(X, P(ROWS, COLS))``
and lets GSPMD cut the work; it has no module of its own to mirror here.
A ``ShardedDense`` is that placement written out: an R x C grid of
contiguous row-major blocks, block (i, j) on ``mesh.devices[i, j]``, the
rows cut into runs of ``ceil(p / R)`` and the columns into runs of
``ceil(n / C)``, as ``P(ROWS, COLS)`` cuts them (the last run may be
shorter), with no padding stored.

* ``X @ D``: row block i is ``sum_j X_ij @ D_j``, each block's product on
  its device, the partials moved to the lead device and added in j order;
  ``D @ X`` likewise over i for column block j.  A fixed order, so the
  products repeat bit for bit; a (1, 1) mesh is the whole X's one product.
* The divergence sweep's ``W' Q`` and ``Q H'`` (kernels 8 and 9 on the card)
  run a block at a time with the W row block and H column block the block
  needs, ``W' Q`` summed over i and ``Q H'`` over j; the objectives (kernel
  6) add the blocks' sums in float64 in block order.  On the CPU each block
  takes the plain version.
* ``transpose()`` is free: the grid and every block transposed as views.

W and H stay whole on the lead device (``mesh.lead``), as on the sparse
mesh (``ops/sparse_shard.py``).
"""

from __future__ import annotations

import dataclasses

import torch

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
]


@dataclasses.dataclass(frozen=True)
class ShardedDense:
    """An R x C grid of dense blocks, block (i, j) on its device.

    ``row_cuts`` (R + 1 entries) and ``col_cuts`` (C + 1) are where the
    blocks' rows and columns start and end in X; block (i, j) holds
    ``X[row_cuts[i]:row_cuts[i + 1], col_cuts[j]:col_cuts[j + 1]]``."""

    blocks: tuple  # R tuples of C tensors
    shape: tuple[int, int]
    mesh: Mesh
    row_cuts: tuple
    col_cuts: tuple

    @property
    def dtype(self):
        return self.blocks[0][0].dtype

    def transpose(self):
        """X' without a copy: the grid transposed and every block a
        transposed view (the kernels, which read a block row-major, run on
        X as it was placed)."""
        return dataclasses.replace(
            self,
            blocks=tuple(zip(*(tuple(b.T for b in row) for row in self.blocks))),
            shape=(self.shape[1], self.shape[0]),
            row_cuts=self.col_cuts, col_cuts=self.row_cuts,
        )


def _cuts(size: int, parts: int) -> tuple:
    run = -(-size // parts)
    return tuple(min(b * run, size) for b in range(parts + 1))


def shard_dense(X, mesh: Mesh) -> ShardedDense:
    """Cut the dense ``X`` into ``mesh``'s grid, each block copied row-major
    to its device (a block that already is one, as on a (1, 1) mesh on X's
    device, is X's own memory)."""
    X = torch.as_tensor(X)
    if X.dim() != 2:
        raise ValueError(f"shard_dense takes a matrix, got shape {tuple(X.shape)}")
    R, C = mesh.devices.shape
    rc, cc = _cuts(X.shape[0], R), _cuts(X.shape[1], C)
    blocks = tuple(
        tuple(X[rc[i]:rc[i + 1], cc[j]:cc[j + 1]].to(mesh.devices[i, j]).contiguous()
              for j in range(C))
        for i in range(R))
    return ShardedDense(blocks, tuple(X.shape), mesh, rc, cc)


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


def dense_mm(X: ShardedDense, D):
    """``X @ D`` -> (p, k) on the lead device.  Every block's product is
    enqueued before a partial is moved; row i's partials are added in j
    order."""
    lead = X.mesh.lead
    d = _Pieces(D.to(lead), X.col_cuts, 0)
    parts = [[b @ d(j, b.device) for j, b in enumerate(row)] for row in X.blocks]
    return torch.cat([_sum_in_order(row, lead) for row in parts])


def dense_mtm(D, X: ShardedDense):
    """``D @ X`` -> (k, n) on the lead device; column j's partials are
    added in i order."""
    lead = X.mesh.lead
    d = _Pieces(D.to(lead), X.row_cuts, 1)
    parts = [[d(i, b.device) @ b for i, b in enumerate(col)] for col in zip(*X.blocks)]
    return torch.cat([_sum_in_order(col, lead) for col in parts], dim=1)


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
    parts = [[wtq(b, w(i, b.device), h(j, b.device), delta) if b.numel()
              else b.new_zeros((W.shape[1], b.shape[1])) for i, b in enumerate(col)]
             for j, col in enumerate(zip(*X.blocks))]
    return torch.cat([_sum_in_order(col, lead) for col in parts], dim=1)


def dense_qht(X: ShardedDense, W, H, delta):
    """``(X / (W H + delta)) H'`` -> (p, k) on the lead device: each block's
    ``qht`` (kernel 9 on the card), row block i's partials added in j
    order."""
    from .cuda.mu import qht

    lead = X.mesh.lead
    w, h = _factor_pieces(X, W, H)
    parts = [[qht(b, w(i, b.device), h(j, b.device), delta) if b.numel()
              else b.new_zeros((b.shape[0], W.shape[1])) for j, b in enumerate(row)]
             for i, row in enumerate(X.blocks)]
    return torch.cat([_sum_in_order(row, lead) for row in parts])


def _in_block_order(X, values):
    """A 0-d tensor on the lead device: the blocks' values (block row major)
    added in float64 in that order, rounded once to X's type."""
    lead = X.mesh.lead
    acc = torch.zeros((), dtype=torch.float64, device=lead)
    for v in values:
        acc = acc + v.to(device=lead, dtype=torch.float64)
    return acc.to(X.dtype)


def dense_objective(X: ShardedDense, W, H, objective):
    """``objective`` (``mse_objective`` or ``kl_objective`` of
    ``ops/objectives.py``: kernel 6 on a large float32 block on the card)
    summed over the blocks, each with its W rows and H columns."""
    w, h = _factor_pieces(X, W, H)
    return _in_block_order(X, (objective(b, w(i, b.device), h(j, b.device))
                               for i, row in enumerate(X.blocks)
                               for j, b in enumerate(row) if b.numel()))


def dense_reduce(X: ShardedDense, fn):
    """``fn`` of each block (a 0-d sum) added as ``_in_block_order`` adds."""
    return _in_block_order(X, (fn(b) for row in X.blocks for b in row))

