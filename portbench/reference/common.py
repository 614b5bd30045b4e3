"""What the plain solvers share: X as a torch CSR tensor in both orientations
(built here from the benchmark's entries; its products summed in float64 and
rounded to float32), the sampled product by gathers,
dense X a block of rows at a time, the objectives in float64, and the
precision every product runs in.

``Products(low=False)`` computes every product in full float32.
``Products(low=True)`` is the control: every product's operands rounded to
TF32 (10 mantissa bits, to nearest, ties away from zero, as the tensor
cores' conversion does) and accumulated in float32, which is a TF32 matrix
product, on any device.  Nothing here imports the program.
"""

from __future__ import annotations

import math
import warnings

import torch

from portbench.common import ieee_matmul

ENTRIES_PER_BLOCK = 1 << 21
ROWS_PER_BLOCK = 8192
EPS32 = float(torch.finfo(torch.float32).eps)


def tf32(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Products:
    def __init__(self, low: bool):
        self.low = low

    def r(self, x):
        return tf32(x) if self.low else x

    def mm(self, a, b):
        with ieee_matmul():
            return self.r(a) @ self.r(b)

    def mv(self, a, v):
        with ieee_matmul():
            return self.r(a) @ self.r(v)


class Sparse:
    """X from its entries (row-major, distinct): ``X @ D`` and ``X' @ D`` by
    torch's CSR product, and ``(W @ H)`` at the entries by gathers."""

    def __init__(self, data):
        p, n = data["shape"]
        self.shape = (p, n)
        rows = data["rows"].long()
        cols = data["cols"].long()
        self.rows, self.cols, self.vals = rows, cols, data["vals"]
        dev = rows.device
        self.crow = torch.zeros(p + 1, dtype=torch.int64, device=dev)
        self.crow[1:] = torch.bincount(rows, minlength=p).cumsum(0)
        self.t_order = torch.argsort(cols * p + rows)
        self.ccol = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        self.ccol[1:] = torch.bincount(cols, minlength=n).cumsum(0)
        self.t_rows = rows[self.t_order]

    @staticmethod
    def _product(crow, col, v, shape, D):
        """The sums in float64, rounded once to float32: the library's
        sparse product does not fix its order of addition, and in float64
        that order is far below float32's rounding."""
        with warnings.catch_warnings():  # torch's note that sparse CSR is in beta
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(crow, col, v.double(), shape, check_invariants=False)
        return (A @ D.double().contiguous()).to(D.dtype)

    def mm(self, prod: Products, v, D):
        """``X @ D`` with X's values ``v`` (entry order)."""
        return self._product(self.crow, self.cols, prod.r(v), self.shape, prod.r(D))

    def tmm(self, prod: Products, v, D):
        """``X' @ D`` with X's values ``v`` (entry order)."""
        return self._product(self.ccol, self.t_rows, prod.r(v)[self.t_order],
                             self.shape[::-1], prod.r(D))

    def sampled(self, prod: Products, W, H):
        """``(W @ H)`` at the entries, in entry order."""
        W = prod.r(W)
        Ht = prod.r(H).T.contiguous()
        out = torch.empty(self.rows.numel(), dtype=W.dtype, device=W.device)
        for e0 in range(0, out.numel(), ENTRIES_PER_BLOCK):
            e1 = e0 + ENTRIES_PER_BLOCK
            out[e0:e1] = (W[self.rows[e0:e1]] * Ht[self.cols[e0:e1]]).sum(1)
        return out


def operand(data):
    """The reference's own X: a ``Sparse`` from the entries, or the dense
    tensor itself."""
    return Sparse(data) if data["kind"] == "sparse" else data["X"]


def row_blocks(X):
    for i0 in range(0, X.shape[0], ROWS_PER_BLOCK):
        yield slice(i0, i0 + ROWS_PER_BLOCK)


def mse(X, W, H) -> float:
    """``0.5 ||X - W H||_F^2`` in float64."""
    with ieee_matmul():
        if isinstance(X, Sparse):
            wh = X.sampled(Products(False), W, H).double()
            v = X.vals.double()
            W64, H64 = W.double(), H.double()
            wh_sq = ((W64.T @ W64) * (H64 @ H64.T)).sum()
            return float(0.5 * ((v * v).sum() - 2 * (v * wh).sum() + wh_sq))
        total = 0.0
        for b in row_blocks(X):
            total += float(((X[b] - W[b] @ H).double() ** 2).sum())
        return 0.5 * total


def kl(X, W, H) -> float:
    """Generalized KL divergence ``sum x log(x / wh) - x + wh`` (0 log 0 =
    0), in float64."""
    with ieee_matmul():
        if isinstance(X, Sparse):
            wh = X.sampled(Products(False), W, H).double()
            v = X.vals.double()
            mass = float(W.double().sum(0) @ H.double().sum(1))
            pos = v > 0
            return float(torch.where(pos, v * (v.clamp_min(1e-300).log() - wh.log()) - v,
                                     0).sum()) + mass
        total = 0.0
        for b in row_blocks(X):
            x = X[b].double()
            wh = (W[b] @ H).double()
            total += float((torch.where(x > 0, x * (x.clamp_min(1e-300).log() - wh.log()), 0)
                            - x + wh).sum())
        return total


def sq_norm(X) -> float:
    if isinstance(X, Sparse):
        return float((X.vals.double() ** 2).sum())
    return float(sum(float((X[b].double() ** 2).sum()) for b in row_blocks(X)))


def relerr(X, W, H) -> float:
    """``||X - W H||_F / ||X||_F``."""
    return math.sqrt(max(2 * mse(X, W, H), 0.0) / sq_norm(X))
