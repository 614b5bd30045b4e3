"""Small numeric utilities: plain functions on tensors.

``projectnn`` and ``normalize1_cols`` stand alone between PyTorch's launches
(nothing fuses them into the ops around them), so on the card they run the
elementwise kernels of ``ops/cuda/elementwise.py``; on the CPU and in float64
they run those kernels' plain versions."""

from __future__ import annotations

import torch

from ..ops.cuda import elementwise

__all__ = ["adddiag", "normalize1", "normalize1_cols", "projectnn", "posneg",
           "printf_mat", "safe_div"]


def adddiag(A, a):
    """Return ``A + a*I``."""
    m, n = A.shape
    if m != n:
        raise ValueError("A must be square.")
    return A + a * torch.eye(m, dtype=A.dtype, device=A.device)


def normalize1(a):
    """Scale ``a`` so its entries sum to one."""
    return a / a.sum()


def normalize1_cols(a):
    """Scale each column of ``a`` to sum to one."""
    return elementwise.scale_cols(a, elementwise.colsum(a))


def projectnn(A):
    """Project all entries onto the non-negative orthant (NaN is kept)."""
    return elementwise.projectnn(A)


def posneg(A):
    """Split ``A = Ap - An`` into its positive and negative parts."""
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    pos = A >= 0
    return torch.where(pos, A, zero), torch.where(pos, zero, -A)


def printf_mat(x):
    """Print a matrix a row a line, each entry as ``%8.4f``."""
    import numpy as np

    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    for i in range(x.shape[0]):
        print(" ".join(f"{v:8.4f}" for v in x[i]) + " ")


def safe_div(num, den):
    """``num / den`` with 0 where ``den == 0`` (guards the 0/0 in the
    convergence diagnostic)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))
