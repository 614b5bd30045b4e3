"""The elementwise kernels (``csrc/elementwise.cu``):

* ``projectnn``  — ``max(A, 0)``, NaN kept, the bits of ``A.clamp_min(0)``;
* ``colsum``     — the column sums of an ``(m, n)`` matrix, summed in double
  in a fixed order and rounded once;
* ``scale_cols`` — ``A / sums``, column ``j`` divided by ``sums[j]``.

``utils.numeric.projectnn`` and ``normalize1_cols`` call them.  Each wrapper
launches its kernel for float32 tensors on the card or raises; it takes the
plain version beside it for tensors on the CPU and for float64 (the kernels
are float32 only).  ``build.launch_counts()`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .build import launch

__all__ = ["projectnn", "projectnn_plain", "colsum", "colsum_plain",
           "scale_cols", "scale_cols_plain", "COLSUM_ROWS"]

COLSUM_ROWS = 256  # rows a thread block of the column sums takes (csrc)


def _plain(A) -> bool:
    return not A.is_cuda or A.dtype == torch.float64


def _check_f32(what, *tensors) -> None:
    for A in tensors:
        if A.dtype != torch.float32:
            raise TypeError(f"the {what} kernel takes float32, got {A.dtype}")


def _vec(*tensors) -> int:
    """1 when every pointer is 16-byte aligned (four floats a load)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def projectnn_plain(A):
    """Plain version of ``projectnn``: an entry is kept unless it is below
    zero (NaN and -0.0 pass through, as in ``clamp_min``)."""
    return torch.where(A < 0, torch.zeros((), dtype=A.dtype, device=A.device), A)


def projectnn(A):
    """``max(A, 0)`` as one pass over A's memory.  A row-major or transposed
    2-D tensor is read as it lies and the result has its layout; any other
    layout is copied row-major first."""
    if _plain(A):
        return projectnn_plain(A)
    _check_f32("projectnn", A)
    if not (A.is_contiguous() or (A.dim() == 2 and A.T.is_contiguous())):
        A = A.contiguous()
    out = torch.empty_like(A)  # keeps a transposed layout
    if A.numel():
        launch("projectnn", A, out, A.numel(), _vec(A, out))
    return out


def _check_matrix(A, what):
    if A.dim() != 2:
        raise ValueError(f"the {what} kernel takes an (m, n) matrix, got {tuple(A.shape)}")
    return A.contiguous()


def colsum_plain(A):
    """Plain version of ``colsum``."""
    return A.sum(dim=0)


def colsum(A):
    """Column sums ``(n,)`` of ``A (m, n)``."""
    if _plain(A):
        return colsum_plain(A)
    _check_f32("colsum", A)
    A = _check_matrix(A, "colsum")
    m, n = A.shape
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    if m == 0:
        return out.zero_()
    if n:
        partial = torch.empty((-(-m // COLSUM_ROWS), n), dtype=torch.float64,
                              device=A.device)
        launch("colsum", A, partial, out, m, n)
    return out


def scale_cols_plain(A, sums):
    """Plain version of ``scale_cols``."""
    return A / sums


def scale_cols(A, sums):
    """``A / sums`` for ``A (m, n)`` and ``sums (n,)``."""
    if _plain(A):
        return scale_cols_plain(A, sums)
    _check_f32("scale_cols", A, sums)
    A = _check_matrix(A, "scale_cols")
    m, n = A.shape
    if tuple(sums.shape) != (n,) or sums.device != A.device:
        raise ValueError(
            f"sums must be ({n},) on {A.device}, got {tuple(sums.shape)} on {sums.device}")
    sums = sums.contiguous()
    out = torch.empty_like(A)
    if A.numel():
        launch("scale_cols", A, sums, out, A.numel(), n,
               int(n % 4 == 0 and _vec(A, out)))
    return out
