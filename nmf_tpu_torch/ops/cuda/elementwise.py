"""The elementwise kernels (``csrc/elementwise.cu``):

* ``projectnn``  — ``max(A, 0)``, NaN kept, the bits of ``A.clamp_min(0)``;
* ``colsum``     — the column sums of an ``(m, n)`` matrix, summed in double
  in a fixed order and rounded once, in one launch whose grid
  ``colsum_plan`` sizes to the card;
* ``scale_cols`` — ``A / sums``, column ``j`` divided by ``sums[j]``.

``utils.numeric.projectnn`` and ``normalize1_cols`` call them.  Each wrapper
launches its kernel for float32 tensors on the card or raises; it takes the
plain version beside it for tensors on the CPU and for float64 (the kernels
are float32 only).  ``build.launch_counts()`` counts kernel launches, and
``utils.spans`` counts them in the innermost span while it records.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .build import launch

__all__ = ["projectnn", "projectnn_plain", "colsum", "colsum_plain",
           "colsum_plan", "ColsumPlan", "scale_cols", "scale_cols_plain",
           "COLSUM_THREADS", "COLSUM_BLOCKS_PER_SM", "COLSUM_MIN_ROWS"]

# the column sums (csrc/elementwise.cu): threads a block (``COLSUM_NT``),
# blocks a multiprocessor keeps resident at that size (``COLSUM_BPS``, also
# the launch bounds'), and the fewest rows a block takes where the matrix is
# too short to give every multiprocessor one
COLSUM_THREADS = 1024
COLSUM_BLOCKS_PER_SM = 1
COLSUM_MIN_ROWS = 64


class ColsumPlan(NamedTuple):
    """One launch of the column sums: ``blocks`` thread blocks, block ``b``
    taking rows ``[b * rows, min(m, (b + 1) * rows))``; ``scratch`` float64
    words: ``blocks * n`` partial sums, then one holding the ticket."""
    blocks: int
    rows: int
    scratch: int


def colsum_plan(m, n, sms) -> ColsumPlan:
    """The grid of the column sums of an ``(m, n)`` matrix on a card with
    ``sms`` multiprocessors: as many blocks as the card keeps resident
    (``COLSUM_BLOCKS_PER_SM`` an SM), fewer where that would give a block
    under ``COLSUM_MIN_ROWS`` rows, each block a contiguous run of rows and
    no block empty.  The order of every addition follows from the plan and
    ``n``, so the same shapes on the same card give the same bits."""
    if m < 1 or n < 1 or sms < 1:
        raise ValueError(f"no column sums to plan for m={m}, n={n}, sms={sms}")
    blocks = max(1, min(COLSUM_BLOCKS_PER_SM * sms, m // COLSUM_MIN_ROWS))
    rows = -(-m // blocks)
    blocks = -(-m // rows)
    return ColsumPlan(blocks, rows, blocks * n + 1)


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
    """Column sums ``(n,)`` of ``A (m, n)``: one launch, its partial sums
    and ticket in scratch of the call's own."""
    if _plain(A):
        return colsum_plain(A)
    _check_f32("colsum", A)
    A = _check_matrix(A, "colsum")
    m, n = A.shape
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    if m == 0:
        return out.zero_()
    if n:
        sms = torch.cuda.get_device_properties(A.device).multi_processor_count
        plan = colsum_plan(m, n, sms)
        scratch = torch.empty(plan.scratch, dtype=torch.float64, device=A.device)
        launch("colsum", A, scratch, out, m, n, plan.blocks, plan.rows,
               int(n % 4 == 0 and _vec(A)))
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
