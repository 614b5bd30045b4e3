"""The Fast-HALS column sweep (``csrc/hals.cu``): one launch a half-step.

* ``hals_sweep(W, G, C, perm)`` — for ``W``, ``C`` ``(m, rows, k)`` and
  ``G`` ``(m, k, k)``: every row of every lane visits the components in
  ``perm``, and for each component c takes
  ``g = W[l, i] @ G[l, :, c] - C[l, i, c]`` and
  ``W[l, i, c] = max(0, W[l, i, c] - g / G[l, c, c])``; a lane whose
  ``G[l, c, c]`` is 0 keeps its column c.  ``W`` is updated in place.  The
  solver passes ``G = H H' + l2 I`` and ``C = X H' - l1``.
* ``hals_sweep_plain`` — the column loops the solver ran before the kernel:
  with one lane a ``torch.addmv`` a column divided by the Hessian entry, with
  several the lanes' ``addmv``s and one batched step a column.  Each reads
  the Hessian's diagonal to the host once, to skip a zero entry.

The wrapper launches the kernel for float32 tensors on the card or raises;
it takes the plain version for tensors on the CPU and for float64 (the
kernel is float32 only).  The kernel sums each ``g`` in a fixed order that
depends on nothing but ``k`` and ``perm``, so a lane gives the same bits alone and in a
batch, and on every run.  ``build.launch_counts()["hals_sweep"]`` counts its
launches.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from ...utils import spans
from .build import launch

__all__ = ["hals_sweep", "hals_sweep_plain"]


def hals_sweep_plain(W, G, C, perm):
    """Plain version of ``hals_sweep``: ``perm`` a sequence of ints."""
    m = W.shape[0]
    if m == 1:
        out, W, HHt, XHt = W, W[0], G[0], C[0]
        # one host read per half-step: a component with a zero Hessian is skipped
        hess = spans.host_read(torch.diagonal(HHt), "tolist")
        for c in perm:
            if hess[c] == 0:
                continue
            # grad[i] = sum_r HHt[c, r] * W[i, r] - XHt[i, c]
            grad = torch.addmv(XHt[:, c], W, HHt[:, c], beta=-1)
            col = W[:, c]
            col.sub_(grad.div_(hess[c])).clamp_min_(0)
        return out
    rows = W.shape[1]
    HHt, XHt = G, C
    hess_t = torch.diagonal(HHt, dim1=1, dim2=2)
    # one host read per half-step: a lane's component with a zero Hessian
    # keeps its column
    hess = spans.host_read(hess_t, "tolist")
    # the single lane divides by a Python float, which torch applies on the
    # card as a multiply by its float32 reciprocal and on the CPU as a
    # division: the lanes do the same with their own entries
    safe = torch.where(hess_t == 0, 1, hess_t)
    if W.is_cuda:
        recip = safe.reciprocal()
        scale = lambda g, c: g.mul_(recip[:, c : c + 1])  # noqa: E731
    else:
        scale = lambda g, c: g.div_(safe[:, c : c + 1])  # noqa: E731
    grad = W.new_empty((m, rows))
    for c in perm:
        zero = [hess[lane][c] == 0 for lane in range(m)]
        if all(zero):
            continue
        # grad[l, i] = sum_r HHt[l, r, c] * W[l, i, r] - XHt[l, i, c]
        for lane in range(m):
            torch.addmv(XHt[lane, :, c], W[lane], HHt[lane, :, c], beta=-1,
                        out=grad[lane])
        col = W[:, :, c]
        if any(zero):
            keep = torch.tensor(zero, device=W.device)[:, None]
            col.copy_(torch.where(keep, col, (col - scale(grad, c)).clamp_min(0)))
        else:
            col.sub_(scale(grad, c)).clamp_min_(0)
    return W


def _dense(A) -> bool:
    """Whether A's elements occupy distinct places and fill its storage's
    range: some order of its dimensions is row-major."""
    size = 1
    for n, s in sorted(zip(A.shape, A.stride()), key=lambda p: (p[1], p[0])):
        if n != 1 and s != size:
            return False
        size *= n
    return True


def _visit_order(perm, k, device):
    """``perm`` as the kernel takes it: None for ``range(k)`` (the kernel
    visits 0 .. k - 1), else k int32 copied from pinned memory without
    waiting for the stream."""
    if isinstance(perm, range) and perm == range(k):
        return None
    perm = list(perm)
    if sorted(perm) != list(range(k)):
        raise ValueError(f"perm must be a permutation of 0 .. {k - 1}")
    host = torch.tensor(perm, dtype=torch.int32).pin_memory()
    return host.to(device, non_blocking=True)


def hals_sweep(W, G, C, perm: Sequence[int]):
    """One Fast-HALS sweep of every lane, ``W`` ``(m, rows, k)`` updated in
    place and returned.  ``G`` ``(m, k, k)``, ``C`` ``(m, rows, k)`` at any
    strides (``W`` too, where no two of its elements share a place); ``perm``
    the visit order, a sequence of ints.  The kernel refuses more than
    65,535 lanes and a k whose tables leave no room in shared memory (about
    16,000): the launch raises."""
    if W.dim() != 3:
        raise ValueError(f"W must be (m, rows, k), got {tuple(W.shape)}")
    m, rows, k = W.shape
    if tuple(G.shape) != (m, k, k) or tuple(C.shape) != (m, rows, k):
        raise ValueError(
            f"W {tuple(W.shape)}, G {tuple(G.shape)}, C {tuple(C.shape)} "
            "are inconsistent"
        )
    if not (W.dtype == G.dtype == C.dtype):
        raise TypeError(f"dtypes differ: {W.dtype}, {G.dtype}, {C.dtype}")
    if not (W.device == G.device == C.device):
        raise ValueError(f"devices differ: {W.device}, {G.device}, {C.device}")
    if len(perm) != k:
        raise ValueError(f"perm has {len(perm)} entries for k = {k}")
    if not W.is_cuda or W.dtype == torch.float64:
        return hals_sweep_plain(W, G, C, perm)
    if W.dtype != torch.float32:
        raise TypeError(f"the hals_sweep kernel takes float32, got {W.dtype}")
    if not _dense(W):
        raise ValueError("W's elements must occupy distinct places (a clone, not an expanded view)")
    if W.numel() == 0:
        return W
    order = _visit_order(perm, k, W.device)
    launch("hals_sweep", W, G.contiguous(), C, order, m, rows, k, *W.stride(), *C.stride())
    return W
