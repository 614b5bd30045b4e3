"""The multiplicative-update kernels for dense X (``csrc/mu.cu``).

* ``mu_factor_update`` — the MSE factor step
  ``F * max(0, C - lam) / (G @ F + delta)`` with the ``(k, m)`` product
  ``G @ F`` kept inside the kernel.  Serves both halves of the sweep: H as it
  is (``G = W'W``, ``C = W'X``) and W through transposed views
  (``F = W'``, ``G = HH'``, ``C = (XH')'``), read and written in place of a
  transposed copy.
* ``wtq`` / ``qht`` — the divergence sweep's ``W' Q`` and ``Q H'`` with
  ``Q = X / (W H + delta)`` formed tile by tile inside the kernel; the
  ``p x n`` quotient never exists in device memory.  A thread block owns 64
  columns (``wtq``) or 64 rows (``qht``) of the output and walks the other
  axis; where that gives the card too few blocks the walk is cut into runs
  whose partial outputs a second small kernel adds in a fixed order.

Every kernel sums over ``k`` one slab at a time (``MU_SLAB`` rows of G and F
for ``mu_factor_update``, ``WH_SLAB`` components of the ``W @ H`` tile for
``wtq`` and ``qht``), keeping its sums in registers across slabs: any ``k``
fits the card's shared memory, and a ``k`` that fits one slab sums in the
order it would unslabbed.

Each wrapper launches its kernel for float32 tensors on the card or raises;
it takes the plain version beside it for tensors on the CPU and for float64
(the kernels are float32 only; float64 is the parity-test type and runs the
plain expression).  ``build.launch_counts()`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .build import launch

__all__ = [
    "mu_factor_update", "mu_factor_update_plain", "wtq", "wtq_plain", "qht",
    "qht_plain", "walk_splits", "MU_SLAB", "WH_SLAB",
]

# depth of one k-slab in shared memory: ``MU_KS`` of csrc/mu.cu (also the
# rows of the result a thread block of mu_factor_update takes) and ``WH_KS``
# of csrc/wh_tile.cuh (the W @ H tile of wtq, qht and the objective kernel)
MU_SLAB = 64
WH_SLAB = 128


# ---------------------------------------------------------------------------
# the MSE factor step


def mu_factor_update_plain(F, G, C, lam, delta):
    """Plain version of ``mu_factor_update``."""
    return F * torch.clamp(C - lam, min=0) / (G @ F + delta)


def mu_factor_update(F, G, C, lam, delta):
    """``F * max(0, C - lam) / (G @ F + delta)`` for F, C ``(k, m)`` and G
    ``(k, k)``; ``lam`` and ``delta`` are Python floats.  F and C are both
    row-major, or both transposed views of row-major ``(m, k)`` tensors; the
    result has F's layout."""
    k, m = F.shape
    if tuple(C.shape) != (k, m) or tuple(G.shape) != (k, k):
        raise ValueError(
            f"F {tuple(F.shape)}, G {tuple(G.shape)}, C {tuple(C.shape)} "
            "are inconsistent"
        )
    if not (F.dtype == G.dtype == C.dtype):
        raise TypeError(f"dtypes differ: {F.dtype}, {G.dtype}, {C.dtype}")
    if not (F.device == G.device == C.device):
        raise ValueError(f"devices differ: {F.device}, {G.device}, {C.device}")
    if not F.is_cuda or F.dtype == torch.float64:
        return mu_factor_update_plain(F, G, C, lam, delta)
    if F.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {F.dtype}")
    if k < 1:
        raise ValueError(f"k must be at least 1 for the mu_factor_update kernel, got {k}")
    if F.is_contiguous() and C.is_contiguous():
        trans = 0
        out = torch.empty_like(F)
    elif F.T.is_contiguous() and C.T.is_contiguous():
        trans = 1
        out = torch.empty((m, k), dtype=F.dtype, device=F.device).T
    else:
        raise ValueError(
            "F and C must both be row-major or both be transposed views of "
            "row-major tensors"
        )
    G = G.contiguous()
    launch(
        "mu_factor_update", F, G, C, out, k, m, float(lam), float(delta), trans,
    )
    return out


# ---------------------------------------------------------------------------
# the divergence products


def wtq_plain(X, W, H, delta):
    """Plain version of ``wtq`` (forms the whole quotient)."""
    return W.T @ (X / (W @ H + delta))


def qht_plain(X, W, H, delta):
    """Plain version of ``qht`` (forms the whole quotient)."""
    return (X / (W @ H + delta)) @ H.T


def check_dense_problem(X, W, H, what):
    """Shapes, types and places of a dense ``(X, W, H)`` handed to a kernel;
    returns ``(p, n, k, W, H, xvec)`` with the factors row-major.  ``xvec``
    says that a row piece of X may be read as one 16-byte load."""
    p, n = X.shape
    k = W.shape[1]
    if W.shape[0] != p or tuple(H.shape) != (k, n):
        raise ValueError(
            f"X {tuple(X.shape)}, W {tuple(W.shape)}, H {tuple(H.shape)} "
            "are inconsistent"
        )
    for name, A in (("X", X), ("W", W), ("H", H)):
        if A.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the {what} kernel, got {A.dtype}")
        if A.device != X.device:
            raise ValueError(f"{name} lives on {A.device}, X on {X.device}")
    if not X.is_contiguous():
        raise ValueError(
            f"X must be contiguous (row-major) for the {what} kernel; "
            "call X.contiguous() first"
        )
    if k < 1:
        raise ValueError(f"k must be at least 1 for the {what} kernel, got {k}")
    xvec = int(n % 4 == 0 and X.data_ptr() % 16 == 0)
    return p, n, k, W.contiguous(), H.contiguous(), xvec


def walk_splits(owned, walked, k, device) -> int:
    """Into how many runs to cut a walk over ``walked`` rows or columns when
    the output has ``owned`` rows or columns: enough for sixteen thread blocks
    a multiprocessor (finer pieces even out the last wave; on an H100 the gain
    flattens there), at most one run a tile.  The same shapes on the same card
    always give the same cut, hence the same summation order; a card with
    another multiprocessor count sums in another order and may differ in the
    last bits.  The sixteen is a constant and not a setting: ``chip_smoke.py``
    times both kernels at other cuts (``ms_by_runs``)."""
    blocks = -(-owned // 64) * -(-k // 64)
    want = 16 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-want // blocks), -(-walked // 64)))


def _quotient_product(name, X, W, H, delta):
    plain, owned_axis = {"wtq": (wtq_plain, 1), "qht": (qht_plain, 0)}[name]
    if not X.is_cuda or X.dtype == torch.float64:
        return plain(X, W, H, delta)
    p, n, k, W, H, xvec = check_dense_problem(X, W, H, name)
    shape = (k, n) if name == "wtq" else (p, k)
    splits = walk_splits(X.shape[owned_axis], X.shape[1 - owned_axis], k, X.device)
    out = torch.empty(shape, dtype=torch.float32, device=X.device)
    partial = out if splits == 1 else torch.empty(
        (splits, *shape), dtype=torch.float32, device=X.device)
    launch(
        name, X, W, H, partial, out, p, n, k, float(delta), xvec, splits,
    )
    return out


def wtq(X, W, H, delta):
    """``W' @ (X / (W H + delta))``, ``(k, n)``, without the quotient in
    device memory."""
    return _quotient_product("wtq", X, W, H, delta)


def qht(X, W, H, delta):
    """``(X / (W H + delta)) @ H'``, ``(p, k)``, without the quotient in
    device memory."""
    return _quotient_product("qht", X, W, H, delta)
