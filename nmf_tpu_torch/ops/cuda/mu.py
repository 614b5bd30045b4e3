"""The multiplicative-update kernels for dense X (``csrc/mu.cu``).

* ``mu_factor_update`` — the MSE factor step
  ``F * max(0, C - lam) / (G @ F + delta)`` with the ``(k, m)`` product
  ``G @ F`` kept inside the kernel.  Serves both halves of the sweep: H as it
  is (``G = W'W``, ``C = W'X``) and W through transposed views
  (``F = W'``, ``G = HH'``, ``C = (XH')'``), read and written in place of a
  transposed copy.  A persistent grid: ``mu_tiling`` picks the tile width
  and the number of blocks, each of which walks its tiles.
* ``wtq`` / ``qht`` — the divergence sweep's ``W' Q`` and ``Q H'`` with
  ``Q = X / (W H + delta)`` formed tile by tile inside the kernel; the
  ``p x n`` quotient never exists in device memory.  A thread block owns
  ``QT_EDGE`` columns (``wtq``) or rows (``qht``) of the output by
  ``QT_SLAB`` components and walks the other axis in steps of ``QT_STEP``;
  where that gives the card too few blocks the walk is cut into runs whose
  partial outputs a second small kernel adds in a fixed order.

Every kernel sums over ``k`` one slab at a time (``MU_SLAB`` rows of G and F
for ``mu_factor_update``, ``QT_SLAB`` components of the ``W @ H`` tile for
``wtq`` and ``qht``), keeping its sums in registers across slabs: any ``k``
fits the card's shared memory, and a ``k`` that fits one slab sums in the
order it would unslabbed.

Each wrapper launches its kernel for float32 tensors on the card or raises;
it takes the plain version beside it for tensors on the CPU and for float64
(the kernels are float32 only; float64 is the parity-test type and runs the
plain expression).  ``build.launch_counts()`` counts kernel launches, and
``utils.spans`` counts them in the innermost span while it records.
"""

from __future__ import annotations

import torch

from .build import launch

__all__ = [
    "mu_factor_update", "mu_factor_update_plain", "mu_tiling", "mu_smem",
    "mu_blocks_per_sm", "wtq",
    "wtq_plain", "qht", "qht_plain", "walk_splits", "MU_SLAB", "MU_WIDTHS",
    "QT_SLAB", "QT_EDGE", "QT_STEP",
]

# depth of one k-slab in shared memory: ``MU_KS`` of csrc/mu.cu (also the
# rows of the result a thread block of mu_factor_update takes) and ``QT_KS``
# of csrc/quotient_tile.cuh (the W @ H tile of wtq, qht and the objective;
# also the components a thread block of wtq or qht takes)
MU_SLAB = 64
QT_SLAB = 64
# mu_factor_update: the columns of F a tile takes, widest first (``MU_BN``
# of csrc/mu.cu and its halves); above ``MU_SLAB`` only the widest.  The
# widest that gives the card ``MU_TILES_PER_SM`` tiles a multiprocessor
MU_WIDTHS = (64, 32, 16)
MU_TILES_PER_SM = 2
# an H100 multiprocessor: shared memory (of which 1 KB goes to each resident
# block), threads and blocks it keeps resident
SM_SHARED_BYTES = 233472
SM_THREADS = 2048
SM_BLOCKS = 32
# wtq / qht / the objective: the output columns / rows a thread block owns
# (``QT_L`` of csrc/quotient_tile.cuh) and the rows / columns of X a step of
# its walk takes (``QT_S``)
QT_EDGE = 256
QT_STEP = 64
# thread blocks a multiprocessor that ``walk_splits`` aims for where it cuts
# a walk (one is resident at a time)
RUN_BLOCKS_PER_SM = 10


# ---------------------------------------------------------------------------
# the MSE factor step


def mu_factor_update_plain(F, G, C, lam, delta):
    """Plain version of ``mu_factor_update``."""
    return F * torch.clamp(C - lam, min=0) / (G @ F + delta)


def mu_smem(k, bn) -> int:
    """Bytes of shared memory a block of ``mu_factor_update`` takes at
    ``k`` with tiles of ``bn`` columns: G and two buffers of F and C tiles;
    above ``MU_SLAB`` a slab of G, a slab of F and the unit's own F and C
    rows.  Rows of ``4 * (ceil(ks / 4) | 1)`` floats (csrc/mu.cu:
    ``mu_ld``)."""
    ks = min(k, MU_SLAB)
    ld = 4 * (-(-ks // 4) | 1)
    return 4 * (ks * ld + (4 if k <= MU_SLAB else 3) * bn * ld)


def mu_blocks_per_sm(k, bn) -> int:
    """Blocks of ``mu_factor_update`` a multiprocessor keeps resident: by
    shared memory, threads, the card's cap and registers (the kernel's
    launch bounds: ``128 / bn`` blocks)."""
    threads = min(-(-k // 4), MU_SLAB // 4) * (bn // 4)
    by_registers = 128 // bn
    return min(SM_SHARED_BYTES // (mu_smem(k, bn) + 1024), SM_THREADS // threads,
               SM_BLOCKS, by_registers)


def mu_tiling(k, m, sms, bn=None):
    """``(bn, blocks)`` of ``mu_factor_update`` for F of ``(k, m)`` on a card
    with ``sms`` multiprocessors: the widest tile of ``MU_WIDTHS`` that cuts
    the ``m`` columns into at least ``MU_TILES_PER_SM`` tiles a
    multiprocessor (the narrowest where none does; the widest above
    ``MU_SLAB``), unless ``bn`` is given; and a persistent grid of as many
    blocks as the card keeps resident (``mu_blocks_per_sm``), or as
    the units of work where there are fewer (a unit: a tile by a slab of
    ``MU_SLAB`` rows of the result).  The same shapes on the same card give
    the same grid, and every grid gives the same bits."""
    if bn is None:
        fits = [w for w in MU_WIDTHS if -(-m // w) >= MU_TILES_PER_SM * sms]
        bn = MU_WIDTHS[0] if k > MU_SLAB else (fits[0] if fits else MU_WIDTHS[-1])
    if bn not in MU_WIDTHS or (k > MU_SLAB and bn != MU_WIDTHS[0]):
        raise ValueError(f"no tile of {bn} columns at k = {k}")
    units = -(-m // bn) * -(-k // MU_SLAB)
    return bn, max(1, min(units, mu_blocks_per_sm(k, bn) * sms))


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
    sms = torch.cuda.get_device_properties(F.device).multi_processor_count
    bn, blocks = mu_tiling(k, m, sms)
    launch(
        "mu_factor_update", F, G, C, out, k, m, float(lam), float(delta), trans,
        bn, blocks,
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


def walk_splits(owned, walked, k, sms, edge) -> int:
    """Into how many runs to cut a walk over ``walked`` rows or columns when
    the output has ``owned`` rows or columns, each thread block owning
    ``edge`` of them by ``QT_SLAB`` components, on a card with ``sms``
    multiprocessors (one block resident on each).  No cut where the output's
    own blocks make at least three waves, the last at least 95 % full (each
    run adds a partial output to write and add up, and a block's start);
    else enough runs for ``RUN_BLOCKS_PER_SM`` blocks a multiprocessor
    (finer pieces even out the last wave), at most one a step.  The same
    shapes on the same card always give the same cut, hence the same
    summation order; a card with another multiprocessor count may cut, and
    round, otherwise.  The constants are not settings: ``chip_smoke.py``
    times both kernels at other cuts (``ms_by_runs``)."""
    blocks = -(-owned // edge) * -(-k // QT_SLAB)
    waves = -(-blocks // sms)
    if waves >= 3 and 20 * blocks >= 19 * waves * sms:
        return 1
    want = RUN_BLOCKS_PER_SM * sms
    return max(1, min(-(-want // blocks), -(-walked // QT_STEP)))


def _quotient_product(name, X, W, H, delta):
    plain, owned_axis = {"wtq": (wtq_plain, 1), "qht": (qht_plain, 0)}[name]
    if not X.is_cuda or X.dtype == torch.float64:
        return plain(X, W, H, delta)
    p, n, k, W, H, xvec = check_dense_problem(X, W, H, name)
    shape = (k, n) if name == "wtq" else (p, k)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    splits = walk_splits(X.shape[owned_axis], X.shape[1 - owned_axis], k, sms, QT_EDGE)
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
